"""Compile-ahead: build a job's compiled code off its first dispatch.

Counterpart of ``saturn_tpu/tenancy/compile_ahead.py``. The JAX pool
compiles an admitted job's XLA program in the background, so that its
first dispatch finds the executable warm. The port compiles no program per
job: what it compiles are the CUDA kernels (``utils/cuda_build.py``,
``nvcc``) and the native control-plane libraries (``native/``, ``g++``),
digest-named and kept where ``compile_cache_dir`` says. So here
"compile" is such a build and its load into the process
(:meth:`CompileAheadPool.prewarm_build`, keyed by the library's digest
name): a later ``load`` on the dispatch path finds the library loaded, and
the dispatch path does not change. CUDA graphs are captured per process
and cannot be built ahead of the first interval, and a job's fresh init is
not a compile (``ROADMAP.md`` queue 3).

Every step of a key journals a ``compile_ahead`` record (``requested`` /
``ready`` / ``error`` / ``hit`` / ``miss``), the records the service's
recovery fold counts, so the hit and miss ledger survives in the durable
record.

A thunk is arbitrary code to the pool: it runs outside the pool's lock,
and its exception is a ledger entry, not a crash of the pool.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["CompileAheadPool", "build_thunks"]


def build_thunks(names: Sequence[str]) -> List[Tuple[str, Callable[[], Any]]]:
    """``(key, thunk)`` pairs that build and load each named library: a
    CUDA source ``csrc/<name>.cu`` (``cuda_build.load``) or a native source
    ``native/<name>.cpp`` (``native.load``). The key is the library's file
    name, which carries the digest of its sources and flags. An unknown
    name raises ``KeyError``."""
    from saturn_tpu_torch import native
    from saturn_tpu_torch.utils import cuda_build

    pairs = []
    for name in names:
        if (cuda_build.CSRC / f"{name}.cu").exists():
            mod = cuda_build
        elif (Path(native.SRC_DIR) / f"{name}.cpp").exists():
            mod = native
        else:
            raise KeyError(f"no CUDA or native source named {name!r}")
        pairs.append((mod.library_path(name).name, lambda mod=mod, name=name: mod.load(name)))
    return pairs


class CompileAheadPool:
    """Background build workers and the hit / miss ledger.

    Keys are the caller's strings; :meth:`prewarm_build` keys a build by
    its library's digest name."""

    def __init__(self, *, workers: int = 2, journal: Any = None) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: deque = deque()   # (key, thunk, job, tenant)
        self._inflight: set = set()      # keys queued or building
        self._ready: Dict[str, Any] = {}
        self._errors: Dict[str, str] = {}
        self._counts: Dict[str, int] = {
            "requested": 0, "ready": 0, "errors": 0,
            "ahead_hits": 0, "ahead_misses": 0, "duplicates": 0,
        }
        self._closed = False
        self._workers = max(1, int(workers))
        self._threads: list = []
        #: the durable journal of the ``compile_ahead`` records (the service
        #: wires its own where this is None)
        self.journal = journal

    # -- producer side --------------------------------------------------

    def prewarm(self, key: str, thunk: Callable[[], Any], *, job: Optional[str] = None,
                tenant: Optional[str] = None) -> bool:
        """Queue ``thunk`` to build ``key`` in the background. False (and a
        duplicate counted) when ``key`` is already ready, in flight or
        failed: a requeued job's re-admission builds nothing again."""
        with self._lock:
            if self._closed:
                return False
            if key in self._ready or key in self._inflight or key in self._errors:
                self._counts["duplicates"] += 1
                return False
            self._inflight.add(key)
            self._counts["requested"] += 1
            self._pending.append((key, thunk, job, tenant))
            self._spawn_locked()
            self._cond.notify()
        self._journal_event("requested", key, job=job, tenant=tenant)
        return True

    def prewarm_build(self, names: Sequence[str], *, job: Optional[str] = None,
                      tenant: Optional[str] = None) -> List[str]:
        """Prewarm the builds of the named libraries (:func:`build_thunks`);
        returns their keys, for :meth:`acquire`."""
        keys = []
        for key, thunk in build_thunks(names):
            self.prewarm(key, thunk, job=job, tenant=tenant)
            keys.append(key)
        return keys

    # -- consumer side --------------------------------------------------

    def acquire(self, key: str, timeout: float = 0.0) -> Optional[Any]:
        """What the build of ``key`` produced, if the pool got there first:
        a hit (counted ``ahead_hits``). None on a miss (never requested,
        failed, or not ready within ``timeout``); the caller builds as
        before."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._lock:
            while True:
                if key in self._ready:
                    self._counts["ahead_hits"] += 1
                    result, hit = self._ready[key], True
                    break
                waitable = key in self._inflight and not self._closed
                remaining = deadline - time.monotonic()
                if not waitable or remaining <= 0.0:
                    self._counts["ahead_misses"] += 1
                    result, hit = None, False
                    break
                self._cond.wait(timeout=min(remaining, 0.5))
        self._journal_event("hit" if hit else "miss", key)
        return result

    def error(self, key: str) -> Optional[str]:
        with self._lock:
            return self._errors.get(key)

    def ledger(self) -> Dict[str, Any]:
        """The counts and the hit rate (None until anything was acquired)."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
            out["pending"] = len(self._pending)
            out["inflight"] = len(self._inflight)
        asked = out["ahead_hits"] + out["ahead_misses"]
        out["hit_rate"] = (out["ahead_hits"] / asked) if asked else None
        return out

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued build finished."""
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        with self._lock:
            while self._pending or self._inflight:
                remaining = 0.5 if deadline is None else deadline - time.monotonic()
                if remaining <= 0.0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.5))
        return True

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=timeout)

    # -- workers --------------------------------------------------------

    def _spawn_locked(self) -> None:
        # under the lock: grow the workers up to the cap as work comes, so
        # an idle service carries no build thread
        while (len(self._threads) < self._workers
               and len(self._threads) < len(self._pending) + len(self._inflight)):
            t = threading.Thread(target=self._worker,
                                 name=f"compile-ahead-{len(self._threads)}", daemon=True)
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._cond.wait(timeout=0.5)
                if self._closed and not self._pending:
                    return
                key, thunk, job, tenant = self._pending.popleft()
            try:
                result = thunk()
                err = None
            except Exception as e:  # a thunk's failure is a ledger entry
                result, err = None, f"{type(e).__name__}: {e}"
            with self._lock:
                self._inflight.discard(key)
                if err is None:
                    self._ready[key] = result
                    self._counts["ready"] += 1
                else:
                    self._errors[key] = err
                    self._counts["errors"] += 1
                self._cond.notify_all()
            if err is None:
                self._journal_event("ready", key, job=job, tenant=tenant)
            else:
                self._journal_event("error", key, job=job, tenant=tenant, error=err)

    def _journal_event(self, status: str, key: str, **extra: Any) -> None:
        jnl = self.journal
        if jnl is None:
            return
        try:
            jnl.append("compile_ahead", status=status, key=key,
                       **{k: v for k, v in extra.items() if v is not None})
        except Exception:
            pass  # a closed or rotating journal must not break a build
