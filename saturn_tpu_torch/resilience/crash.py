"""Kill-replay crash harness: deterministic simulated SIGKILLs at durability
barriers.

Counterpart of ``saturn_tpu/resilience/crash.py``. A SIGKILL gives the
process no chance to flush buffers, run handlers or close files; the
simulation keeps that contract:

- :class:`SimulatedKill` is a ``BaseException``, so no ``except Exception``
  clean-up catches it, and ``orchestrate`` treats it as the process's death
  (no checkpoint flush, no journal commit or close);
- the kill fires at a named barrier: the journal's ``pre-commit``,
  ``mid-fsync`` (the injector tears the tail of the write it interrupts, as
  a lost page cache would, so recovery meets a real torn record),
  ``post-commit``, ``pre-rotate`` and ``post-rename``; the orchestrator's
  ``mid-interval`` (the interval ran, its progress is not durable) and
  ``post-rollback`` (a faulted task was rolled back, its quarantine record
  is durable); the checkpoint writer's ``mid-shard-write`` (the shard
  file is staged, its rename not done) and ``pre-manifest-rename`` (the
  shards are durable, the manifest rename that publishes them is not
  done), crossed by the synchronous ``checkpoint.save`` only; a kill at
  either leaves the previous generation the published one; the fused
  stack's ``fused.unfuse``
  (``parallel/fused.py``: a member is sliced out, its checkpoint not yet
  written), through ``checkpoint.set_crash_barrier``; the online service's
  defragmentation waves' ``defrag.pre-publish`` (the move's intent is
  durable, the victim's checkpoint not yet re-journaled),
  ``defrag.pre-commit`` (the victim's live state released, its
  ``migration_done`` not yet committed) and ``defrag.post-commit``
  (``resilience/grow.py``);
- ``CrashInjector("mid-fsync", hit=2)`` fires on exactly the second armed
  crossing of that barrier; :meth:`CrashInjector.seeded` draws the point
  and hit from a seed.

``KILL_POINTS`` keeps the JAX package's names.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Sequence

logger = logging.getLogger("saturn_tpu_torch")

KILL_POINTS = (
    "pre-commit",
    "mid-fsync",
    "post-commit",
    "pre-rotate",
    "post-rename",
    "mid-interval",
    "post-checkpoint",
    "post-rollback",
    "mid-shard-write",
    "pre-manifest-rename",
    "fused.unfuse",
    "defrag.pre-publish",
    "defrag.pre-commit",
    "defrag.post-commit",
)


class SimulatedKill(BaseException):
    """The process 'died' at a durability barrier. A ``BaseException``: a
    SIGKILL runs no handlers, so no ``except Exception`` may catch it."""


class CrashInjector:
    """Raises one :class:`SimulatedKill` at the ``hit``-th armed crossing of
    barrier ``point``. Pass :meth:`barrier` as the journal's callback
    (``orchestrate(crash_barrier=inj.barrier)``). ``armed=False`` lets a
    test set up through the same barriers before the kill window opens.
    After it fires the injector is inert: the threads of the dead process
    that are still unwinding pass through."""

    def __init__(self, point: str, hit: int = 1, armed: bool = True, tear_bytes: int = 7):
        if point not in KILL_POINTS:
            raise ValueError(f"unknown kill-point {point!r}; use one of {KILL_POINTS}")
        if hit < 1:
            raise ValueError("hit is 1-based")
        self.point = point
        self.hit = hit
        self.tear_bytes = tear_bytes
        self.fired = threading.Event()
        self._armed = threading.Event()
        if armed:
            self._armed.set()
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    @classmethod
    def seeded(cls, seed: int, max_hit: int = 3, points: Sequence[str] = KILL_POINTS,
               **kw) -> "CrashInjector":
        """The (point, hit) drawn from ``seed``: the same kill every run."""
        rng = random.Random(seed)
        return cls(rng.choice(list(points)), hit=rng.randint(1, max_hit), **kw)

    def arm(self) -> None:
        self._armed.set()

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def barrier(self, point: str, ctx: Dict) -> None:
        """The barrier callback: count armed crossings and, on the chosen
        one, tear the write in flight (at ``mid-fsync``) and raise."""
        if self.fired.is_set() or not self._armed.is_set():
            return
        with self._lock:
            if self.fired.is_set():
                return
            self._counts[point] = self._counts.get(point, 0) + 1
            if point != self.point or self._counts[point] != self.hit:
                return
            if point == "mid-fsync":
                self._tear(ctx)
            self.fired.set()
        logger.warning("crash harness: simulated SIGKILL at %s (hit %d)", point, self.hit)
        raise SimulatedKill(f"simulated SIGKILL at {point} (hit {self.hit})")

    def _tear(self, ctx: Dict) -> None:
        """Truncate the bytes just written ``tear_bytes`` short of their end,
        inside the last record: a torn trailing line for recovery."""
        path, start, end = ctx.get("path"), ctx.get("start"), ctx.get("end")
        if not path or start is None or end is None:
            return
        cut = max(start, end - self.tear_bytes)
        if cut >= end:  # nothing to tear inside: the whole write vanishes
            cut = start
        os.truncate(path, cut)


def run_to_kill(injector: CrashInjector, service, timeout: float = 60.0) -> None:
    """Arm the injector, wait for the kill and join the dead service's loop
    thread (``service._thread``, where it has one). Raises ``TimeoutError``
    if the kill never fires: the harness was set up wrong."""
    injector.arm()
    if not injector.fired.wait(timeout):
        raise TimeoutError(f"kill at {injector.point!r} (hit {injector.hit}) never fired "
                           f"within {timeout}s; crossings so far: {injector.counts()}")
    thread = getattr(service, "_thread", None)
    if thread is not None:
        thread.join(timeout)
        if thread.is_alive():
            raise TimeoutError("service loop thread outlived its kill")
