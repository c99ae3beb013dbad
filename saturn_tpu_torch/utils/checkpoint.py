"""Full train-state checkpoints: ``{params, opt_state, step}``.

Counterpart of ``saturn_tpu/utils/checkpoint.py``. The state holds the model
(``params``, an ``nn.Module``), the optimizer (``opt_state``) and the step
count; a checkpoint holds their ``state_dict``s and the step, written to a
temporary file and renamed over ``task.ckpt_path`` so a reader never sees a
half-written file. That rename is the commit point: a publish hook
(``add_publish_hook``, the durability journal's ``ckpt_published``) is
called after it, and the crash harness's ``pre-manifest-rename`` barrier
(``set_crash_barrier``) is crossed just before it, by the synchronous
``save`` only: a kill raised inside ``save_async``'s writer thread could not
end the process it simulates.

``save_async`` takes the host copy at the call and leaves the disk write to
a thread, one in-flight write per path: every ``load``, ``restore``, second
write, ``exists`` and ``wait`` of that path waits for it first, and a failed
write re-raises there (or at ``flush``), so a checkpoint that never reached
the disk is never reported as saved. A state that already lives in host
memory (offload's) is written with ``snapshot=False``: from its live
tensors, with no second host copy; its owner calls ``wait`` before the
state changes. ``restore`` copies such a state's checkpoint into its
tensors in place, from a memory-mapped file.

A ``torch.save`` file is a zip archive with a CRC32 per member: ``verify``
checks its central directory and every member's CRC without loading a
tensor; ``load`` and ``restore`` move a file they cannot read to a
``.corrupt`` sidecar (``quarantine``) and raise
:class:`CheckpointCorruptError`. The JAX package's sharded manifest format
is a later item; the single-file format has no ``mid-shard-write`` edge.
A multi-device block's state is replicated: its checkpoint is replica 0's,
and ``restore`` fills every replica of the block it restores into, of any
size.
"""

from __future__ import annotations

import logging
import os
import threading
import zipfile
from typing import Any, Callable, Dict, List, Optional

import torch

log = logging.getLogger("saturn_tpu_torch")

_PENDING: Dict[str, threading.Thread] = {}
_FAILED: Dict[str, BaseException] = {}
_PENDING_LOCK = threading.Lock()


def _payload(state: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "params": state["params"].state_dict(),
        "opt_state": state["opt_state"].state_dict(),
        "step": int(state["step"]),
    }


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists on disk and cannot be read back. The file has
    already been moved to a ``.corrupt`` sidecar when this is raised."""

    def __init__(self, path: str, quarantined: str, cause: str):
        self.path = path
        self.quarantined = quarantined
        super().__init__(f"checkpoint {path} is corrupt ({cause}); quarantined to "
                         f"{quarantined}")


def quarantine(path: str) -> str:
    """Rename an unreadable checkpoint to the first free sidecar of
    ``.corrupt``, ``.corrupt.1``, ... and return it (the path itself, the
    file left in place, if the rename fails)."""
    sidecar, n = path + ".corrupt", 0
    while os.path.exists(sidecar):
        n += 1
        sidecar = f"{path}.corrupt.{n}"
    try:
        os.replace(path, sidecar)
    except OSError:
        log.exception("failed to quarantine %s", path)
        return path
    return sidecar


def verify(path: str) -> bool:
    """Whether ``path`` is a sound ``torch.save`` archive: its zip central
    directory parses, it holds a ``data.pkl`` record, and every member's
    CRC32 matches its bytes. Reads the file once and loads no tensor. False
    for a missing, truncated or corrupt file; never raises."""
    try:
        with zipfile.ZipFile(path) as zf:
            if not any(n.endswith("/data.pkl") for n in zf.namelist()):
                return False
            return zf.testzip() is None
    except Exception:
        return False


_CRASH_BARRIER: Optional[Callable[[str, Dict[str, Any]], None]] = None
_PUBLISH_HOOKS: List[Callable[[str, str], None]] = []


def set_crash_barrier(cb: Optional[Callable[[str, Dict[str, Any]], None]]) -> None:
    """Install (``None`` clears) the crash harness's callback, called as
    ``cb("pre-manifest-rename", ctx)`` by ``save`` just before its rename."""
    global _CRASH_BARRIER
    _CRASH_BARRIER = cb


def barrier(point: str, **ctx: Any) -> None:
    """Cross the crash harness's barrier ``point`` (the fused unfuse path's
    ``fused.unfuse``) through the installed callback, if any."""
    cb = _CRASH_BARRIER
    if cb is not None:
        cb(point, ctx)


def add_publish_hook(hook: Callable[[str, str], None]) -> None:
    """Call ``hook(stem, absolute path)`` after every checkpoint lands, from
    the thread that wrote it (the writer thread for ``save_async``). A hook
    must be cheap; one that raises is logged and skipped."""
    _PUBLISH_HOOKS.append(hook)


def remove_publish_hook(hook: Callable[[str, str], None]) -> None:
    try:
        _PUBLISH_HOOKS.remove(hook)
    except ValueError:
        pass


def _notify_published(path: str) -> None:
    stem = os.path.splitext(os.path.basename(path))[0]
    for hook in list(_PUBLISH_HOOKS):
        try:
            hook(stem, os.path.abspath(path))
        except Exception:
            log.exception("checkpoint publish hook failed for %s", path)


def _write(path: str, payload: Dict[str, Any], barrier: bool = False) -> None:
    """Write ``payload`` to a temporary file and rename it over ``path``;
    ``barrier``: cross the crash harness's ``pre-manifest-rename`` first."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        torch.save(payload, tmp)
        cb = _CRASH_BARRIER
        if barrier and cb is not None:
            cb("pre-manifest-rename", {"path": path, "tmp": tmp})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _notify_published(path)


def _to_host(obj):
    """A copy of ``obj`` with every tensor in host memory. A tensor on the
    card is copied into pinned memory on the current stream, without
    waiting; the streams are waited for once, after every copy is queued."""
    streams = {}

    def copy(o):
        if isinstance(o, torch.Tensor):
            if not o.is_cuda:
                return o.detach().clone()
            host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            host.copy_(o.detach(), non_blocking=True)
            streams.setdefault(o.device, torch.cuda.current_stream(o.device))
            return host
        if isinstance(o, dict):
            return {k: copy(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(copy(v) for v in o)
        return o

    out = copy(obj)
    for stream in streams.values():
        stream.synchronize()
    return out


def save(path: str, state: Dict[str, Any]) -> None:
    _wait_pending(path)
    _write(path, _payload(state), barrier=True)


def wait(path: str) -> None:
    """Join the in-flight write of ``path``, if any; re-raise its failure."""
    _wait_pending(path)


def _wait_pending(path: str) -> None:
    """Join the in-flight write of ``path``; re-raise its failure."""
    key = os.path.abspath(path)
    with _PENDING_LOCK:
        t = _PENDING.get(key)
    if t is not None:
        t.join()
    with _PENDING_LOCK:
        err = _FAILED.pop(key, None)
    if err is not None:
        raise RuntimeError(f"async checkpoint write to {path} failed") from err


def save_async(path: str, state: Dict[str, Any], snapshot: bool = True) -> None:
    """``save`` with the disk write off the caller's path: the host copy of
    the state is taken here (the caller goes on updating the state in place),
    ``torch.save`` and the atomic rename run on a thread. ``snapshot=False``
    writes the state's own tensors, which must be in host memory and must
    not change before ``wait(path)`` returns."""
    _wait_pending(path)  # at most one in-flight write per path
    payload = _payload(state)
    if snapshot:
        snap = _to_host(payload)
    else:
        for t in payload["params"].values():
            if t.device.type != "cpu":
                raise ValueError(f"save_async({path!r}, snapshot=False) needs a state in "
                                 f"host memory; a parameter is on {t.device}")
        snap = payload
    key = os.path.abspath(path)

    def write():
        try:
            _write(path, snap)
        except BaseException as e:  # re-raised at the next join point
            log.exception("async checkpoint write to %s failed", path)
            with _PENDING_LOCK:
                _FAILED.setdefault(key, e)
        finally:
            with _PENDING_LOCK:
                if _PENDING.get(key) is threading.current_thread():
                    del _PENDING[key]

    t = threading.Thread(target=write, name=f"ckpt-{os.path.basename(path)}",
                         daemon=True)
    with _PENDING_LOCK:
        _PENDING[key] = t
    t.start()


def flush() -> None:
    """Join every outstanding write; re-raise the first failure."""
    with _PENDING_LOCK:
        threads = list(_PENDING.values())
    for t in threads:
        t.join()
    with _PENDING_LOCK:
        errs = dict(_FAILED)
        _FAILED.clear()
    for path, err in errs.items():
        raise RuntimeError(f"async checkpoint write to {path} failed") from err


def exists(path: str) -> bool:
    _wait_pending(path)
    return os.path.exists(path)


def load(path: str, map_location="cpu", mmap: bool = False) -> Dict[str, Any]:
    """The saved payload: ``{"params": state_dict, "opt_state":
    optimizer state_dict, "step": int}``, its tensors memory-mapped from the
    file with ``mmap``. A missing file raises ``FileNotFoundError``; one
    that ``torch.load`` cannot read is quarantined and raises
    :class:`CheckpointCorruptError` (a bit flip in a tensor's bytes passes
    ``torch.load``: ``verify`` finds it)."""
    _wait_pending(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    try:
        return torch.load(path, map_location=map_location, weights_only=True, mmap=mmap)
    except Exception as e:
        sidecar = quarantine(path)
        log.warning("checkpoint %s unreadable (%r); quarantined to %s", path, e, sidecar)
        raise CheckpointCorruptError(path, sidecar, repr(e)) from e


def saved_step(path: str) -> int:
    """The step count of a checkpoint, its tensors memory-mapped and left
    unread."""
    _wait_pending(path)
    return int(torch.load(path, map_location="cpu", weights_only=True, mmap=True)["step"])


def _in_place(opt) -> bool:
    """Whether every parameter of ``opt`` already has its state tensors (a
    host-resident state allocates them up front, in pinned memory)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return bool(params) and all(opt.state.get(p) for p in params)


def restore(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint into ``state`` (in place) and return it. A
    checkpoint restores under any technique whose state has the same
    parameters: the optimizer keeps its own settings (capturable on the
    card, fused on the host), only its state is read.

    Where the optimizer already holds its state tensors (a host-resident
    state), the file is memory-mapped and every tensor is copied into the
    state's own, so no second host copy of the state is made. Otherwise
    the payload is read to the host and ``load_state_dict`` copies the
    weights and moments to their parameters' device, placing each
    optimizer's step counts as that optimizer keeps them: a capturable one
    (every named optimizer of a task on the card, ``HParams.make_optimizer``)
    on the card, where a CUDA graph's optimizer step reads and advances
    them; any other on the host. The optimizer's state tensors are then new
    tensors, so a CUDA graph captured on ``state`` before this call is stale
    (``parallel/spmd_base.py`` captures again).

    A state of several replicas (``state["replicas"]``, a multi-device
    block's; its checkpoint holds replica 0) gets the same payload in every
    replica, so they leave bitwise equal whatever block size wrote it."""
    in_place = _in_place(state["opt_state"])
    saved = load(path, mmap=in_place)
    for r, rep in enumerate(state.get("replicas") or [state]):
        if r and not next(rep["params"].parameters()).is_cuda:
            # ``load_state_dict`` keeps a host tensor it need not move: a
            # second host replica takes copies, not replica 0's moments
            saved = dict(saved, opt_state=_clone_tensors(saved["opt_state"]))
        _restore_replica(rep["params"], rep["opt_state"], saved, in_place)
    state["step"] = int(saved["step"])
    return state


def _clone_tensors(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone_tensors(v) for v in obj)
    return obj


def _restore_replica(model, opt, saved: Dict[str, Any], in_place: bool) -> None:
    model.load_state_dict(saved["params"])
    if in_place:
        params = [p for g in opt.param_groups for p in g["params"]]
        with torch.no_grad():
            for i, per_param in saved["opt_state"]["state"].items():
                own = opt.state[params[int(i)]]
                for k, v in per_param.items():
                    if isinstance(v, torch.Tensor):
                        own[k].copy_(v)
                    else:
                        own[k] = v
    else:
        sd = saved["opt_state"]
        keep = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
        sd = dict(sd, param_groups=[dict(g, **own) for g, own in zip(sd["param_groups"], keep)])
        opt.load_state_dict(sd)
