"""Full train-state checkpoints: ``{params, opt_state, step}``.

Counterpart of ``saturn_tpu/utils/checkpoint.py``. The state holds the model
(``params``, an ``nn.Module``), the optimizer (``opt_state``) and the step
count; a checkpoint holds their ``state_dict``s and the step, written to a
temporary file and renamed over ``task.ckpt_path`` so a reader never sees a
half-written file.

``save_async`` takes the host copy at the call and leaves the disk write to
a thread, one in-flight write per path: every ``load``, ``restore``, second
write and ``exists`` of that path waits for it first, and a failed write
re-raises there (or at ``flush``), so a checkpoint that never reached the
disk is never reported as saved. The JAX package's sharded manifest format
and publish hooks are later items.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict

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


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


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
    _write(path, _payload(state))


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


def save_async(path: str, state: Dict[str, Any]) -> None:
    """``save`` with the disk write off the caller's path: the host copy of
    the state is taken here (the caller goes on updating the state in place),
    ``torch.save`` and the atomic rename run on a thread."""
    _wait_pending(path)  # at most one in-flight write per path
    snap = _to_host(_payload(state))
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


def load(path: str, map_location="cpu") -> Dict[str, Any]:
    """The saved payload: ``{"params": state_dict, "opt_state":
    optimizer state_dict, "step": int}``."""
    _wait_pending(path)
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint into ``state`` (in place) and return it.

    The payload is read to the host; ``load_state_dict`` copies the weights
    and moments to their parameters' device. It also places each
    optimizer's step counts as that optimizer keeps them: a capturable one
    (every named optimizer of a task on the card, ``HParams.make_optimizer``)
    on the card, where a CUDA graph's optimizer step reads and advances
    them; any other on the host. The optimizer's state tensors are new
    tensors, so a CUDA graph captured on ``state`` before this call is stale
    (``parallel/spmd_base.py`` captures again)."""
    saved = load(path)
    state["params"].load_state_dict(saved["params"])
    state["opt_state"].load_state_dict(saved["opt_state"])
    state["step"] = int(saved["step"])
    return state
