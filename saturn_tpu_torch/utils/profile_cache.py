"""Persistent profile cache: trial results that outlive the process that ran them.

Counterpart of ``saturn_tpu/utils/profile_cache.py``, with its file format:
one JSON file per key, written through an atomic ``os.replace``, and a
corrupt, stale or foreign file reads as a miss, never an error. A trial's
outcome (params and seconds per batch, or infeasible) is keyed on a
fingerprint of what the time depends on, so a repeated ``search()`` over
an unchanged task list runs no trial, and tasks that differ only in what
does not change the program (lr, batch count, name) share one entry. The
orchestrator upgrades an entry with the realized per-batch time once its
task has run (``note_realized``).

The key is the port's own (``fingerprint``):

- the task's signature (``task_signature``): the model's config and its
  meta-device tensors (name, shape, dtype), the batch shape, the optimizer,
  the model kwargs and hints, and the loss function — its
  ``supports_fused_head`` tag and qualified name. A tagged loss trains
  through the fused head and an untagged one over the logits, two programs
  with different times; the JAX key leaves the loss out;
- the technique and the block size;
- the topology, with the device kind (the card's name, or ``cpu``) and,
  where positions share a device, the count of distinct devices;
- the ``torch`` and CUDA versions and the window ceiling ``max_window()``;
- a hash of the kernel sources under ``csrc/``: a kernel redesign changes
  the time per batch.

Environment (the JAX package's names):

- ``SATURN_TPU_PROFILE_CACHE_DIR``: cache directory (default
  ``~/.cache/saturn_tpu_torch/profiles``, apart from the JAX package's).
- ``SATURN_TPU_PROFILE_CACHE=0``: disable the default cache entirely.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

log = logging.getLogger("saturn_tpu_torch")

#: Bump when the fingerprint payload or entry schema changes meaning —
#: old entries then miss instead of being misread. 2: entries carry the
#: trial's ``host_fraction`` (an entry of 1 would load it as 0.0).
SCHEMA_VERSION = 2

_ENV_DIR = "SATURN_TPU_PROFILE_CACHE_DIR"
_ENV_TOGGLE = "SATURN_TPU_PROFILE_CACHE"

_FALSEY = ("0", "false", "off", "no")

CSRC = Path(__file__).resolve().parents[1] / "csrc"


# --------------------------------------------------------------- fingerprints
def _model_signature(task: Any) -> str:
    """The model's config and its meta-device parameters and buffers (name,
    shape, dtype): no weights are made."""
    spec = task.get_model()
    parts = [repr(getattr(spec, "config", type(spec).__name__))]
    module = spec.abstract_init()
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        parts.append(f"{name}:{tuple(t.shape)}:{t.dtype}")
    return ";".join(parts)


def _data_signature(task: Any) -> str:
    """Batch shape, dtype and size: what drives the step time (token values
    do not)."""
    ds = task.get_dataset()
    parts = [type(ds).__name__, str(getattr(ds, "batch_size", None))]
    eb = getattr(ds, "example_batch", None)
    if callable(eb):
        b = eb()
        parts += [str(tuple(getattr(b, "shape", ()))), str(getattr(b, "dtype", ""))]
    return ";".join(parts)


def _qualname(fn: Any) -> str:
    """A stable handle of a callable across processes (a repr would embed a
    memory address)."""
    return f"{getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', type(fn).__name__)}"


def _optimizer_signature(task: Any) -> str:
    opt = getattr(getattr(task, "hparams", None), "optimizer", None)
    if isinstance(opt, str) or opt is None:
        return str(opt)
    return f"custom:{_qualname(opt)}"


def loss_signature(task: Any) -> str:
    """The loss function: its ``supports_fused_head`` tag (which decides
    between the fused head and the logits path) and its qualified name."""
    fn = task.loss_fn
    return json.dumps({"fused_head": getattr(fn, "supports_fused_head", None),
                       "fn": _qualname(fn)}, sort_keys=True)


def task_signature(task: Any) -> str:
    """Everything about a task that its per-batch time depends on. Leaves
    out lr, the batch count and the name, and the scheduling-only hints
    ``priority`` and ``deadline`` (the JAX package's rule)."""
    hp = getattr(task, "hparams", None)
    hints = {k: v for k, v in dict(getattr(task, "hints", {}) or {}).items()
             if k not in ("priority", "deadline")}
    return json.dumps(
        {
            "model": _model_signature(task),
            "data": _data_signature(task),
            "optimizer": _optimizer_signature(task),
            "kwargs": dict(getattr(hp, "kwargs", {}) or {}),
            "hints": hints,
            "loss": loss_signature(task),
        },
        sort_keys=True,
        default=repr,
    )


def _device_kind(device: Any) -> str:
    import torch

    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(getattr(device, "type", device))


def topology_signature(topo: Any) -> str:
    """The pool: its device kinds and count, and the buddy capacity; and,
    where positions share a device (a rehearsal such as ``[cuda:0,
    cuda:0]``), how many distinct devices they name, so that a rehearsal's
    timings are never served to a pool of as many real cards."""
    from saturn_tpu_torch.core.mesh import physical_groups

    kinds = sorted({_device_kind(d) for d in topo.devices})
    sig = f"{'+'.join(kinds)}x{len(topo.devices)}:cap{topo.capacity}"
    distinct = len(physical_groups(topo.devices))
    return sig if distinct == len(topo.devices) else f"{sig}:distinct{distinct}"


def kernel_sources_digest() -> str:
    """A hash of every file under ``csrc/`` (names and bytes)."""
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file() and "build" not in p.parts):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def runtime_signature() -> Dict[str, Any]:
    """The software the time depends on: torch and CUDA versions, the
    window ceiling, the kernel sources and the overlapped programs' version
    (``ops/collective_matmul.overlap_signature``: a serial profile must
    never price an overlapped program)."""
    import torch

    from saturn_tpu_torch.ops.collective_matmul import overlap_signature
    from saturn_tpu_torch.parallel.spmd_base import max_window

    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "max_window": max_window(),
        "kernels": kernel_sources_digest(),
        "overlap": overlap_signature(),
    }


def fingerprint(task_sig: str, technique: str, size: int, topo_sig: str,
                runtime: Optional[Dict[str, Any]] = None) -> str:
    """Cache key of one (task, technique, block size) grid point
    (``runtime_signature()`` when ``runtime`` is None)."""
    payload = json.dumps(
        {
            "schema": SCHEMA_VERSION,
            "task": task_sig,
            "technique": technique,
            "size": int(size),
            "topology": topo_sig,
            "runtime": runtime_signature() if runtime is None else runtime,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


# --------------------------------------------------------------------- store
class ProfileCache:
    """Directory of one-JSON-file-per-key trial outcomes."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def get(self, key: Optional[str]) -> Optional[Dict[str, Any]]:
        """Validated entry dict, or None for missing/corrupt/foreign files."""
        if not key:
            return None
        try:
            with open(self._path(key)) as f:
                e = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(e, dict) or e.get("key") != key:
            return None  # stale schema or hash collision artifact: miss
        if not isinstance(e.get("feasible"), bool):
            return None
        if e["feasible"]:
            pbt = e.get("per_batch_time")
            if not isinstance(pbt, (int, float)) or pbt <= 0.0:
                return None
            if not isinstance(e.get("params"), dict):
                return None
        return e

    def put(
        self,
        key: Optional[str],
        *,
        technique: str,
        size: int,
        feasible: bool,
        params: Optional[Dict[str, Any]] = None,
        per_batch_time: Optional[float] = None,
        source: str = "trial",
        memory_infeasible: bool = False,
        host_fraction: float = 0.0,
        peak_bytes: Optional[float] = None,
    ) -> bool:
        """Atomically write one entry; False if the key or params are not
        cacheable (non-JSON params of a plugin technique). ``host_fraction``
        is the trial's staging-against-compute split, which the solver's
        co-location term reads (the JAX package's field); ``peak_bytes`` the
        trial's peak device memory, which the fusion gate reads (the
        port's)."""
        if not key:
            return False
        entry = {
            "key": key,
            "schema": SCHEMA_VERSION,
            "technique": technique,
            "size": int(size),
            "feasible": bool(feasible),
            "params": params,
            "per_batch_time": per_batch_time,
            "source": source,
            "memory_infeasible": bool(memory_infeasible),
            "host_fraction": float(host_fraction),
            "peak_bytes": None if peak_bytes is None else float(peak_bytes),
            "written": time.time(),
        }
        try:
            blob = json.dumps(entry)
        except (TypeError, ValueError):
            return False
        tmp = self._path(key) + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True

    def note_realized(self, key: Optional[str], per_batch_time: float,
                      params: Optional[Dict[str, Any]], technique: str,
                      size: int) -> bool:
        """Upgrade (or create) an entry from a realized interval: it averages
        a whole interval of production batches, which is what the next sweep
        should predict. The entry keeps the trial's ``host_fraction`` and
        ``peak_bytes``."""
        if not key or per_batch_time <= 0.0:
            return False
        prev = self.get(key)
        if prev is not None and prev.get("feasible") and params is None:
            params = prev.get("params")
        return self.put(
            key, technique=technique, size=size, feasible=True,
            params=params if isinstance(params, dict) else {},
            per_batch_time=float(per_batch_time), source="realized",
            host_fraction=float((prev or {}).get("host_fraction", 0.0) or 0.0),
            peak_bytes=(prev or {}).get("peak_bytes"),
        )

    def __len__(self) -> int:
        try:
            return sum(1 for fn in os.listdir(self.root) if fn.endswith(".json"))
        except OSError:
            return 0


# ------------------------------------------------------------- default cache
_DEFAULT: Optional[ProfileCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_dir() -> str:
    return os.environ.get(
        _ENV_DIR,
        os.path.join(os.path.expanduser("~"), ".cache", "saturn_tpu_torch", "profiles"),
    )


def default_cache() -> Optional[ProfileCache]:
    """Process-wide cache honoring the environment; None when disabled."""
    if os.environ.get(_ENV_TOGGLE, "1").lower() in _FALSEY:
        return None
    global _DEFAULT
    with _DEFAULT_LOCK:
        d = default_dir()
        if _DEFAULT is None or _DEFAULT.root != d:
            try:
                _DEFAULT = ProfileCache(d)
            except OSError:
                log.warning("profile cache dir %s not writable — caching off", d)
                return None
        return _DEFAULT


def resolve(spec: Any = None) -> Optional[ProfileCache]:
    """Map a ``search(profile_cache=...)`` argument to a cache: ``None`` ->
    the environment's default (on unless disabled); ``False`` -> off for
    this sweep; a path -> that directory; a ``ProfileCache`` -> itself."""
    if spec is None:
        return default_cache()
    if spec is False:
        return None
    if isinstance(spec, ProfileCache):
        return spec
    if isinstance(spec, (str, os.PathLike)):
        try:
            return ProfileCache(os.fspath(spec))
        except OSError:
            log.warning("profile cache dir %s not writable — caching off", spec)
            return None
    raise TypeError(
        f"profile_cache must be None, False, a directory path or a "
        f"ProfileCache, got {type(spec).__name__}"
    )
