"""Built-in parallelism techniques (``library.register_default_library``).
The port ships ``dp``, ``fsdp``, ``tp`` and ``offload``; the others are
in ``ROADMAP.md``."""

from __future__ import annotations

from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP
from saturn_tpu_torch.parallel.offload import HostOffload
from saturn_tpu_torch.parallel.tp import TensorParallel

BUILTIN_TECHNIQUES = {
    "dp": DataParallel,
    "fsdp": FSDP,
    "tp": TensorParallel,
    "offload": HostOffload,
}
