"""Built-in parallelism techniques (``library.register_default_library``).
The port ships ``dp``, ``fsdp`` and ``offload``; the others are in
``ROADMAP.md``."""

from __future__ import annotations

from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP
from saturn_tpu_torch.parallel.offload import HostOffload

BUILTIN_TECHNIQUES = {
    "dp": DataParallel,
    "fsdp": FSDP,
    "offload": HostOffload,
}
