"""Built-in parallelism techniques (``library.register_default_library``).
This slice ships ``dp``; the others are in ``ROADMAP.md``."""

from __future__ import annotations

from saturn_tpu_torch.parallel.dp import DataParallel

BUILTIN_TECHNIQUES = {
    "dp": DataParallel,
}
