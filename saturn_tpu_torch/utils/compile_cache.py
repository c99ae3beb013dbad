"""Where the port's compiled code is kept: one directory a run can share with the next.

Counterpart of the JAX package's persistent compilation cache
(``saturn_tpu/utils/profile_cache.py``, ``maybe_enable_persistent_compile_cache``).
The port compiles two kinds of code at first use: the CUDA kernels
(``utils/cuda_build.py``, ``nvcc``) and the native control-plane pieces
(``native/``, ``g++``). Each library is named by a digest of its sources
and flags and written through a temporary file renamed into place, so a
directory of them is a cache that any number of processes can share.
``search(compile_cache_dir=d)`` or ``SATURN_TPU_COMPILE_CACHE_DIR=d`` puts
both kinds in ``d``; a later process pointed at ``d`` loads them without
starting a compiler. Unset, each stays in its package directory
(``csrc/build/``, ``native/_build/``).

As in the JAX package, the environment is read once per process, at the
first build; an explicit directory takes effect at once. CUDA graphs, the
port's other compiled artifact, live in one process and are not cached.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

ENV_DIR = "SATURN_TPU_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_state = {"decided": False, "dir": None}


def enable(path: Optional[str] = None) -> Optional[Path]:
    """The compile cache directory of this process, or None. ``path`` sets
    it (made if missing); with none, the environment decides, once."""
    with _lock:
        if path is not None:
            d = Path(path).resolve()
            d.mkdir(parents=True, exist_ok=True)
            _state.update(decided=True, dir=d)
        elif not _state["decided"]:
            env = os.environ.get(ENV_DIR)
            _state.update(decided=True, dir=Path(env).resolve() if env else None)
        return _state["dir"]


def build_dir(default: Path) -> Path:
    """The directory a library is built into: the compile cache where one
    is set, else ``default``."""
    d = enable()
    return d if d is not None else default
