"""Native (C++) pieces of the control plane, built at first use, ctypes-bound.

Counterpart of ``saturn_tpu/native/__init__.py``, for copies of the JAX
package's ``spase.cpp`` (the SPASE list scheduler with local search) and
``tokenize.cpp`` (the corpus word tokenizer). A source is compiled with
``g++ -O2 -std=c++17 -shared -fPIC`` into ``_build/lib<name>-<digest>.so``,
or into the compile cache directory where one is set
(``utils/compile_cache.py``); the digest covers the source and the flags,
so an edited source never loads a stale library. It is loaded with
``ctypes``. A failed build or load raises: no Python stand-in takes the
place of a native piece, so a broken build never hides behind a worse plan.
Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

from saturn_tpu_torch.utils import compile_cache

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the library of ``<name>.cpp`` lives: named by a digest of the
    source and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return compile_cache.build_dir(BUILD_DIR) / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless its library exists; returns its path.
    The library is written under a temporary name and renamed into place,
    so processes that build at once never load a half-written file. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build of {name}.cpp could not run g++: {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build of {name}.cpp failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and ``dlopen`` ``lib<name>``; raises when either fails."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
