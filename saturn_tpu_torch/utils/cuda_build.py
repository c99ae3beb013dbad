"""Build the port's hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` holds kernels with plain ``extern "C"`` launchers. It is
compiled by ``nvcc`` into ``csrc/build/lib<name>-<digest>.so`` (the digest
covers the source, every ``csrc/*.cuh`` header and the flags, so an edited
source or header never loads a stale library) and loaded with ``ctypes``.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then the toolkit's default prefix. Raises when there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from saturn_tpu_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a digest of
    the source, every header in ``csrc`` and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The ``nvcc`` output of the last build of ``csrc/<name>.cu`` (ptxas:
    registers, spills and shared memory per kernel); empty if none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns (library path, temporary path, process) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, tmp, proc


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries for ``csrc/<name>.cu`` of each name. Sources with
    no library of their current text are compiled first, one ``nvcc`` each,
    all at once; every compiler is waited for before any failure raises."""
    with _lock:
        builds = {n: _start_build(n) for n in names if n not in _loaded}
        failed = []
        for name, build in builds.items():
            if build is None:
                continue
            out, tmp, proc = build
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in builds:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled first if no
    library of the current source exists. Raises if ``nvcc`` fails."""
    return load_all([name])[name]
