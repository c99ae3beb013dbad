"""The port's kernel build (``saturn_tpu_torch/utils/cuda_build.py``) on the
CPU: which library a source maps to. Needs no ``nvcc``."""

import shutil

import pytest

from saturn_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_build, "CSRC", copy)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", copy / "build")
    return copy


@pytest.mark.parametrize("name", ["flash_attn", "linear_ce"])
def test_library_path_covers_the_headers(csrc, name):
    """An edit to a shared header or to the source names another library,
    so a stale build is never loaded; an unchanged tree names the same one."""
    first = cuda_build.library_path(name)
    assert first.parent == csrc / "build" and first.name.startswith(f"lib{name}-")
    assert cuda_build.library_path(name) == first
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = cuda_build.library_path(name)
    assert after_header != first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after_new_header = cuda_build.library_path(name)
    assert after_new_header not in (first, after_header)
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path(name) not in (first, after_header, after_new_header)
