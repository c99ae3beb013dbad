"""``trace_dir`` and ``compile_cache_dir`` in the port (``utils/trace.py``,
``utils/compile_cache.py``) against the JAX package's semantics
(``saturn_tpu/utils/trace.py``, ``saturn_tpu/utils/profile_cache.py``).

Tracing: ``None`` is a no-op in both packages; an exception from the traced
body propagates out of both; a profiler that fails to start is logged and
the body runs; ``search(trace_dir=)`` and ``orchestrate(trace_dir=)`` each
write one torch.profiler Chrome trace that ``json`` reads. Compile cache:
``search(compile_cache_dir=d)`` puts the native libraries in ``d``; the
environment variable is read once per process, an explicit directory wins;
a second process loads the scheduler's library from ``d`` and starts no
compiler. No numeric tolerances: files, names and counts are exact.
"""

import json
import logging
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu.utils import trace as jtrace
from saturn_tpu_torch import native
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.utils import compile_cache, trace
from saturn_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = SliceTopology([torch.device("cpu")])


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_compile_cache(monkeypatch):
    """The process's compile-cache decision made anew for the test and put
    back after it."""
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    monkeypatch.setattr(compile_cache, "_state", {"decided": False, "dir": None})
    monkeypatch.setattr(native, "_loaded", {})


def _tasks(tmp_path, lrs=(1e-3,), batch_count=4):
    return [sat.Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                     get_dataloader=lambda: make_lm_dataset(
                         context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
                     loss_fn=pretraining_loss, hparams=sat.HParams(lr=lr, batch_count=batch_count),
                     name=f"lr{i}", save_dir=str(tmp_path / "ck"))
            for i, lr in enumerate(lrs)]


def _traces(d):
    return sorted(pathlib.Path(d).glob("*.pt.trace.json"))


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("value", [None, ""])
def test_no_trace_dir_is_a_noop(tmp_path, monkeypatch, pkg, value):
    monkeypatch.chdir(tmp_path)
    mod = trace if pkg == "port" else jtrace
    with mod.profile_trace(value):
        x = 1
    assert x == 1 and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_body_exception_propagates(tmp_path, pkg):
    """The exception leaves the traced region; the port's profiler is
    stopped (its trace written) on the way out, so another can start."""
    mod = trace if pkg == "port" else jtrace
    with pytest.raises(ValueError, match="from the body"):
        with mod.profile_trace(str(tmp_path / "t")):
            raise ValueError("from the body")
    if pkg == "port":
        assert len(_traces(tmp_path / "t")) == 1
        with trace.profile_trace(str(tmp_path / "again")):
            torch.ones(2).sum()
        assert len(_traces(tmp_path / "again")) == 1


def test_start_failure_is_logged_and_the_run_completes(tmp_path, caplog):
    """torch runs one profiler at a time: inside another, tracing fails to
    start, says so, and search and orchestrate run to their end."""
    sat.library.register_default_library()
    tasks = _tasks(tmp_path)
    caplog.set_level(logging.WARNING, logger="saturn_tpu_torch")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sat.search(tasks, technique_names=["dp"], topology=CPU, trace_dir=str(tmp_path / "s"))
        out = sat.orchestrate(tasks, topology=CPU, interval=30.0, trace_dir=str(tmp_path / "o"))
    assert "profiler trace failed to start" in caplog.text
    assert out["completed"] == ["lr0"] and ckpt.saved_step(tasks[0].ckpt_path) == 4
    assert not _traces(tmp_path / "s") and not _traces(tmp_path / "o")


def test_stop_failure_is_logged(tmp_path, monkeypatch, caplog):
    def broken(*args, **kwargs):
        def handler(prof):
            raise OSError("disk full")
        return handler

    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler", broken)
    caplog.set_level(logging.WARNING, logger="saturn_tpu_torch")
    with trace.profile_trace(str(tmp_path / "t")):
        y = torch.ones(3).sum()
    assert float(y) == 3.0 and "profiler trace failed to stop" in caplog.text


def test_search_and_orchestrate_write_traces(tmp_path):
    """Each call writes one Chrome trace holding the training's host
    operators: search's of its trials, orchestrate's of the engine's
    launcher threads, which run its tasks."""
    sat.library.register_default_library()
    tasks = _tasks(tmp_path, lrs=(1e-3, 3e-3))
    sat.search(tasks, technique_names=["dp"], topology=CPU, trace_dir=str(tmp_path / "s"))
    out = sat.orchestrate(tasks, topology=CPU, interval=30.0, trace_dir=str(tmp_path / "o"))
    assert sorted(out["completed"]) == ["lr0", "lr1"]
    (s,), (o,) = _traces(tmp_path / "s"), _traces(tmp_path / "o")
    for path in (s, o):
        events = json.loads(path.read_text())["traceEvents"]
        ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
        assert {"aten::embedding", "aten::mm"} <= ops, path


def test_compile_cache_dir_holds_the_native_builds(tmp_path, fresh_compile_cache, monkeypatch):
    """``search(compile_cache_dir=d)``: the native libraries built after it
    (the word tokenizer's, the scheduler's) go into ``d``; a later
    environment variable does not move the cache, as in JAX, where the
    choice is made once per process."""
    monkeypatch.chdir(tmp_path)  # the word tokenizer's data cache is relative
    d = tmp_path / "cc"
    sat.library.register_default_library()
    tasks = _tasks(tmp_path)
    sat.search(tasks, technique_names=["dp"], topology=CPU, compile_cache_dir=str(d))
    assert compile_cache.enable() == d.resolve()
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "elsewhere"))
    assert compile_cache.enable() == d.resolve()
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog\n" * 20)
    make_lm_dataset(context_length=8, batch_size=2, vocab_size=64, corpus_path=str(corpus),
                    tokenizer="word")
    native.load("spase")
    for name in ("tokenize", "spase"):
        assert native.library_path(name).parent == d.resolve()
        assert native.library_path(name).exists()


def test_environment_decides_once(tmp_path, fresh_compile_cache, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "first"))
    assert compile_cache.build_dir(pathlib.Path("/unused")) == (tmp_path / "first").resolve()
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "second"))
    assert compile_cache.enable() == (tmp_path / "first").resolve()
    assert compile_cache.enable(str(tmp_path / "third")) == (tmp_path / "third").resolve()


def test_unset_cache_keeps_the_package_directories(fresh_compile_cache):
    from saturn_tpu_torch.utils import cuda_build

    assert compile_cache.enable() is None
    assert native.library_path("spase").parent == native.BUILD_DIR
    assert cuda_build.library_path("flash_attn").parent == cuda_build.BUILD_DIR


def test_second_process_loads_the_scheduler_without_a_compiler(tmp_path):
    """Two processes on one ``SATURN_TPU_COMPILE_CACHE_DIR``: the first
    builds ``spase.cpp`` there with ``g++``, the second starts no process."""
    code = (
        "import json, subprocess\n"
        "started = []\n"
        "class Popen(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        started.append(str(args[0]))\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Popen\n"
        "from saturn_tpu_torch import native\n"
        "native.load('spase')\n"
        "print(json.dumps({'started': started, 'path': str(native.library_path('spase'))}))\n"
    )
    env = dict(os.environ, SATURN_TPU_COMPILE_CACHE_DIR=str(tmp_path / "cc"),
               PYTHONPATH=str(ROOT))
    runs = [json.loads(subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                                      check=True, capture_output=True, text=True,
                                      timeout=300).stdout.strip().splitlines()[-1])
            for _ in range(2)]
    assert [os.path.basename(s) for s in runs[0]["started"]] == ["g++"]
    assert runs[1]["started"] == [] and runs[0]["path"] == runs[1]["path"]
    assert pathlib.Path(runs[0]["path"]).parent == (tmp_path / "cc").resolve()
