"""The port's sweep driver (``saturn_tpu_torch/examples/lm_sweep.py``)
against the JAX package's (``examples/lm_sweep/driver.py``), and the check
of ``examples/lm_sweep/verify.py`` ported to it: register, tasks limited to
given block sizes, ``search``, ``orchestrate``, and every job finished at
its batch count. On the CPU (``--platform cpu``, one device) at
``test-tiny``, on the bundled corpus through the native word tokenizer. No
tolerances: flags, step counts and strategies are compared exactly.
"""

import copy
import importlib.util
import pathlib
import sys

import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.examples import lm_sweep
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_lm_sweep_driver", ROOT / "examples" / "lm_sweep" / "driver.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "gpt2-small", "--lrs", "1e-4", "3e-4", "--batch-sizes", "8", "16"],
    ["--corpus", "synthetic", "--tokenizer", "byte", "--chip-range", "1", "2",
     "--techniques", "dp", "--interval", "5", "--batch-count", "3", "--context-length", "32",
     "--save-dir", "x", "--platform", "cpu"],
])
def test_flags_match_the_jax_driver(monkeypatch, argv):
    """The same flags, parsed to the same values; the default corpus is the
    same bundled file."""
    monkeypatch.setattr(sys, "argv", ["driver.py", *argv])
    want = vars(_jax_driver().parse_args())
    got = vars(lm_sweep.parse_args(argv))
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "corpus" and "--corpus" not in argv:
            assert pathlib.Path(got[k]).resolve() == pathlib.Path(want[k]).resolve()
            assert pathlib.Path(got[k]).resolve() == ROOT / "examples" / "data" / "corpus.txt"
        else:
            assert got[k] == want[k], k


def test_verify_search_and_orchestrate(tmp_path, monkeypatch, capsys):
    """``verify.py``'s check through ``lm_sweep``: every task (one per batch
    size, cloned across lrs without profiling again) is searched only within
    its chip range, runs to its batch count and ends with a checkpoint."""
    monkeypatch.chdir(tmp_path)  # the word tokenizer's data cache is relative
    tasks = lm_sweep.main(["--platform", "cpu", "--preset", "test-tiny", "--batch-count", "12",
                           "--techniques", "dp", "--chip-range", "1", "--lrs", "1e-3", "3e-4",
                           "--save-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert [t.name for t in tasks] == ["test-tiny-bs8-lr0.001", "test-tiny-bs8-lr0.0003"]
    assert "tokenizer=word" in out and "corpus.txt" in out
    for t in tasks:
        assert set(t.feasible_strategies()) == {1}
        assert t.total_batches == 0 and t.has_ckpt() and ckpt.saved_step(t.ckpt_path) == 12
        assert f"{t.name}: trained steps=12 remaining=0" in out
    assert tasks[1].hparams.lr == 3e-4 and tasks[1].get_dataset() is tasks[0].get_dataset()


def test_module_runs_as_a_script(tmp_path):
    """``python -m saturn_tpu_torch.examples.lm_sweep`` on the CPU."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT),
               SATURN_TPU_PROFILE_CACHE_DIR=str(tmp_path / "profile_cache"))
    out = subprocess.run(
        [sys.executable, "-m", "saturn_tpu_torch.examples.lm_sweep", "--platform", "cpu",
         "--preset", "test-tiny", "--batch-count", "4", "--techniques", "dp", "--corpus",
         "synthetic", "--lrs", "1e-3", "--save-dir", str(tmp_path / "ck")],
        env=env, cwd=tmp_path, check=True, capture_output=True, text=True, timeout=300).stdout
    assert "corpus: synthetic" in out and "trained steps=4 remaining=0" in out


def test_clone_matches_jax(tmp_path):
    """``Task.clone``: a new name and lr, the same factories and dataset,
    the strategies copied (not shared), the rest of the hparams kept."""
    def make(pkg):
        T, H = (sat.Task, sat.HParams) if pkg == "port" else (JTask, JHParams)
        S = sat.Strategy if pkg == "port" else JStrategy
        t = T(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
              get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4,
                                                     vocab_size=256, n_tokens=64 * 4 * 8),
              loss_fn=pretraining_loss, hparams=H(lr=1e-3, batch_count=5), chip_range=[1],
              hints={"a": 1}, name="base", save_dir=str(tmp_path / f"ck-{pkg}"))
        t.strategies[1] = S(object(), 1, {"remat": False}, 2.5, per_batch_time=0.5)
        return t

    for pkg in ("port", "jax"):
        base = make(pkg)
        c = base.clone(name="base-lr3", lr=3e-3)
        assert (c.name, c.hparams.lr, c.hparams.batch_count) == ("base-lr3", 3e-3, 5)
        assert c.chip_range == [1] and c.hints == {"a": 1} and c.hints is not base.hints
        assert c.get_dataset() is base.get_dataset() and c.total_batches == 5
        assert c.strategies[1] is not base.strategies[1]
        assert (c.strategies[1].runtime, c.strategies[1].params) == (2.5, {"remat": False})
        same = base.clone()
        assert same.hparams == base.hparams and same.hparams is not base.hparams
