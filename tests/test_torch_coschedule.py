"""Co-scheduled interleaving in the port (``SPMDTechnique.interval_dispatches
(shared=True)`` and the engine's group launcher) against solo runs and
against the JAX package, on the CPU at ``test-tiny``:

- two members' dispatch generators, round-robined unit by unit as the
  group launcher does, keep each member's losses and checkpoint bitwise
  equal to its solo run (tolerance 0: the same units in the same order on
  the same state);
- a two-task ``orchestrate`` whose plan co-schedules the pair (measured
  host fractions set on both packages' strategy tables) gives the JAX
  package's plan groups, event kinds and final steps.
"""

import jax.numpy as jnp
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu import durability as jdur
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.executor.orchestrator import orchestrate as j_orchestrate
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.utils import metrics as jmetrics
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.models.bert import build_bert, mlm_loss
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics

CPU = [torch.device("cpu")]
SEQ, BATCH, VOCAB, N = 64, 4, 256, 6


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    monkeypatch.delenv("SATURN_TPU_PROFILE_CACHE", raising=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(tmp_path, name, bert=False, lr=1e-3, sub="t", hf=0.0):
    build = build_bert if bert else build_gpt2
    model = "bert-test-tiny" if bert else "test-tiny"
    t = Task(get_model=lambda **kw: build(model, seq_len=SEQ, **kw),
             get_dataloader=lambda: make_lm_dataset(
                 context_length=SEQ, batch_size=BATCH, vocab_size=VOCAB,
                 n_tokens=SEQ * BATCH * 8, reserved_ids=1 if bert else 0),
             loss_fn=mlm_loss if bert else pretraining_loss,
             hparams=HParams(lr=lr, batch_count=N), name=name,
             save_dir=str(tmp_path / sub))
    t.strategies[1] = Strategy(DataParallel(), 1, {"remat": False}, 0.01 * N, 0.01,
                               host_fraction=hf)
    t.select_strategy(1)
    return t


def _state_equal(a, b):
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k], rtol=0, atol=0)
    for i, per in a["opt_state"]["state"].items():
        for k, v in per.items():
            torch.testing.assert_close(v, b["opt_state"]["state"][i][k], rtol=0, atol=0)
    assert a["step"] == b["step"]


@pytest.mark.parametrize("window", [1, 4])
def test_interleaved_dispatch_equals_solo_bitwise(tmp_path, window):
    solos = [_task(tmp_path, "gpt", sub="solo"), _task(tmp_path, "bert", bert=True, sub="solo")]
    for t in solos:
        t.selected_strategy.executor.execute(t, CPU, 0, override_batch_count=N,
                                             window_size=window)
    pair = [_task(tmp_path, "gpt", sub="pair"), _task(tmp_path, "bert", bert=True, sub="pair")]
    gens = [t.selected_strategy.executor.interval_dispatches(
        t, CPU, i, override_batch_count=N, window_size=window, shared=True)
        for i, t in enumerate(pair)]
    order, drained = [], []
    pending = list(enumerate(gens))
    while pending:
        for i, g in list(pending):
            tag, u = next(g)
            order.append((i, tag))
            if tag == "drain":
                pending.remove((i, g))
                drained.append(g)
    for g in drained:
        for _ in g:
            pass
    ckpt.flush()
    # the members took turns, unit by unit
    assert order[:4] == [(0, "dispatched"), (1, "dispatched")] * 2
    for solo, t in zip(solos, pair):
        assert t.last_losses == solo.last_losses
        _state_equal(ckpt.load(t.ckpt_path), ckpt.load(solo.ckpt_path))
        assert t.selected_strategy.executor.intervals[-1]["shared"]


def test_engine_group_launcher_runs_a_coschedule_group(tmp_path):
    pair = [_task(tmp_path, "gpt", hf=0.6), _task(tmp_path, "bert", bert=True, hf=0.6)]
    solos = [_task(tmp_path, "gpt", sub="solo"), _task(tmp_path, "bert", bert=True, sub="solo")]
    for t in solos:
        t.selected_strategy.executor.execute(t, CPU, 0, override_batch_count=N)
    plan = milp.Plan({t.name: milp.Assignment(1, Block(0, 1), 0.0, 0.06) for t in pair},
                     makespan=0.06, coschedule=[["gpt", "bert"]])
    plan.compute_dependencies()
    assert plan.dependencies == {"gpt": [], "bert": []}
    topo = SliceTopology(CPU)
    from saturn_tpu_torch.analysis import verify_or_raise

    verify_or_raise(plan, topology=topo, tasks=pair)
    done = []
    errors = engine.execute(pair, {t.name: N for t in pair}, 1000.0, plan, topo,
                            on_task_done=lambda n, b: done.append((n, b)))
    ckpt.flush()
    assert errors == {} and sorted(done) == [("bert", N), ("gpt", N)]
    for solo, t in zip(solos, pair):
        assert t.last_losses == solo.last_losses and t.current_batch == N
        _state_equal(ckpt.load(t.ckpt_path), ckpt.load(solo.ckpt_path))
        assert t.last_per_batch_s > 0


def _jtask(tmp_path, name, lr):
    t = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", seq_len=SEQ,
                                                  dtype=jnp.float32, **kw),
              get_dataloader=lambda: j_make_lm_dataset(
                  context_length=SEQ, batch_size=BATCH, vocab_size=VOCAB,
                  n_tokens=SEQ * BATCH * 8),
              loss_fn=j_pretraining_loss, hparams=JHParams(lr=lr, batch_count=N),
              chip_range=[1], name=name, save_dir=str(tmp_path / "jax"))
    t.strategies[1] = JStrategy(executor=JDataParallel(), apportionment=1, params={},
                                runtime=0.01 * N, per_batch_time=0.01, host_fraction=0.6)
    return t


KINDS = ("solve", "solver_tier", "interval", "task_completed")


def test_two_task_orchestrate_matches_jax(tmp_path):
    """Two tasks, each with a measured host fraction of 0.6 and no measured
    fused step (so they do not fuse): both packages' solvers co-schedule
    the pair, run it in one interval, and journal the same plan groups."""
    jtasks = [_jtask(tmp_path, "a", 1e-3), _jtask(tmp_path, "b", 2e-3)]
    jev = str(tmp_path / "jax_events.jsonl")
    j_orchestrate(jtasks, interval=1000.0, topology=JSliceTopology(jax_cpu()),
                  metrics_path=jev, resume_dir=str(tmp_path / "jax_wal"))
    tasks = [_task(tmp_path, "a", hf=0.6), _task(tmp_path, "b", lr=2e-3, hf=0.6)]
    for t in tasks:
        t.chip_range = [1]
    ev = str(tmp_path / "events.jsonl")
    out = sat.orchestrate(tasks, interval=1000.0, topology=SliceTopology(CPU),
                          metrics_path=ev, resume_dir=str(tmp_path / "wal"))
    assert sorted(out["completed"]) == ["a", "b"]

    def plans(root):
        return [r["data"]["plan"] for r in jdur.replay(root, strict=True)
                if r["kind"] == "plan_commit"]

    mine, theirs = plans(str(tmp_path / "wal")), plans(str(tmp_path / "jax_wal"))
    assert [p["coschedule"] for p in mine] == [p["coschedule"] for p in theirs] == [[["a", "b"]]]
    assert [p["fused"] for p in mine] == [p["fused"] for p in theirs] == [[]]

    def kinds(events):
        return [e["kind"] for e in events if e["kind"] in KINDS]

    assert kinds(metrics.read_events(ev)) == kinds(jmetrics.read_events(jev))
    assert sorted(e["task"] for e in metrics.read_events(ev, kind="task_completed")) == \
        sorted(e["task"] for e in jmetrics.read_events(jev, kind="task_completed"))
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == N
    from saturn_tpu.utils import checkpoint as jckpt

    jckpt.flush()
    assert [int(jckpt.load_arrays(t.ckpt_path)["step"]) for t in jtasks] == [N, N]


def jax_cpu():
    import jax

    return jax.devices()[:1]
