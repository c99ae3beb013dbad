"""Fused multi-model stacking in the port (``saturn_tpu_torch/parallel/fused.py``)
against the JAX package (``saturn_tpu/parallel/fused.py``) and against the
port's own solo runs, on the CPU at ``test-tiny`` (f32 compute on both
sides, both through the fused CE head: the port's plain version, the JAX
Pallas kernels in interpret mode):

- ``fusion_fingerprint`` puts the tasks of one set in the JAX package's
  classes, and ``fusion_candidates`` proposes its groups;
- a 3-member stacked run keeps each member's 5-step loss trajectory within
  TRAJ_TOL (1e-4, the repo's trajectory tolerance: the members' products
  are batched over the member axis, f32 sums taken in another order) of the
  JAX package's stacked run, started from the same numbers through
  ``models.convert.stacked_from_jax``, and of the port's solo runs;
- the stacked AdamW, Adam and SGD equal ``HParams.make_optimizer``'s torch
  optimizer on one member within OPT_TOL (1e-6) over 5 steps;
- an unfuse mid-interval, then a solo resume, loses and repeats no step;
- ``profile_fused_group`` installs ``fused_per_batch_time`` and refuses an
  unfusable group; ``search`` -> ``orchestrate`` runs a fused plan to every
  member's budget.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.ops import stacking as jstacking
from saturn_tpu.parallel import fused as jfused
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.convert import stacked_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel import fused
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.trial_runner import evaluator
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics

OPT_TOL, TRAJ_TOL = 1e-6, 1e-4
CPU = [torch.device("cpu")]
SEQ, BATCH, VOCAB, STEPS = 64, 4, 256, 5
LRS = {"a": 1e-3, "b": 2e-3, "c": 5e-4}


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    monkeypatch.delenv("SATURN_TPU_PROFILE_CACHE", raising=False)


def _loader(seq=SEQ):
    return make_lm_dataset(context_length=seq, batch_size=BATCH, vocab_size=VOCAB,
                           n_tokens=seq * BATCH * 8)


def _task(tmp_path, name, lr, batch_count=6, seq=SEQ, loss=pretraining_loss,
          chip_range=(1,), optimizer="adamw", sub="t"):
    t = Task(get_model=lambda **kw: build_gpt2("test-tiny", seq_len=seq, **kw),
             get_dataloader=lambda: _loader(seq), loss_fn=loss,
             hparams=HParams(lr=lr, batch_count=batch_count, optimizer=optimizer,
                             kwargs={"dtype": torch.float32}),
             chip_range=list(chip_range) if chip_range else None, name=name,
             save_dir=str(tmp_path / sub))
    t.strategies[1] = Strategy(DataParallel(), 1, {"remat": False}, 1.0, 0.01)
    t.select_strategy(1)
    return t


def _jtask(tmp_path, name, lr, seq=SEQ, loss=j_pretraining_loss, chip_range=(1,),
           optimizer="adamw"):
    t = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", seq_len=seq,
                                                  dtype=jnp.float32, **kw),
              get_dataloader=lambda: j_make_lm_dataset(
                  context_length=seq, batch_size=BATCH, vocab_size=VOCAB,
                  n_tokens=seq * BATCH * 8),
              loss_fn=loss, hparams=JHParams(lr=lr, batch_count=6, optimizer=optimizer),
              chip_range=list(chip_range) if chip_range else None, name=name,
              save_dir=str(tmp_path / "jax"))
    t.strategies[1] = JStrategy(executor=JDataParallel(), apportionment=1, params={},
                                runtime=1.0, per_batch_time=0.01)
    t.select_strategy(1)
    return t


def _untagged(logits, tokens):
    return pretraining_loss(logits, tokens)


def _j_untagged(logits, tokens):
    return j_pretraining_loss(logits, tokens)


# ------------------------------------------------------------- candidates
def test_fingerprint_classes_and_candidates_match_jax(tmp_path):
    """Five lr points, another sequence length, an untagged loss, a user
    optimizer callable and a task that may run on two devices: the same
    classes, the same groups (chunked at three)."""
    specs = [(f"lr{i}", dict(lr=1e-3 * (i + 1))) for i in range(5)]
    specs += [("seq32", dict(lr=1e-3, seq=32)), ("untagged", dict(lr=1e-3, loss="untagged")),
              ("wide", dict(lr=1e-3, chip_range=(1, 2))),
              ("callable", dict(lr=1e-3, optimizer="callable"))]

    def build(make, loss_pair, opt_fn):
        out = []
        for name, kw in specs:
            kw = dict(kw)
            if kw.get("loss") == "untagged":
                kw["loss"] = loss_pair
            else:
                kw.pop("loss", None)
            callable_opt = kw.pop("optimizer", None) == "callable"
            t = make(tmp_path, name, **kw)
            if callable_opt:
                t.hparams.optimizer = opt_fn
            out.append(t)
        return out

    port = build(_task, _untagged, lambda params, lr: torch.optim.SGD(params, lr=lr))
    jax_tasks = build(_jtask, _j_untagged, lambda lr: None)

    def classes(tasks, fp_of):
        by = {}
        for t in tasks:
            by.setdefault(fp_of(t), []).append(t.name)
        return sorted(sorted(v) for k, v in by.items() if k is not None), \
            sorted(t.name for t in tasks if fp_of(t) is None)

    assert classes(port, fused.fusion_fingerprint) == classes(jax_tasks, jfused.fusion_fingerprint)
    for kw in ({}, {"max_members": 3}, {"min_members": 3}):
        assert fused.fusion_candidates(port, **kw) == jfused.fusion_candidates(jax_tasks, **kw)
    assert fused.fusion_candidates(port, max_members=3) == [
        ["lr0", "lr1", "lr2"], ["lr3", "lr4"]]


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_stacked_optimizer_matches_torch_on_each_member(name):
    rng = np.random.default_rng(0)
    lrs = [1e-2, 3e-3]
    p0 = rng.standard_normal((2, 5, 3)).astype(np.float32)
    grads = [rng.standard_normal((2, 5, 3)).astype(np.float32) for _ in range(5)]
    stacked = torch.nn.Parameter(torch.tensor(p0))
    opt = fused.StackedOptimizer([stacked], name, lrs)
    solo = [torch.nn.Parameter(torch.tensor(p0[m])) for m in range(2)]
    topts = [HParams(lr=lr, batch_count=1, optimizer=name).make_optimizer([p])
             for lr, p in zip(lrs, solo)]
    for g in grads:
        stacked.grad = torch.tensor(g)
        opt.step()
        opt.zero_grad()
        for m in range(2):
            solo[m].grad = torch.tensor(g[m])
            topts[m].step()
            np.testing.assert_allclose(stacked.detach()[m].numpy(), solo[m].detach().numpy(),
                                       rtol=OPT_TOL, atol=OPT_TOL)
    assert stacked.grad is None


# ------------------------------------------------------------ trajectories
@pytest.fixture
def jax_interpret_ce(monkeypatch):
    from saturn_tpu.ops import ce as jce

    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))


def _jax_stacked_run(tmp_path, n_steps):
    """The JAX package's stacked program on its own init: the stacked
    params at step 0 (host) and the (steps, N) losses."""
    members = [_jtask(tmp_path, f"j{k}", lr) for k, lr in LRS.items()]
    prog = jfused.build_fused_program(members, jax.devices()[:1])
    host0 = jstacking.stack_trees([prog.init_member_host(m.hparams.lr) for m in members])
    state = jax.device_put(host0, prog.state_shardings)
    lrs = jnp.asarray([m.hparams.lr for m in members], dtype=jnp.float32)
    fn = prog.single_compiled()
    losses = []
    for i in range(n_steps):
        batch = jstacking.stack_member_batches([m.batch_at(i) for m in members])
        state, loss = fn(state, jnp.asarray(batch), lrs)
        losses.append(np.asarray(loss))
    return host0["params"], np.stack(losses)


def _start_from(prog, members, stacked_params):
    """Give ``members`` a live stacked state holding ``stacked_params``."""
    state = prog.new_state([m.hparams.lr for m in members])
    with torch.no_grad():
        for n, p in state["params"].named_parameters():
            p.copy_(stacked_params[n])
    key = fused._live_key(fused.fusion_fingerprint(members[0]), {"remat": False},
                          prog.device, [m.name for m in members])
    for m in members:
        m._live_state = (key, state)


def test_stacked_run_matches_jax_and_solo(tmp_path, jax_interpret_ce):
    jparams0, want = _jax_stacked_run(tmp_path, STEPS)
    stacked0 = stacked_from_jax(jparams0)
    members = [_task(tmp_path, k, lr, sub="fused") for k, lr in LRS.items()]
    prog = fused.build_fused_program(members, CPU)
    assert set(stacked0) == set(prog.names)
    _start_from(prog, members, stacked0)
    report = fused.run_fused_interval(members, CPU, 0, batch_counts=[STEPS] * 3)
    ckpt.flush()
    assert report.n_steps == STEPS and not report.detached
    got = np.stack([report.losses[m.name] for m in members], axis=1)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for i, (k, lr) in enumerate(LRS.items()):
        solo = _task(tmp_path, f"solo-{k}", lr, sub="solo")
        state = solo.selected_strategy.executor.build(solo, CPU, {"remat": False}).empty()
        state["params"].load_state_dict({n: t[i] for n, t in stacked0.items()})
        ckpt.save(solo.ckpt_path, state)
        solo.selected_strategy.executor.execute(solo, CPU, 0, override_batch_count=STEPS)
        np.testing.assert_allclose(report.losses[members[i].name], solo.last_losses,
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
        saved = ckpt.load(members[i].ckpt_path)
        assert saved["step"] == STEPS
        solo_saved = ckpt.load(solo.ckpt_path)
        assert set(saved["params"]) == set(solo_saved["params"])
        assert saved["opt_state"]["param_groups"][0]["lr"] == lr
        assert float(saved["opt_state"]["state"][0]["step"]) == STEPS


def test_unfuse_then_solo_resume_loses_no_step(tmp_path):
    """Member b leaves the stack after two windows of 2 (step 4 of 6): its
    checkpoint is at step 4, its solo resume trains batches 4 and 5, and
    its six losses equal its uninterrupted solo run's within TRAJ_TOL; a and
    c finish the interval on a stack of two."""
    members = [_task(tmp_path, k, lr, sub="fused") for k, lr in LRS.items()]
    polls = itertools.count()
    events = str(tmp_path / "events.jsonl")
    with metrics.scoped(events):
        report = fused.run_fused_interval(
            members, CPU, 0, batch_counts=[6] * 3, window_size=2,
            detach_requested=lambda t: t.name == "b" and next(polls) >= 2)
    assert [(m.name, s) for m, s in report.detached] == [("b", 4)]
    b = members[1]
    assert ckpt.saved_step(b.ckpt_path) == 4
    # as the engine's fused launcher resumes a detached member
    b.selected_strategy.executor.execute(b, CPU, 0, override_batch_count=2)
    b.reconfigure(2)
    ckpt.flush()
    assert ckpt.load(b.ckpt_path)["step"] == 6 and b.current_batch == 6
    solo = _task(tmp_path, "solo-b", LRS["b"], sub="solo")
    solo.selected_strategy.executor.execute(solo, CPU, 0, override_batch_count=6)
    np.testing.assert_allclose(report.losses["b"] + b.last_losses, solo.last_losses,
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for m in (members[0], members[2]):
        assert report.members[m.name].steps == 6 and len(report.losses[m.name]) == 6
        assert ckpt.load(m.ckpt_path)["step"] == 6
    unfuse = metrics.read_events(events, kind="fused_unfuse")
    assert [(e["task"], e["step"], e["n_remaining"]) for e in unfuse] == [("b", 4, 2)]
    (ev,) = metrics.read_events(events, kind="fused_interval")
    assert ev["members"] == ["a", "b", "c"] and ev["detached"] == ["b"]


def test_profile_fused_group_prices_and_refuses(tmp_path):
    members = [_task(tmp_path, k, lr) for k, lr in LRS.items()]
    got = evaluator.profile_fused_group(members, topology=SliceTopology(CPU))
    assert set(got) == {1} and got[1] > 0
    assert all(m.strategies[1].fused_per_batch_time == got[1] for m in members)
    other = _task(tmp_path, "seq32", 1e-3, seq=32)
    with pytest.raises(ValueError, match="not fusable"):
        evaluator.profile_fused_group([members[0], other], topology=SliceTopology(CPU))
    with pytest.raises(ValueError, match="at least 2"):
        evaluator.profile_fused_group(members[:1], topology=SliceTopology(CPU))


def test_search_then_orchestrate_runs_a_fused_plan(tmp_path):
    """The four calls on four lr points: search measures one fused group,
    orchestrate runs a plan with ``Plan.fused`` and every member reaches
    its budget; the ``fused_interval`` events cover every member."""
    sat.library.register_default_library()
    tasks = [_task(tmp_path, f"m{i}", lr, batch_count=12)
             for i, lr in enumerate((1e-4, 3e-4, 6e-4, 1e-3))]
    for t in tasks:
        t.strategies = {}
    topo = SliceTopology(CPU)
    stats = sat.search(tasks, technique_names=["dp"], topology=topo)
    assert stats["fused_groups"] == 1 and stats["trials_run"] == 1
    for t in tasks:
        s = t.strategies[1]
        assert s.fused_per_batch_time is not None and 0.0 < s.host_fraction < 1.0
        # whether the measured lockstep beats four solo steps is a matter of
        # CPU timing here (the pricing itself: tests/test_torch_milp_groups.py):
        # price the stack at twice a solo step, as where stacking pays
        s.fused_per_batch_time = 2.0 * s.per_batch_time
    events = str(tmp_path / "events.jsonl")
    out = sat.orchestrate(tasks, interval=1000.0, topology=topo, metrics_path=events,
                          resume_dir=str(tmp_path / "wal"))
    assert sorted(out["completed"]) == [t.name for t in tasks]
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == 12
    fused_events = metrics.read_events(events, kind="fused_interval")
    assert fused_events and {n for e in fused_events for n in e["members"]} == {
        t.name for t in tasks}
    from saturn_tpu import durability as jdur
    from saturn_tpu_torch.solver import milp

    commits = [r for r in jdur.replay(str(tmp_path / "wal"), strict=True)
               if r["kind"] == "plan_commit"]
    assert milp.Plan.from_json(commits[0]["data"]["plan"]).fused == [[t.name for t in tasks]]
    assert fused._PROGRAMS == {}  # orchestrate released the stacked programs


def test_guardian_detaches_a_grouped_task_as_jax_does():
    """Two consecutive faults of a task in a group detach it (``detach_after``
    2) in both packages, with the same decisions and detach set; the port
    also flags the task (``_fused_detach``), so a running stack unfuses it,
    and a task outside any group is never detached."""
    from types import SimpleNamespace

    from saturn_tpu.health import NumericFaultError as JFault
    from saturn_tpu.health import TrainingGuardian as JGuardian
    from saturn_tpu_torch.health import NumericFaultError, TrainingGuardian

    def run(guardian_cls, fault_cls):
        g = guardian_cls()
        grouped = SimpleNamespace(name="grouped", quarantine_batches=lambda idx: None)
        solo = SimpleNamespace(name="solo", quarantine_batches=lambda idx: None)
        out = []
        for i in range(3):
            for t, in_group in ((grouped, True), (solo, False)):
                d = g.on_fault(t, fault_cls(t.name, 0, "nonfinite", step=1, loss=float("nan"),
                                            batch_indices=(i,), bad_count=1), i,
                               in_group=in_group)
                out.append((t.name, d.action, d.attempt, d.detached))
        return out, sorted(g.detached_names()), grouped

    got, names, grouped = run(TrainingGuardian, NumericFaultError)
    want, jnames, _ = run(JGuardian, JFault)
    assert got == want and names == jnames == ["grouped"]
    assert grouped._fused_detach is True
