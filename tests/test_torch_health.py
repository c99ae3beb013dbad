"""The port's training-health path against the JAX package: the sentinel's
fold (on the host in the port, a jitted scan in JAX), the guardian's policy,
the engine's watchdog, the quarantine skip-list, the orchestrator's failure
policies and the metrics file both packages read.

Tolerances: sentinel reports within 1e-6 relative (both fold in float32,
step by step); guardian decisions, skip-lists and event sequences exactly.
"""

import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.executor.orchestrator import orchestrate as j_orchestrate
from saturn_tpu.health import GuardianConfig as JGuardianConfig
from saturn_tpu.health import HungDispatchError as JHungDispatchError
from saturn_tpu.health import NumericFaultError as JNumericFaultError
from saturn_tpu.health import TrainingGuardian as JTrainingGuardian
from saturn_tpu.health import sentinel as jsentinel
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.utils import metrics as jmetrics
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.health import (
    HEALTH_EVENT_CODES,
    GuardianConfig,
    HungDispatchError,
    NumericFaultError,
    SentinelConfig,
    TrainingGuardian,
)
from saturn_tpu_torch.health import guardian as guardian_mod
from saturn_tpu_torch.health import sentinel
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.solver.milp import Assignment, Plan
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics

REL = 1e-6
CPU = [torch.device("cpu")]
MARK = 255  # a whole row of this token marks a poisoned batch
NAN, INF = float("nan"), float("inf")


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_SENTINEL", "SATURN_TPU_SENTINEL_SPIKE",
                 "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)
    sat.library.register_default_library()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- sentinel
FOLD_CASES = [
    ([5.5, 5.25, 5.125], None),
    ([1.0, NAN, 1.0], None),
    ([1.0, 1.0, INF], None),
    ([NAN, 1.0, -INF, 2.0], None),
    ([2.0, NAN], None),
    ([1.0, 1.0, 1.0, 50.0, 1.0, 70.0], SentinelConfig(spike_factor=3.0, warmup_steps=2)),
    ([1.0, 1.0, 1.0, 50.0], SentinelConfig(spike_factor=0.0, warmup_steps=2)),
    ([3.0, 2.9, 2.7, 2.8, 9.0, NAN, 2.5], SentinelConfig(spike_factor=2.0, ewma_alpha=0.5,
                                                        warmup_steps=3)),
]


@pytest.mark.parametrize("losses,cfg", FOLD_CASES)
@pytest.mark.parametrize("carry", [None, (2.75, 11.0)])
def test_sentinel_fold_matches_jax(losses, cfg, carry):
    cfg = cfg or SentinelConfig()
    jcfg = jsentinel.SentinelConfig(**cfg.__dict__)
    c = sentinel.carry_init() if carry is None else np.asarray(carry, np.float32)
    rng = np.random.default_rng(len(losses))
    vec = np.asarray(losses, np.float32) * np.float32(1.0 + 1e-3 * rng.standard_normal())
    want = np.asarray(jsentinel.fold(jnp.asarray(c), jnp.asarray(vec), jcfg))
    got = sentinel.fold(c, vec, cfg)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0, equal_nan=True)
    assert sentinel.inspect(got) == jsentinel.inspect(want)


def test_sentinel_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("SATURN_TPU_SENTINEL_SPIKE", "4.5")
    monkeypatch.setenv("SATURN_TPU_SENTINEL_ALPHA", "0.2")
    monkeypatch.setenv("SATURN_TPU_SENTINEL_WARMUP", "3")
    assert SentinelConfig.from_env().__dict__ == jsentinel.SentinelConfig.from_env().__dict__
    monkeypatch.setenv("SATURN_TPU_SENTINEL", "off")
    assert sentinel.get_config().enabled is jsentinel.get_config().enabled is False


@pytest.mark.parametrize("plan", [
    {"steps": {1: NAN}}, {"batches": {6: 7.0}}, {"steps": {0: INF}, "batches": {5: NAN}},
    {}, {"steps": {9: NAN}},
])
def test_poison_overrides_matches_jax(plan):
    want = jsentinel.poison_overrides(plan, 4, lambda j: j + 4)
    got = sentinel.poison_overrides(plan, 4, lambda j: j + 4)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ----------------------------------------------------------------- guardian
class _SkipList:
    """A task stand-in with the skip-list contract of both packages' Task."""

    def __init__(self, name, epoch_length=8):
        self.name, self.epoch_length, self._q = name, epoch_length, set()

    def quarantine_batches(self, indices):
        add = {int(i) % self.epoch_length for i in indices}
        if len(self._q | add) >= self.epoch_length:
            raise ValueError("would empty the dataset")
        self._q |= add


SCRIPT = [  # (interval, task, fault kind, batches); "ok" = a clean interval
    (0, "sick", "nan", (2,)), (2, "sick", "nan", (2, 3)), (3, "wedged", "hung", ()),
    (5, "sick", "ok", ()), (6, "sick", "nan", (4,)), (7, "wedged", "hung", ()),
    (8, "sick", "nan", (4,)), (9, "wedged", "hung", ()), (11, "sick", "nan", (4,)),
    (13, "sick", "nan", (0, 1, 5, 6, 7)), (16, "sick", "nan", (1,)),
]


def _run_script(pkg_guardian, config, numeric, hung, monkeypatch, metrics_mod):
    events = []
    monkeypatch.setattr(metrics_mod, "event", lambda kind, **kw: events.append((kind, kw)))
    g = pkg_guardian(config)
    tasks = {n: _SkipList(n) for n in ("sick", "wedged")}
    out = []
    for i, name, kind, batches in SCRIPT:
        benched = [g.benched(n, i) for n in sorted(tasks)]
        if kind == "ok":
            g.note_success(name)
            out.append(("ok", benched))
            continue
        err = (numeric(name, 0, "nonfinite", step=0, loss=NAN, batch_indices=batches,
                       bad_count=len(batches)) if kind == "nan" else hung(name, 1.0, 2.0))
        d = g.on_fault(tasks[name], err, i)
        out.append((d.action, d.cause, d.attempt, d.cooldown, d.quarantined, benched,
                    g.resume_interval(name), tuple(sorted(tasks[name]._q))))
    return out, events


def test_guardian_scripted_faults_match_jax(monkeypatch):
    """One fault sequence through both guardians: identical decisions,
    benching, backoff, quarantine, eviction and events."""
    from saturn_tpu.health import guardian as jguardian_mod

    cfg = dict(retry_budget=4, hung_budget=2, quarantine_after=2, backoff_cap=4)
    want, jev = _run_script(JTrainingGuardian, JGuardianConfig(**cfg), JNumericFaultError,
                            JHungDispatchError, monkeypatch, jguardian_mod.metrics)
    got, ev = _run_script(TrainingGuardian, GuardianConfig(**cfg), NumericFaultError,
                          HungDispatchError, monkeypatch, guardian_mod.metrics)
    assert got == want
    assert ev == jev
    assert [d[0] for d in got] == ["retry", "retry", "retry", "ok", "retry", "retry",
                                   "retry", "evict", "retry", "retry", "evict"]


def test_guardian_config_from_env_matches_jax(monkeypatch):
    for name, value in (("SATURN_TPU_HEALTH_RETRIES", "5"), ("SATURN_TPU_HUNG_RETRIES", "1"),
                        ("SATURN_TPU_HEALTH_BACKOFF_CAP", "2"), ("SATURN_TPU_WATCHDOG", "off"),
                        ("SATURN_TPU_WATCHDOG_FACTOR", "3"),
                        ("SATURN_TPU_WATCHDOG_FLOOR_S", "7.5")):
        monkeypatch.setenv(name, value)
    # the port carries the knobs and codes its policy reads (no co-schedule
    # detach yet): each equals the JAX package's of the same name
    for got, jax_cfg in ((GuardianConfig.from_env(), JGuardianConfig.from_env()),
                         (GuardianConfig(), JGuardianConfig())):
        assert got.__dict__ == {f: getattr(jax_cfg, f) for f in got.__dict__}
    assert HEALTH_EVENT_CODES == {k: guardian_mod.HEALTH_EVENT_CODES[k]
                                  for k in HEALTH_EVENT_CODES}
    g = TrainingGuardian(GuardianConfig(watchdog_floor_s=60.0, watchdog_factor=8.0))
    assert g.window_deadline_s(10.0) == pytest.approx(140.0)


@pytest.mark.parametrize("err,owned", [
    (NumericFaultError("t", 0, "nonfinite"), True),
    (HungDispatchError("t", 1.0, 2.0), True),
    (RuntimeError("flash_fwd kernel launch failed: CUDA error 700"), False),
    (RuntimeError("nvcc build of csrc/linear_ce.cu failed"), False),
    (FileNotFoundError("nvcc not found (set CUDA_HOME)"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
])
def test_guardian_owns_training_faults_only(err, owned):
    """A kernel that does not build or launch is the caller's failure, not
    a training fault to retry."""
    assert TrainingGuardian.owns(err) is owned


# ---------------------------------------------------------- task skip-list
def test_quarantine_cursor_math_matches_jax(tmp_path):
    def loader():
        return make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                               n_tokens=64 * 4 * 8)

    def jloader():
        return j_make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                                 n_tokens=64 * 4 * 8)

    t = sat.Task(lambda **kw: None, loader, pretraining_loss,
                 sat.HParams(batch_count=8), name="q", save_dir=str(tmp_path))
    jt = JTask(lambda **kw: None, jloader, j_pretraining_loss,
               JHParams(batch_count=8), name="q", save_dir=str(tmp_path / "j"))
    for task in (t, jt):
        task.quarantine_batches([5, 13])
        task.reconfigure(6)
    assert t.quarantined_batches == jt.quarantined_batches == (5,)
    assert t.surviving_epoch_length == jt.surviving_epoch_length == 7
    assert t.current_batch == jt.current_batch
    for step in range(20):
        assert t.dataset_index(step) == jt.dataset_index(step)
        np.testing.assert_array_equal(t.batch_at(step), np.asarray(jt.batch_at(step)))
        assert t.cursor_for_step(step) == jt.cursor_for_step(step)
    for task in (t, jt):
        with pytest.raises(ValueError):
            task.quarantine_batches(range(8))
        task.unquarantine_batches()
    assert t.quarantined_batches == () and t.surviving_epoch_length == 8


# ----------------------------------------------------- poisoned GPT-2 tasks
class Poisoned:
    """A dataset whose batch ``index`` carries a whole row of ``MARK``."""

    def __init__(self, base, index):
        self.base, self.index = base, index
        self.batch_size = base.batch_size

    def __len__(self):
        return len(self.base)

    def batch(self, i):
        b = np.array(self.base.batch(i))
        if i % len(self.base) == self.index:
            b[0, :] = MARK
        return b

    def example_batch(self):
        return self.base.example_batch()


def sick_loss(logits, tokens):
    """The pretraining loss over the logits, plus sqrt(-1) — NaN — on a
    marked batch (no gradient flows through the mark)."""
    return pretraining_loss(logits, tokens) + torch.sqrt(-(tokens[0] == MARK).all().float())


def logits_loss(logits, tokens):
    """``pretraining_loss`` without its fused-head tag: the logits path."""
    return pretraining_loss(logits, tokens)


def j_sick_loss(logits, tokens):
    return j_pretraining_loss(logits, tokens) + jnp.sqrt(
        -jnp.all(tokens[0] == MARK).astype(jnp.float32))


def _loader(poison=None):
    base = make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                           n_tokens=64 * 4 * 8)
    return base if poison is None else Poisoned(base, poison)


def _jloader(poison=None):
    base = j_make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                             n_tokens=64 * 4 * 8)
    return base if poison is None else Poisoned(base, poison)


def _task(tmp_path, name, batch_count=8, poison=None, lr=1e-3, loss=None):
    return sat.Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **kw),
        get_dataloader=lambda: _loader(poison),
        loss_fn=loss or (pretraining_loss if poison is None else sick_loss),
        hparams=sat.HParams(lr=lr, batch_count=batch_count),
        name=name, save_dir=str(tmp_path / "ckpts"),
    )


def _pin(task, tech, params, pbt=1.0):
    """One profiled size-1 strategy of ``pbt`` seconds per batch."""
    cls = JStrategy if isinstance(task, JTask) else sat.Strategy
    task.strategies = {1: cls(tech, 1, params, pbt * task.total_batches, pbt)}


def test_execute_screens_before_the_checkpoint(tmp_path):
    """A NaN at batch 5 of an interval raises before the checkpoint is
    written and before the state is kept live; the carry does not move."""
    # a process's first optimizer imports torch's compile machinery, whose
    # frames keep that optimizer's caller alive: make it here
    torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))])
    t = _task(tmp_path, "sick", poison=5)
    tech = DataParallel()
    _pin(t, tech, {"remat": False})
    t.select_strategy(1)
    tech.execute(t, CPU, 0, override_batch_count=4)
    t.reconfigure(4)
    carry = t._sentinel_carry.copy()
    assert carry[1] == 4.0 and ckpt.load(t.ckpt_path)["step"] == 4
    live = weakref.ref(t._live_state[1]["params"])
    with pytest.raises(NumericFaultError) as err:
        tech.execute(t, CPU, 0, override_batch_count=4)
    e = err.value
    assert (e.cause, e.step, e.batch_indices, e.bad_count) == ("nonfinite", 1, (5,), 1)
    # the faulted state is gone: nothing of the failed interval (its
    # traceback included) holds its memory
    assert t._live_state is None and live() is None
    assert ckpt.load(t.ckpt_path)["step"] == 4
    np.testing.assert_array_equal(t._sentinel_carry, carry)
    # quarantined, the retry restores step 4 and skips batch 5
    t.quarantine_batches(e.batch_indices)
    tech.execute(t, CPU, 0, override_batch_count=4)
    assert tech.intervals[-1]["restored"] and np.isfinite(t.last_losses).all()
    assert ckpt.load(t.ckpt_path)["step"] == 8


def _health_trail(read, path, task):
    """A task's guardian transitions and numeric faults, without times and
    interval numbers."""
    out = []
    for e in read(path):
        if e.get("task") != task or e["kind"] not in ("health", "task_numeric_fault"):
            continue
        drop = {"ts", "interval", "window", "loss"}
        out.append({k: v for k, v in e.items() if k not in drop})
    return out


def test_nonfinite_batch_gives_the_same_guardian_events_as_jax(tmp_path):
    """Two tiny GPT-2 tasks, one with a loss that is NaN on batch 4,
    through both packages' orchestrate with the default guardian: the
    same faults, retries, quarantine of batch 4 and completions. Batch 4
    opens the sick task's second interval, so every retry meets it first,
    whatever budget the two loops' plans give the retry."""
    interval, j_ev, ev = 4.5, str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jtech = JDataParallel()
    jtasks = [JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", **kw),
                    get_dataloader=lambda p=p: _jloader(p),
                    loss_fn=j_pretraining_loss if p is None else j_sick_loss,
                    hparams=JHParams(lr=1e-3, batch_count=bc), name=name,
                    save_dir=str(tmp_path / "jckpts"))
              for name, p, bc in (("sick", 4, 8), ("fine", None, 12))]
    for t in jtasks:
        _pin(t, jtech, {})
    import jax
    jout = j_orchestrate(jtasks, interval=interval, metrics_path=j_ev,
                         topology=JSliceTopology(jax.devices()[:1]))

    tech = DataParallel()
    tasks = [_task(tmp_path, "sick", 8, poison=4), _task(tmp_path, "fine", 12)]
    for t in tasks:
        _pin(t, tech, {"remat": False})
    out = sat.orchestrate(tasks, interval=interval, metrics_path=ev,
                          topology=SliceTopology(CPU))

    assert sorted(out["completed"]) == sorted(jout["completed"]) == ["fine", "sick"]
    assert out["failed"] == jout["failed"] == {}
    trail = _health_trail(metrics.read_events, ev, "sick")
    assert trail == _health_trail(jmetrics.read_events, j_ev, "sick")
    codes = [e.get("code") for e in trail if e["kind"] == "health"]
    assert codes == ["SAT-H001", "SAT-H003", "SAT-H001", "SAT-H010", "SAT-H003"]
    assert tasks[0].quarantined_batches == jtasks[0].quarantined_batches == (4,)
    assert ckpt.load(tasks[0].ckpt_path)["step"] == 8
    for t in tasks:
        state = ckpt.load(t.ckpt_path)
        assert all(torch.isfinite(v).all() for v in state["params"].values())


def test_jax_reader_parses_the_port_metrics_file(tmp_path):
    """search -> orchestrate with a metrics file: the JAX package's
    ``read_events`` reads every record the port wrote, with the event kinds
    the JAX package writes."""
    ev = str(tmp_path / "events.jsonl")
    tasks = [_task(tmp_path, f"t{i}", batch_count=3, lr=lr)
             for i, lr in enumerate((1e-3, 2e-3))]
    topo = SliceTopology(CPU)
    sat.search(tasks, technique_names=["dp"], topology=topo, metrics_path=ev)
    sat.orchestrate(tasks, interval=1000.0, topology=topo, metrics_path=ev)
    mine, theirs = metrics.read_events(ev), jmetrics.read_events(ev)
    assert mine == theirs and len(mine) > 0
    kinds = {e["kind"] for e in theirs}
    assert {"trial", "profile_cache", "solve", "solver_tier", "interval",
            "task_completed"} <= kinds
    tier = jmetrics.read_events(ev, kind="solver_tier")[0]
    assert {"tier", "tier_name", "wall_s", "deadline_s", "n_tasks", "makespan_s",
            "quality", "tiers_tried", "outcome"} <= set(tier)


def test_thirteen_tasks_complete_under_the_default_guardian(tmp_path):
    """13 tasks, past ``milp_task_limit``: one profile per signature (12 lr
    points share one; the 13th loss runs the logits path), a 13-task plan
    from the ladder, every task done with finite checkpoints."""
    ev = str(tmp_path / "events.jsonl")
    tasks = [_task(tmp_path, f"lr{i}", batch_count=4, lr=1e-4 * (i + 1)) for i in range(12)]
    tasks.append(_task(tmp_path, "logits", batch_count=4, loss=logits_loss))
    topo = SliceTopology(CPU)
    stats = sat.search(tasks, technique_names=["dp"], topology=topo)
    assert stats == {"trials_run": 2, "cache_hits": 11, "pruned": 0}
    # one interval holds every task; 2 s of solving lets tier 1 split the
    # 13 tasks into two partitions of at most SATURN_TPU_PARTITION_MAX = 10
    out = sat.orchestrate(tasks, interval=1000.0, topology=topo, metrics_path=ev,
                          solver_time_limit=2.0)
    assert sorted(out["completed"]) == sorted(t.name for t in tasks) and out["failed"] == {}
    first = metrics.read_events(ev, kind="solver_tier")[0]
    assert first["n_tasks"] == 13 and first["source"] == "orchestrator-initial"
    assert first["tier"] == 1
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == 4
    assert not metrics.read_events(ev, kind="health")


# ---------------------------------------------------------- failure policies
class Flaky(DataParallel):
    """Raises an ordinary error on ``victim``'s launches numbered in ``fail_on``."""

    def __init__(self, victim, fail_on):
        super().__init__()
        self.victim, self.fail_on, self.launches = victim, set(fail_on), 0

    def execute(self, task, devices, tid, override_batch_count=None, window_size=None):
        if task.name == self.victim:
            self.launches += 1
            if self.launches in self.fail_on:
                raise RuntimeError(f"injected failure of {task.name}")
        return super().execute(task, devices, tid, override_batch_count, window_size)


def _flaky_run(tmp_path, policy, fail_on, **kw):
    tech = Flaky("victim", fail_on)
    tasks = [_task(tmp_path, "victim", batch_count=6), _task(tmp_path, "other", 6)]
    for t in tasks:
        _pin(t, tech, {"remat": False})
    ev = str(tmp_path / f"{policy}.jsonl")
    out = sat.orchestrate(tasks, interval=3.5, topology=SliceTopology(CPU),
                          failure_policy=policy, metrics_path=ev, **kw)
    return out, tech, ev


def test_failure_policy_drop_evicts_the_failed_task(tmp_path):
    out, _, ev = _flaky_run(tmp_path, "drop", fail_on=[1])
    assert out["completed"] == ["other"]
    assert "injected failure of victim" in out["failed"]["victim"]
    assert [e["task"] for e in metrics.read_events(ev, kind="task_failed")] == ["victim"]
    assert not metrics.read_events(ev, kind="health")  # not a training fault


def test_failure_policy_retry_resumes_from_the_checkpoint(tmp_path):
    out, tech, ev = _flaky_run(tmp_path, "retry", fail_on=[2], max_task_retries=1)
    assert sorted(out["completed"]) == ["other", "victim"] and out["failed"] == {}
    assert [e["attempt"] for e in metrics.read_events(ev, kind="task_retry")] == [1]
    runs = [r for r in tech.intervals if r["task"] == "victim"]
    assert runs[1]["restored"]  # the retry restored the last checkpoint
    assert ckpt.load(_task(tmp_path, "victim").ckpt_path)["step"] == 6


def test_failure_policy_raise_reaches_the_caller_through_the_guardian(tmp_path):
    """A launch failure is not the guardian's: it ends the run."""
    with pytest.raises(RuntimeError, match="interval execution failed for task victim"):
        _flaky_run(tmp_path, "raise", fail_on=[1])


# ------------------------------------------------------------------ watchdog
def test_watchdog_abandons_a_wedged_launch_and_its_late_finish(tmp_path, monkeypatch):
    """Past the deadline the engine returns a HungDispatchError; the launch,
    when it finally ends, writes no checkpoint, keeps no state and leaves
    the sentinel carry where it was."""
    t = _task(tmp_path, "wedged", batch_count=2)
    tech = DataParallel()
    _pin(t, tech, {"remat": False})
    release = threading.Event()
    screen = tech._screen

    def slow_screen(*args):
        release.wait(10.0)
        return screen(*args)

    monkeypatch.setattr(tech, "_screen", slow_screen)
    plan = Plan(assignments={"wedged": Assignment(1, Block(0, 1), 0.0, 2.0)},
                makespan=2.0, dependencies={"wedged": []})
    guardian = TrainingGuardian(GuardianConfig(watchdog_floor_s=0.3, watchdog_factor=0.0))
    t0 = time.monotonic()
    errors = engine.execute([t], {"wedged": 2}, 10.0, plan, SliceTopology(CPU),
                            guardian=guardian)
    assert time.monotonic() - t0 < 5.0
    assert isinstance(errors["wedged"], HungDispatchError)
    release.set()
    for th in threading.enumerate():
        if th.name == "launch-wedged":
            th.join(10.0)
    ckpt.flush()
    assert not t.has_ckpt() and t._live_state is None and t.current_batch == 0
    assert t._sentinel_carry is None
