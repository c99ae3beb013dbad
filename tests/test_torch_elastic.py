"""The port's fleet health monitor, topology subset, elastic replanner and
elastic ``orchestrate`` against the JAX package's (the cases of
``tests/test_resilience.py``), on CPU topologies.

- ``FleetHealthMonitor``: the same feed of losses, returns, stragglers and
  step times gives the same ``poll`` sequence, the one-device drill's
  (a loss during an interval, the device back at the next one) included.
- ``SliceTopology.subset``: the same survivors and capacity; base indices
  kept across shrinks.
- ``ElasticReplanner.replan``: the same plan (assignments, makespan),
  evictions, migrations and synthesized sizes under all three policies, on
  synthetic strategies at sizes 1/2/4 of an 8-device topology.
- ``orchestrate`` on a 4-device topology with a fake checkpointing
  technique: a preemption during an interval (a shrink from 4 to 2 that
  migrates a task), a retry budget that preemptions leave untouched, an
  injected crash that retries, a ``SATURN_TPU_FAULTS`` schedule. Each ends
  with the JAX package's per-task outcome (completed, steps, retries) and
  its ``topology_change`` / ``recovery`` / ``migration`` events.

A loss during an interval lands in a fixed order: the fake technique's run
waits (10 s at most) for the timer's ``mark_lost`` before it finishes.

Tolerances: none. Plans, events and steps are compared exactly; starts and
makespans to 1e-9 s.
"""

import json
import os
import threading
import time

import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.core.technique import BaseTechnique as JBaseTechnique
from saturn_tpu.executor import orchestrate as j_orchestrate
from saturn_tpu.resilience import faults as jfaults
from saturn_tpu.resilience import health as jhealth
from saturn_tpu.resilience import replan as jreplan
from saturn_tpu.solver import milp as jmilp
from saturn_tpu.utils.metrics import read_events as j_read_events
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.resilience import faults, health, replan
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.utils.metrics import read_events

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _quiet_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_GROW_HYSTERESIS",
                 "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ monitor
def _change(c):
    return None if c is None else (c.kind, c.lost, c.gained, c.stragglers, c.cause)


def script_shrink_wins(h):
    mon = h.FleetHealthMonitor(8)
    mon.mark_lost([4, 5], cause="slice_preemption")
    mon.mark_restored([4])  # the same window: a net loss of 5 only
    mon.mark_lost([6])
    return [mon.poll(), mon.poll()]


def script_grow_after_return(h):
    mon = h.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([7])
    out = [mon.poll()]
    mon.mark_restored([7])
    return out + [mon.poll(), mon.poll(), mon.alive_indices()]


def script_grow_at_once(h):
    mon = h.FleetHealthMonitor(8, grow_hysteresis=1)
    mon.mark_lost([7])
    out = [mon.poll()]
    mon.mark_restored([7])
    return out + [mon.poll()]


def script_flapping(h):
    mon = h.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([3], cause="slice_preemption")
    out = [mon.poll()]
    for _ in range(4):
        mon.mark_restored([3])
        out.append(mon.poll())
        mon.mark_lost([3])
        out.append(mon.poll())
    mon.mark_restored([3])
    return out + [mon.poll(), mon.poll()]


def script_shrink_flushes_candidates(h):
    mon = h.FleetHealthMonitor(8, grow_hysteresis=3)
    mon.mark_lost([6])
    out = [mon.poll()]
    mon.mark_restored([6])
    out.append(mon.poll())
    mon.mark_lost([1])
    return out + [mon.poll(), mon.poll()]


def script_straggler(h):
    mon = h.FleetHealthMonitor(8, straggler_factor=3.0)
    mon.mark_straggler([2], slowdown=5.0)
    for _ in range(3):
        mon.note_step(list(range(8)), per_batch_s=0.01)
    return [mon.stragglers(), mon.poll()]


def script_one_device_drill(h, hysteresis):
    """The card drill: device 0 lost during interval 1 (the timer), back at
    interval 2's poll, a straggler at interval 3's."""
    mon = h.FleetHealthMonitor(1, grow_hysteresis=hysteresis)
    mon.note_step([0], 0.02)
    out = [mon.poll()]
    mon.mark_lost([0], cause="device_loss")
    out.append(mon.any_lost([0]))
    mon.mark_restored([0])  # interval 2's apply_due, then its poll
    out += [mon.poll(), mon.alive_indices()]
    mon.mark_straggler([0], 4.0)
    mon.note_step([0], 0.02)
    out += [mon.poll(), mon.poll(), mon.stragglers(), mon.max_slowdown([0])]
    return out


def script_restored_forgets(h):
    mon = h.FleetHealthMonitor(2)
    mon.mark_straggler([0], slowdown=9.0)
    mon.note_step([0, 1], 0.01)
    mon.mark_lost([0])
    mon.mark_restored([0])
    return [mon._devices[0].latency_ewma, mon._devices[0].slowdown, mon.any_lost([0, 99])]


SCRIPTS = [script_shrink_wins, script_grow_after_return, script_grow_at_once, script_flapping,
           script_shrink_flushes_candidates, script_straggler, script_restored_forgets,
           lambda h: script_one_device_drill(h, 1), lambda h: script_one_device_drill(h, 2)]


def _plain(out):
    return [_change(x) if isinstance(x, (health.TopologyChange, jhealth.TopologyChange)) or
            x is None else x for x in out]


@pytest.mark.parametrize("script", SCRIPTS, ids=["shrink-wins", "grow-after-return",
                                                 "grow-at-once", "flapping", "shrink-flushes",
                                                 "straggler", "restored-forgets",
                                                 "one-device-h1", "one-device-h2"])
def test_poll_sequence_matches_jax(script):
    assert _plain(script(health)) == _plain(script(jhealth))


def test_one_device_drill_is_a_grow():
    """A loss no poll saw and a return at the next poll cancel into a grow
    (after the hysteresis): the one-card drill's re-plan is a grow, as in
    the JAX package."""
    out = _plain(script_one_device_drill(health, 1))
    assert out[0] is None and out[1] is True
    assert out[2] == ("grow", (), (0,), (), "device_return") and out[3] == [0]
    # one device has no median: a straggler never degrades
    assert out[4] is None and out[6] == [] and out[7] == 4.0
    out = _plain(script_one_device_drill(health, 2))
    assert out[2] is None and out[4] == ("grow", (), (0,), (), "device_return")


def test_grow_hysteresis_env(monkeypatch):
    assert health.FleetHealthMonitor(4).grow_hysteresis == 2
    for raw, want in (("3", 3), ("0", 1)):
        monkeypatch.setenv("SATURN_TPU_GROW_HYSTERESIS", raw)
        assert health.FleetHealthMonitor(4).grow_hysteresis == want
        assert jhealth.FleetHealthMonitor(4).grow_hysteresis == want


def test_topology_change_fields_match_jax():
    c = health.TopologyChange("shrink", lost=(1, 2), gained=(5,), cause="device_loss")
    j = jhealth.TopologyChange("shrink", lost=(1, 2), gained=(5,), cause="device_loss")
    assert c.to_fields() == j.to_fields()


def test_block_indices_follow_the_base_topology():
    base = SliceTopology([CPU] * 8)
    sub = base.subset([1, 3, 4, 5, 6])
    assert health.block_indices(base, Block(4, 4)) == [4, 5, 6, 7]
    assert health.block_indices(sub, Block(0, 2)) == [1, 3]
    assert health.block_indices(sub.subset([2, 3]), Block(0, 2)) == [4, 5]


# ------------------------------------------------------------------- subset
class FakeDev:
    pass


@pytest.mark.parametrize("alive", [[0, 1, 2, 3], [0, 1, 2, 3, 4, 6], [7], [5, 2, 2, 0]])
def test_subset_matches_jax(alive):
    devs = [torch.device("cpu", i) for i in range(8)]
    sub = SliceTopology(devs).subset(alive)
    jsub = JSliceTopology([FakeDev() for _ in range(8)]).subset(alive)
    assert sub.capacity == jsub.capacity and len(sub.devices) == len(jsub.devices)
    assert sub.devices == [devs[i] for i in sorted(set(alive))]
    assert sub.base_indices == sorted(set(alive))


@pytest.mark.parametrize("bad", [[], [0, 8], [-1]])
def test_subset_rejects_bad_indices(bad):
    with pytest.raises(ValueError):
        SliceTopology([CPU] * 8).subset(bad)
    with pytest.raises(ValueError):
        JSliceTopology([FakeDev() for _ in range(8)]).subset(bad)


# ----------------------------------------------------------------- replanner
class FakeTech(BaseTechnique):
    name = "fake"

    def __init__(self, per_batch=0.001):
        self.per_batch = per_batch

    def execute(self, task, devices, tid, override_batch_count=None):
        time.sleep(self.per_batch * (override_batch_count or 1))

    def search(self, task, devices, tid):
        return {}, self.per_batch


class JFakeTech(JBaseTechnique):
    name = "fake"

    def __init__(self, per_batch=0.001):
        self.per_batch = per_batch

    def execute(self, task, devices, tid, override_batch_count=None):
        time.sleep(self.per_batch * (override_batch_count or 1))

    def search(self, task, devices, tid):
        return {}, self.per_batch


class FakeTask:
    def __init__(self, name, total, sizes, tech, strategy_cls, pbt=0.001, hints=None,
                 pbts=None):
        self.name = name
        self.total_batches = total
        self.current_batch = 0
        self.epoch_length = 1000
        self.hints = dict(hints or {})
        pbts = pbts or {}
        self.strategies = {g: strategy_cls(tech, g, {}, pbts.get(g, pbt) * total,
                                           pbts.get(g, pbt)) for g in sizes}
        self.selected_strategy = None
        self.last_feedback_strategy = None
        # no checkpoint: recovery counts the journal's progress
        self.ckpt_path = os.path.join(os.sep, "nonexistent", f"{name}.pt")

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}

    def select_strategy(self, g):
        self.selected_strategy = self.strategies[g]

    def reconfigure(self, n):
        self.current_batch = (self.current_batch + n) % self.epoch_length

    def apply_realized_feedback(self):
        return None

    def release_live_state(self):
        pass

    def release_compiled(self):
        pass


def _pair(specs):
    """The same task table in both packages: (name, total, sizes, pbt, hints, pbts)."""
    tech, jtech = FakeTech(), JFakeTech()
    mine = [FakeTask(n, tot, sizes, tech, Strategy, pbt, hints, pbts)
            for n, tot, sizes, pbt, hints, pbts in specs]
    theirs = [FakeTask(n, tot, sizes, jtech, JStrategy, pbt, hints, pbts)
              for n, tot, sizes, pbt, hints, pbts in specs]
    return mine, theirs


def _prev(pkg_milp, block_cls, slots):
    plan = pkg_milp.Plan(assignments={n: pkg_milp.Assignment(size, block_cls(off, size), st, rt)
                                      for n, (size, off, st, rt) in slots.items()},
                         makespan=max(st + rt for _, _, st, rt in slots.values()))
    plan.compute_dependencies()
    return plan


def _result(res):
    plan = res.plan
    return {"assignments": {n: (a.apportionment, a.block.offset, a.block.size,
                                round(a.start, 9), round(a.runtime, 9))
                            for n, a in sorted(plan.assignments.items())},
            "makespan": round(plan.makespan, 9), "evicted": sorted(res.evicted),
            "synthesized": res.synthesized, "capacity": res.topology.capacity,
            "migrations": {n: {k: d[k] for k in ("moved", "from", "to")}
                           for n, d in sorted(res.migrations.items())}}


REPLAN_CASES = {
    # tasks (name, total, sizes, pbt, hints, per-size pbt), previous plan
    # slots (size, offset, start, runtime), lost devices
    "shrink-synthesizes": (
        [("only4", 50, [4], 0.01, None, None),
         ("both", 50, [1, 2, 4], 0.01, None, {1: 0.04, 2: 0.021, 4: 0.011})],
        {"only4": (4, 0, 0.0, 0.5), "both": (4, 4, 0.0, 0.55)}, [2, 3, 4, 5, 6, 7]),
    "shrink-two-of-three": (
        [("a", 40, [1, 2], 0.02, None, {1: 0.02, 2: 0.011}),
         ("b", 40, [2, 4], 0.02, None, {2: 0.02, 4: 0.012}),
         ("c", 30, [1], 0.03, None, None)],
        {"a": (2, 0, 0.0, 0.44), "b": (4, 4, 0.0, 0.48), "c": (1, 2, 0.0, 0.9)}, [4, 5, 6, 7]),
    "priorities": (
        [("hi", 100, [2], 0.05, {"priority": 10}, None),
         ("lo", 100, [2], 0.05, {"priority": -5}, None),
         ("mid", 60, [1, 2], 0.05, {"priority": 1}, {1: 0.09, 2: 0.05})],
        {"hi": (2, 0, 0.0, 5.0), "lo": (2, 2, 0.0, 5.0), "mid": (2, 4, 0.0, 3.0)},
        [2, 3, 4, 5, 6, 7]),
}


@pytest.mark.parametrize("policy", list(replan.RECOVERY_POLICIES))
@pytest.mark.parametrize("case", list(REPLAN_CASES))
def test_replan_matches_jax(case, policy):
    specs, slots, lost = REPLAN_CASES[case]
    mine, theirs = _pair(specs)
    base, jbase = SliceTopology([CPU] * 8), JSliceTopology([FakeDev() for _ in range(8)])
    mon, jmon = health.FleetHealthMonitor(8), jhealth.FleetHealthMonitor(8)
    mon.mark_lost(lost, cause="slice_preemption")
    jmon.mark_lost(lost, cause="slice_preemption")
    change, jchange = mon.poll(), jmon.poll()
    kw = dict(time_limit=5.0)
    res = replan.ElasticReplanner(policy, degrade_factor=1.2).replan(
        mine, base, mon.alive_indices(), change, previous_plan=_prev(milp, Block, slots), **kw)
    from saturn_tpu.core.mesh import Block as JBlock

    jres = jreplan.ElasticReplanner(policy, degrade_factor=1.2).replan(
        theirs, jbase, jmon.alive_indices(), jchange,
        previous_plan=_prev(jmilp, JBlock, slots), **kw)
    assert _result(res) == _result(jres)
    for t, jt in zip(mine, theirs):
        assert sorted(t.strategies) == sorted(jt.strategies)
        for g, s in t.strategies.items():
            assert s.interpolated == jt.strategies[g].interpolated
            assert s.per_batch_time == pytest.approx(jt.strategies[g].per_batch_time, abs=1e-12)


def test_replan_cases_exercise_each_path():
    specs, slots, lost = REPLAN_CASES["shrink-synthesizes"]
    mine, _ = _pair(specs)
    base = SliceTopology([CPU] * 8)
    mon = health.FleetHealthMonitor(8)
    mon.mark_lost(lost)
    res = replan.ElasticReplanner().replan(mine, base, mon.alive_indices(), mon.poll(),
                                           previous_plan=_prev(milp, Block, slots))
    assert res.topology.capacity == 2 and res.synthesized == {"only4": [2]}
    assert mine[0].strategies[2].interpolated and res.evicted == []
    assert any(d["moved"] for d in res.migrations.values())
    specs, slots, lost = REPLAN_CASES["priorities"]
    mine, _ = _pair(specs)
    mon = health.FleetHealthMonitor(8)
    mon.mark_lost(lost)
    res = replan.ElasticReplanner("evict-lowest-priority", degrade_factor=1.2).replan(
        mine, base, mon.alive_indices(), mon.poll(), previous_plan=_prev(milp, Block, slots))
    assert "lo" in res.evicted and "hi" in res.plan.assignments


def test_degrade_in_place_runs_no_solver(monkeypatch):
    from saturn_tpu_torch.solver import anytime

    def boom(*a, **kw):
        raise AssertionError("solver invoked under degrade-in-place")

    monkeypatch.setattr(anytime, "anytime_resolve", boom)
    specs, slots, lost = REPLAN_CASES["shrink-two-of-three"]
    mine, _ = _pair(specs)
    mon = health.FleetHealthMonitor(8)
    mon.mark_lost(lost)
    res = replan.ElasticReplanner("degrade-in-place").replan(
        mine, SliceTopology([CPU] * 8), mon.alive_indices(), mon.poll(),
        previous_plan=_prev(milp, Block, slots))
    assert set(res.plan.assignments) == {"a", "b", "c"}
    assert all(a.block.end <= 4 for a in res.plan.assignments.values())


def test_unschedulable_task_evicted_and_unknown_policy():
    mine, _ = _pair([("dead", 10, [8], 0.01, None, None), ("ok", 10, [4], 0.01, None, None)])
    mine[0].strategies[8].per_batch_time = 0.0  # no measured point: nothing to fit
    mon = health.FleetHealthMonitor(8)
    mon.mark_lost([4, 5, 6, 7])
    res = replan.ElasticReplanner().replan(mine, SliceTopology([CPU] * 8),
                                           mon.alive_indices(), mon.poll())
    assert res.evicted == ["dead"] and set(res.plan.assignments) == {"ok"}
    with pytest.raises(ValueError, match="unknown recovery policy"):
        replan.ElasticReplanner(policy="wing-it")
    with pytest.raises(ValueError, match="unknown recovery policy"):
        replan.get_policy("wing-it")


def test_static_screen_gates_the_destination():
    """A task whose technique's static screen refuses every fitting size is
    evicted (memlens's place in the JAX package); a screen that cannot tell
    lets it through."""
    class Screened(FakeTech):
        def __init__(self, verdict):
            super().__init__()
            self.verdict = verdict

        def _static_screen(self, task, devices, config):
            return self.verdict

    for verdict, evicted in ((False, ["a"]), (True, [])):
        t = FakeTask("a", 10, [1, 2], Screened(verdict), Strategy, 0.01)
        mon = health.FleetHealthMonitor(4)
        mon.mark_lost([2, 3])
        res = replan.ElasticReplanner().replan([t], SliceTopology([CPU] * 4),
                                               mon.alive_indices(), mon.poll())
        assert res.evicted == evicted


def test_fit_scaling_model_matches_jax():
    from saturn_tpu.trial_runner.evaluator import _fit_scaling_model as jfit
    from saturn_tpu_torch.trial_runner.evaluator import _fit_scaling_model as fit

    for pts in ([(1, 0.04), (2, 0.021), (4, 0.011)], [(2, 0.02), (4, 0.03)],
                [(1, 0.01), (8, 0.0001)], [(2, 0.5), (4, 0.25)]):
        for g in (1, 2, 4, 8):
            assert fit(pts)(g) == pytest.approx(jfit(pts)(g), rel=1e-12, abs=1e-15)


def test_realized_feedback_clears_interpolated(tmp_path):
    from saturn_tpu_torch.executor import orchestrator

    t = sat.Task(get_model=lambda **kw: None, get_dataloader=lambda: [0] * 4,
                 loss_fn=None, hparams=sat.HParams(batch_count=4), name="i",
                 save_dir=str(tmp_path))
    s = Strategy(FakeTech(), 1, {}, 0.4, 0.1, interpolated=True, cache_key="k",
                 cache_dir=str(tmp_path / "cache"))
    t.strategies = {1: s}
    t.select_strategy(1)
    t.last_feedback_strategy = s
    orchestrator._persist_realized(t)  # an estimate is not written
    assert not os.path.isdir(tmp_path / "cache") or not os.listdir(tmp_path / "cache")
    t.note_realized_per_batch(0.2)
    assert t.apply_realized_feedback() is not None and not s.interpolated
    orchestrator._persist_realized(t)
    assert os.listdir(tmp_path / "cache")


@pytest.mark.parametrize("priors", [(True, True), (True, False), (False, False)])
def test_static_prior_through_replan_solve_and_feedback_matches_jax(tmp_path, priors):
    """``Strategy.static_prior``: a size the replanner synthesizes from
    priors alone is a prior, the anytime report counts the plan's priors
    (``n_static_prior``), and the first realized interval clears the flag;
    the same in both packages."""
    from saturn_tpu import HParams as JHParams, Task as JTask
    from saturn_tpu.solver import anytime as janytime
    from saturn_tpu_torch.solver import anytime

    pkgs = {
        "torch": (Strategy, FakeTech(), replan.ElasticReplanner(), anytime, sat.Task,
                  sat.HParams, lambda n: SliceTopology([torch.device("cpu")] * n)),
        "jax": (JStrategy, JFakeTech(), jreplan.ElasticReplanner(), janytime, JTask, JHParams,
                lambda n: JSliceTopology([object() for _ in range(n)])),
    }
    out = {}
    for key, (strat_cls, tech, replanner, any_mod, task_cls, hp_cls, topo) in pkgs.items():
        t = FakeTask("sp", 40, [2, 4], tech, strat_cls, pbts={2: 0.02, 4: 0.011})
        for g, flag in zip((2, 4), priors):
            t.strategies[g].static_prior = flag
        added = replanner._synthesize(t, 1)
        syn = t.strategies[1]
        other = FakeTask("measured", 40, [2], tech, strat_cls)
        _plan, report = any_mod.anytime_solve([t, other], topo(4), 5.0)
        counted = sum(t.strategies[a.apportionment].static_prior
                      for n, a in _plan.assignments.items() if n == "sp")
        real = task_cls(get_model=lambda **kw: None, get_dataloader=lambda: [0] * 4,
                        loss_fn=None, hparams=hp_cls(batch_count=4), name="fb",
                        save_dir=str(tmp_path / key))
        s = strat_cls(tech, 1, {}, 0.4, 0.1, static_prior=True)
        real.strategies = {1: s}
        real.select_strategy(1)
        real.note_realized_per_batch(0.2)
        real.apply_realized_feedback()
        out[key] = (added, syn.static_prior, syn.interpolated, syn.per_batch_time,
                    report.n_static_prior, counted, s.static_prior)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == all(priors) and out["torch"][2]
    assert out["torch"][4] == out["torch"][5] and out["torch"][6] is False


# --------------------------------------------------------------- orchestrate
class Run:
    """What one package needs for a fake elastic run: the count of losses
    the held runs wait for, and the monitors that saw a loss."""

    def __init__(self):
        self.cond = threading.Condition()
        self.n_lost = 0
        self.monitors = []

    def wait_losses(self, n: int) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: self.n_lost >= n, timeout=10.0)


@pytest.fixture
def runs(monkeypatch):
    """Both packages' ``mark_lost`` also set the run's event (a timer's
    loss wakes the held fake run)."""
    out = {"torch": Run(), "jax": Run()}
    for key, cls in (("torch", health.FleetHealthMonitor), ("jax", jhealth.FleetHealthMonitor)):
        orig = cls.mark_lost

        def mark_lost(self, idx, cause="device_loss", orig=orig, run=out[key]):
            orig(self, idx, cause=cause)
            with run.cond:
                run.monitors.append(self)
                run.n_lost += 1
                run.cond.notify_all()

        monkeypatch.setattr(cls, "mark_lost", mark_lost)
    return out


def _make_ckpt_tech(base_cls, pkg, run, ckpt_dir, per_batch, hold):
    class CheckpointingTech(base_cls):
        """Progress in a JSON file per task, written only when the interval
        stands. A held run (``hold``: task -> {its execute call, counted
        from 1: the losses it waits for}) waits for that many losses before
        it ends; then the block's loss discards it: through the port
        engine's publish gate, or as the JAX package's fake raises."""

        name = "ckpt-fake"

        def __init__(self):
            self.calls = []
            self.count = {}
            self.lock = threading.Lock()

        def execute(self, task, devices, tid, override_batch_count=None):
            path = os.path.join(ckpt_dir, f"{task.name}.json")
            step = json.load(open(path))["step"] if os.path.exists(path) else 0
            with self.lock:
                self.count[task.name] = k = self.count.get(task.name, 0) + 1
                self.calls.append((task.name, len(devices), step))
            n = override_batch_count or 1
            time.sleep(per_batch * n)
            need = hold.get(task.name, {}).get(k)
            if need is not None:
                assert run.wait_losses(need), "the held run saw no loss"
            if pkg == "torch":
                gate = getattr(task, "_publish_gate", None)
                if gate is not None:
                    gate()
            else:
                for mon in run.monitors[-1:]:
                    didx = mon.indices_of(devices) or list(range(
                        task._block.offset, task._block.end))
                    if mon.any_lost(didx):
                        raise jfaults.PreemptedError(f"{task.name}: block lost a device")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step + n}, f)
            os.replace(tmp, path)

        def search(self, task, devices, tid):
            return {}, per_batch

    return CheckpointingTech()


class BlockTask(FakeTask):
    """A fake task that remembers the block of its selected strategy's
    assignment (the JAX fake maps an unbound monitor's indices from it)."""


def _run_both(tmp_path, runs, specs, schedule=None, env=None, hold=None, interval=0.25,
              per_batch=0.01, n_devices=4, policy="retry", max_task_retries=1,
              monkeypatch=None, crash_tech=None):
    out = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        ckpt_dir = str(d / "ckpts")
        os.makedirs(ckpt_dir)
        if crash_tech is not None:
            tech = crash_tech(pkg)
        else:
            tech = _make_ckpt_tech(BaseTechnique if pkg == "torch" else JBaseTechnique, pkg,
                                   runs[pkg], ckpt_dir, per_batch, hold or {})
        strat = Strategy if pkg == "torch" else JStrategy
        tasks = [BlockTask(n, tot, sizes, tech, strat, pbt=per_batch, pbts=pbts)
                 for n, tot, sizes, *rest in specs for pbts in (rest[0] if rest else None,)]
        mpath = str(d / "m.jsonl")
        kw = dict(interval=interval, failure_policy=policy, max_task_retries=max_task_retries,
                  metrics_path=mpath, solver_time_limit=2.0)
        if env is not None:
            monkeypatch.setenv("SATURN_TPU_FAULTS", env)
        if pkg == "torch":
            topo = SliceTopology([CPU] * n_devices)
            inj = faults.FaultInjector(schedule=schedule(faults)) if schedule else None
            res = sat.orchestrate(tasks, topology=topo, fault_injector=inj, fusion=False, **kw)
            events = read_events(mpath)
        else:
            topo = JSliceTopology([FakeDev() for _ in range(n_devices)])
            inj = jfaults.FaultInjector(schedule=schedule(jfaults)) if schedule else None
            res = j_orchestrate(tasks, topology=topo, fault_injector=inj, **kw)
            events = j_read_events(mpath)
        if env is not None:
            monkeypatch.delenv("SATURN_TPU_FAULTS")
        steps = {}
        for t in tasks:
            p = os.path.join(ckpt_dir, f"{t.name}.json")
            steps[t.name] = json.load(open(p))["step"] if os.path.exists(p) else None
        out[pkg] = {"completed": sorted(res["completed"]), "failed": sorted(res["failed"]),
                    "steps": steps, "events": events, "tech": tech}
    return out


def _kinds(events, kind, keys):
    return [{k: e.get(k) for k in keys} for e in events if e["kind"] == kind]


def _retries(events):
    out = {}
    for e in events:
        if e["kind"] == "task_retry":
            out[e["task"]] = out.get(e["task"], 0) + 1
    return out


def _outcome(r):
    ev = r["events"]
    return {"completed": r["completed"], "failed": r["failed"], "steps": r["steps"],
            "retries": _retries(ev),
            "preempted": sorted(e["task"] for e in ev if e["kind"] == "task_preempted"),
            "topology_change": _kinds(ev, "topology_change",
                                      ("change", "lost", "gained", "stragglers", "cause")),
            "recovery": _kinds(ev, "recovery", ("policy", "capacity", "n_tasks")),
            "migration": _kinds(ev, "migration", ("task", "moved_from", "moved_to"))}


@pytest.fixture
def pin_blocks(monkeypatch):
    """Record each fake task's executed block on the task for the JAX fake."""
    from saturn_tpu.executor import engine as jengine

    orig = jengine.execute

    def execute(run_tasks, batches, interval, plan, topology, *a, **kw):
        for t in run_tasks:
            t._block = plan.assignments[t.name].block
        return orig(run_tasks, batches, interval, plan, topology, *a, **kw)

    monkeypatch.setattr(jengine, "execute", execute)


def test_preemption_mid_interval_shrinks_and_migrates(tmp_path, runs, pin_blocks):
    """Two tasks on two blocks of 2 of a 4-device topology; the block of
    the second loses its devices during interval 1 (its run waits for the
    loss, then is discarded and requeued); the next poll shrinks to 2
    devices and the re-plan migrates it there. Both end at their total."""
    def schedule(p):
        return [p.FaultEvent(1, p.FaultKind.SLICE_PREEMPTION, devices=(2, 3), after_s=0.05)]

    specs = [("job0", 30, [2]), ("job1", 30, [2])]

    # which task holds [2:4] is the solver's choice: hold both second calls,
    # the one on the surviving block is released by the loss all the same
    out = _run_both(tmp_path, runs, specs, schedule=schedule,
                    hold={"job0": {2: 1}, "job1": {2: 1}})
    got, want = _outcome(out["torch"]), _outcome(out["jax"])
    assert got == want
    assert got["completed"] == ["job0", "job1"] and got["failed"] == []
    assert got["steps"] == {"job0": 30, "job1": 30} and got["retries"] == {}
    assert len(got["preempted"]) == 1
    assert got["topology_change"] == [{"change": "shrink", "lost": [2, 3], "gained": [],
                                       "stragglers": [], "cause": "slice_preemption"}]
    assert got["recovery"] == [{"policy": "pause-resolve-resume", "capacity": 2, "n_tasks": 1}]
    assert [m["task"] for m in got["migration"]] == got["preempted"]
    assert got["migration"][0]["moved_from"] == [2, 2] and got["migration"][0]["moved_to"][0] == 2
    replans = [e for e in out["torch"]["events"] if e["kind"] == "replan"]
    assert len(replans) == 1 and replans[0]["migrated"] == got["preempted"]


def test_preemption_does_not_consume_retry_budget(tmp_path, runs, pin_blocks):
    """One task preempted in two intervals running (on 4 devices, then on
    2 of the 3 left) still has its budget of no retries: it completes."""
    def schedule(p):
        return [p.FaultEvent(0, p.FaultKind.DEVICE_LOSS, devices=(3,), after_s=0.05),
                p.FaultEvent(1, p.FaultKind.DEVICE_LOSS, devices=(1,), after_s=0.05)]

    out = _run_both(tmp_path, runs, [("solo", 40, [2, 4], {2: 0.01, 4: 0.005})],
                    schedule=schedule, hold={"solo": {1: 1, 2: 2}}, interval=0.4,
                    max_task_retries=0)
    got, want = _outcome(out["torch"]), _outcome(out["jax"])
    assert got == want
    assert got["completed"] == ["solo"] and got["steps"] == {"solo": 40}
    assert got["retries"] == {} and got["preempted"] == ["solo", "solo"]
    assert [c["lost"] for c in got["topology_change"]] == [[3], [1]]
    assert not [e for e in out["torch"]["events"] if e["kind"] == "task_failed"]


def test_injected_trial_crash_retries(tmp_path, runs):
    def schedule(p):
        return [p.FaultEvent(0, p.FaultKind.TRIAL_CRASH, task="crashy")]

    def tech(pkg):
        return (FakeTech if pkg == "torch" else JFakeTech)(per_batch=0.005)

    out = _run_both(tmp_path, runs, [("crashy", 20, [2, 4])], schedule=schedule,
                    interval=0.5, per_batch=0.005, crash_tech=tech)
    got, want = _outcome(out["torch"]), _outcome(out["jax"])
    assert got == want
    assert got["completed"] == ["crashy"] and got["retries"] == {"crashy": 1}
    msg = [e["error"] for e in out["torch"]["events"] if e["kind"] == "task_retry"]
    assert len(msg) == 1 and "injected transient" in msg[0]


def test_env_schedule_drives_the_run(tmp_path, runs, pin_blocks, monkeypatch):
    """SATURN_TPU_FAULTS alone, with no injector passed, makes the run
    elastic in both packages."""
    out = _run_both(tmp_path, runs, [("e0", 30, [2]), ("e1", 30, [2])],
                    env="0+0.05:slice_preemption:2-3", hold={"e0": {1: 1}, "e1": {1: 1}},
                    interval=0.15, monkeypatch=monkeypatch)
    got, want = _outcome(out["torch"]), _outcome(out["jax"])
    assert got == want
    assert got["completed"] == ["e0", "e1"] and got["steps"] == {"e0": 30, "e1": 30}
    assert got["topology_change"][0]["lost"] == [2, 3]


def test_unknown_recovery_policy_raises(tmp_path):
    t = FakeTask("a", 4, [1], FakeTech(), Strategy)
    topo = SliceTopology([CPU])
    with pytest.raises(ValueError, match="unknown recovery policy"):
        sat.orchestrate([t], topology=topo, recovery_policy="bogus",
                        fault_injector=faults.FaultInjector())
    jt = FakeTask("a", 4, [1], JFakeTech(), JStrategy)
    with pytest.raises(ValueError, match="unknown recovery policy"):
        j_orchestrate([jt], topology=JSliceTopology([FakeDev()]), recovery_policy="bogus",
                      fault_injector=jfaults.FaultInjector())
    # the port checks the name on every call; the JAX package only when elastic
    with pytest.raises(ValueError, match="unknown recovery policy"):
        sat.orchestrate([t], topology=topo, recovery_policy="bogus")


# ------------------------------------------------------------------- journal
def test_grow_and_drain_records_are_the_jax_bytes(tmp_path, monkeypatch):
    """With the clock pinned, the port's journal encodes ``grow_event`` and
    ``backlog_drain`` (the fields the orchestrator logs) byte for byte as
    the JAX package's journal does."""
    from saturn_tpu import durability as jdur
    from saturn_tpu_torch import durability as dur

    monkeypatch.setattr(time, "time", lambda: 1754390400.1234567)
    for name, mod in (("torch", dur), ("jax", jdur)):
        j = mod.Journal(str(tmp_path / name))
        j.log("grow_event", interval=2, gained=[0], cause="device_return", n_parked=1,
              capacity=1)
        j.log("backlog_drain", interval=2, jobs=["a", "b"], trigger="grow")
        j.append("health_unbench", tasks=["a", "b"], cause="grow")
        j.close()
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _faulting_tech(pkg, victim):
    """Sleeps per batch; the victim's first run raises the package's
    NumericFaultError (a training fault the guardian parks)."""
    if pkg == "torch":
        from saturn_tpu_torch.health import NumericFaultError
        base = BaseTechnique
    else:
        from saturn_tpu.health import NumericFaultError
        base = JBaseTechnique

    class Faulting(base):
        name = "faulting"

        def __init__(self):
            self.calls = {}

        def execute(self, task, devices, tid, override_batch_count=None):
            self.calls[task.name] = self.calls.get(task.name, 0) + 1
            time.sleep(0.005 * (override_batch_count or 1))
            if task.name == victim and self.calls[task.name] == 1:
                raise NumericFaultError(task.name, 0, "nonfinite", step=0,
                                        loss=float("nan"), batch_indices=(0,), bad_count=1)

        def search(self, task, devices, tid):
            return {}, 0.005

    return Faulting()


def test_grow_drains_the_parked_backlog_as_jax_does(tmp_path, monkeypatch):
    """Two tasks on two devices: device 1 lost at interval 0's poll (shrink
    to one device), task ``a`` faults and is parked; device 1 back at
    interval 1's poll (a grow at once, hysteresis 1) re-admits ``a`` ahead
    of its backoff. The journal's ``grow_event`` and ``backlog_drain`` hold
    the JAX package's fields; both journals replay strictly."""
    from saturn_tpu import durability as jdur
    from saturn_tpu_torch import durability as dur

    monkeypatch.setenv("SATURN_TPU_GROW_HYSTERESIS", "1")
    records, outcome = {}, {}
    for pkg in ("torch", "jax"):
        fp = faults if pkg == "torch" else jfaults
        inj = fp.FaultInjector(schedule=[
            fp.FaultEvent(0, fp.FaultKind.DEVICE_LOSS, devices=(1,)),
            fp.FaultEvent(1, fp.FaultKind.DEVICE_RETURN, devices=(1,))])
        tech = _faulting_tech(pkg, "a")
        strat = Strategy if pkg == "torch" else JStrategy
        tasks = [FakeTask("a", 20, [1], tech, strat, 0.005),
                 FakeTask("b", 40, [1], tech, strat, 0.005)]
        os.makedirs(tmp_path / pkg)
        root = str(tmp_path / pkg / "wal")
        mpath = str(tmp_path / pkg / "m.jsonl")
        kw = dict(interval=0.1, resume_dir=root, fault_injector=inj, metrics_path=mpath,
                  solver_time_limit=1.0)
        if pkg == "torch":
            out = sat.orchestrate(tasks, topology=SliceTopology([CPU] * 2), fusion=False, **kw)
            recs = dur.replay(root, strict=True)
            assert recs == jdur.replay(root, strict=True)
            events = read_events(mpath)
        else:
            out = j_orchestrate(tasks, topology=JSliceTopology([FakeDev(), FakeDev()]), **kw)
            recs = jdur.replay(root, strict=True)
            events = j_read_events(mpath)
        records[pkg] = [(r["kind"], r["data"]) for r in recs
                        if r["kind"] in ("grow_event", "backlog_drain", "health_unbench")]
        outcome[pkg] = (sorted(out["completed"]), out["failed"],
                        _kinds(events, "topology_change", ("change", "lost", "gained")),
                        _kinds(events, "backlog_drain", ("interval", "jobs", "trigger")))
    assert records["torch"] == records["jax"]
    assert records["torch"] == [
        ("grow_event", {"interval": 1, "gained": [1], "cause": "device_return", "n_parked": 1,
                        "capacity": 2}),
        ("health_unbench", {"tasks": ["a"], "cause": "grow"}),
        ("backlog_drain", {"interval": 1, "jobs": ["a"], "trigger": "grow"})]
    assert outcome["torch"] == outcome["jax"]
    assert outcome["torch"][0] == ["a", "b"]
    assert [c["change"] for c in outcome["torch"][2]] == ["shrink", "grow"]


def test_a_preempted_run_journal_replays_strictly(tmp_path, runs, pin_blocks):
    """A journaled run with a preemption during an interval: both packages
    replay its journal strictly, and it counts each task's batches once
    (the discarded run journals no progress)."""
    from saturn_tpu import durability as jdur
    from saturn_tpu_torch import durability as dur

    root = str(tmp_path / "wal")
    ckpt_dir = str(tmp_path / "ckpts")
    os.makedirs(ckpt_dir)
    tech = _make_ckpt_tech(BaseTechnique, "torch", runs["torch"], ckpt_dir, 0.01,
                           {"job0": {2: 1}, "job1": {2: 1}})
    tasks = [BlockTask(n, 30, [2], tech, Strategy, pbt=0.01) for n in ("job0", "job1")]
    inj = faults.FaultInjector(schedule=[faults.FaultEvent(
        1, faults.FaultKind.SLICE_PREEMPTION, devices=(2, 3), after_s=0.05)])
    out = sat.orchestrate(tasks, interval=0.25, topology=SliceTopology([CPU] * 4),
                          fault_injector=inj, resume_dir=root, fusion=False,
                          solver_time_limit=2.0)
    assert sorted(out["completed"]) == ["job0", "job1"]
    recs = dur.replay(root, strict=True)
    assert recs == jdur.replay(root, strict=True)
    assert dur.replay_batch_state(root).progress == {"job0": 30, "job1": 30}
    assert jdur.replay_batch_state(root).progress == {"job0": 30, "job1": 30}


# ------------------------------------------------------------------ watchdog
def test_watchdog_clock_starts_at_each_launch(tmp_path):
    """Two tasks on one block, the second after the first, whose injected
    dispatch stall outlasts its deadline: the first is abandoned, and the
    second, released by that, runs to its end under a deadline counted from
    its own launch. The JAX package counts every deadline from the
    interval's start and would abandon the second with the first (queue 3
    of ROADMAP.md). The stalled launcher is joined (10 s at most)."""
    from saturn_tpu_torch.executor import engine
    from saturn_tpu_torch.health import GuardianConfig, HungDispatchError, TrainingGuardian

    tech = FakeTech(per_batch=0.05)  # the second's run: 4 x 0.05 s, past the join's poll
    tasks = [FakeTask(n, 4, [1], tech, Strategy, pbt=0.05) for n in ("first", "second")]
    plan = milp.Plan(assignments={"first": milp.Assignment(1, Block(0, 1), 0.0, 0.2),
                                  "second": milp.Assignment(1, Block(0, 1), 0.2, 0.4)},
                     makespan=0.4, dependencies={"first": [], "second": ["first"]})
    inj = faults.FaultInjector(schedule=[faults.FaultEvent(
        0, faults.FaultKind.DISPATCH_STALL, task="first", stall_s=3.0)])
    guardian = TrainingGuardian(GuardianConfig(watchdog_floor_s=1.0, watchdog_factor=0.0))
    done = []
    errors = engine.execute(tasks, {"first": 4, "second": 4}, 0.4, plan,
                            SliceTopology([CPU]), failure_policy="drop", guardian=guardian,
                            on_task_done=lambda n, k: done.append((n, k)), faults=inj)
    for th in threading.enumerate():
        if th.name == "launch-first":
            th.join(10.0)
    assert sorted(errors) == ["first"]
    assert isinstance(errors["first"], HungDispatchError)
    assert done == [("second", 4)]
    assert [t.current_batch for t in tasks] == [0, 4]
