"""The elastic run with the port's real dp on multi-device blocks, against
the JAX package's elastic run (the fake checkpointing technique of
``tests/test_resilience.py``) on the same seeded schedule.

Each case trains ``test-tiny`` with the port's dp on ``[cpu] * n`` (one
replica per position) and the same task table through the JAX package's
``orchestrate`` with a fake that keeps its progress in a JSON file. Both
runs draw their faults from their package's ``seeded_schedule`` with the
same seed and shape (the schedules are asserted equal):

- a ``slice_preemption`` of a 2-device block of a 4-device pool during
  interval 1: the task on it is discarded, the pool shrinks to 2, and the
  re-plan migrates it to the surviving block;
- the same loss under one task that ran on all 4 devices: a loss with no
  return, the pool shrinks from 4 to 2 and the task moves to a block of 2,
  restoring its 4-replica checkpoint onto 2 replicas;
- ``slice_preemption`` of position 1 of a 2-device pool, with no return:
  the task's only profiled size is 2, the replanner synthesizes size 1,
  and the task restores onto one replica.

A held run waits (10 s at most) for the timer's loss before it runs, so
the loss lands during its interval in both packages. The seeds draw the
loss 0.128 s (seed 110) and 0.165 s (seed 27) into interval 1, after every
launcher has reached its run: a loss before a launch aborts every launch
of the interval in the port's engine (``crash_or_preempt``), which no
timing of the JAX fake reproduces. The per-batch times
of the strategies are fixed (the port's realized feedback is left out:
the JAX fake reports none), so both solvers see the same table.

Compared exactly: completed and failed tasks, final steps (the port's
checkpoint, the fake's file), retries, preempted tasks, and the
``topology_change``, ``recovery``, ``migration`` and ``replan``
(``synthesized``) events. The port's run also keeps its replicas bitwise
equal and ends with a checkpoint at the full budget.
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
from saturn_tpu.executor import engine as jengine
from saturn_tpu.executor import orchestrate as j_orchestrate
from saturn_tpu.resilience import faults as jfaults
from saturn_tpu.resilience import health as jhealth
from saturn_tpu.utils.metrics import read_events as j_read_events
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.spmd_base import replicas
from saturn_tpu_torch.resilience import faults, health
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils.metrics import read_events

CPU = torch.device("cpu")
PER_BATCH = 0.05


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_GROW_HYSTERESIS",
                 "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Losses:
    def __init__(self):
        self.cond, self.n, self.monitors = threading.Condition(), 0, []

    def wait(self, n: int) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: self.n >= n, timeout=10.0)


@pytest.fixture
def losses(monkeypatch):
    """Each package's ``mark_lost`` also counts the loss for the held runs."""
    out = {"torch": Losses(), "jax": Losses()}
    for key, cls in (("torch", health.FleetHealthMonitor), ("jax", jhealth.FleetHealthMonitor)):
        orig = cls.mark_lost

        def mark_lost(self, idx, cause="device_loss", orig=orig, seen=out[key]):
            orig(self, idx, cause=cause)
            with seen.cond:
                seen.monitors.append(self)
                seen.n += 1
                seen.cond.notify_all()

        monkeypatch.setattr(cls, "mark_lost", mark_lost)
    orig_execute = jengine.execute

    def execute(run_tasks, batches, interval, plan, topology, *a, **kw):
        for t in run_tasks:
            t._block = plan.assignments[t.name].block
        return orig_execute(run_tasks, batches, interval, plan, topology, *a, **kw)

    monkeypatch.setattr(jengine, "execute", execute)
    return out


class HeldDP(DataParallel):
    """The port's dp; a held call (``hold``: task -> {its execute call,
    counted from 1: the losses it waits for}) waits for the loss first."""

    def __init__(self, seen=None, hold=None):
        super().__init__()
        self.seen, self.hold = seen, hold or {}
        self.calls, self.count, self.lock = [], {}, threading.Lock()

    def execute(self, task, devices, tid, override_batch_count=None, window_size=None):
        with self.lock:
            self.count[task.name] = k = self.count.get(task.name, 0) + 1
            self.calls.append((task.name, len(devices)))
        need = self.hold.get(task.name, {}).get(k)
        if need is not None:
            assert self.seen.wait(need), "the held run saw no loss"
        super().execute(task, devices, tid, override_batch_count, window_size)
        live = task._live_state
        if live is not None:
            reps = replicas(live[1])
            assert len(reps) == len(devices)
            for rep in reps[1:]:
                for a, b in zip(reps[0]["params"].parameters(), rep["params"].parameters()):
                    assert torch.equal(a, b)


def _fake_tech(seen, ckpt_dir, hold):
    class JCheckpointingTech(JBaseTechnique):
        name = "ckpt-fake"

        def __init__(self):
            self.calls, self.count, self.lock = [], {}, threading.Lock()

        def execute(self, task, devices, tid, override_batch_count=None):
            path = os.path.join(ckpt_dir, f"{task.name}.json")
            step = json.load(open(path))["step"] if os.path.exists(path) else 0
            with self.lock:
                self.count[task.name] = k = self.count.get(task.name, 0) + 1
                self.calls.append((task.name, len(devices)))
            n = override_batch_count or 1
            need = hold.get(task.name, {}).get(k)
            if need is not None:
                assert seen.wait(need), "the held run saw no loss"
            time.sleep(PER_BATCH * n / 10)
            for mon in seen.monitors[-1:]:
                didx = mon.indices_of(devices) or list(range(task._block.offset,
                                                             task._block.end))
                if mon.any_lost(didx):
                    raise jfaults.PreemptedError(f"{task.name}: block lost a device")
            with open(path + ".tmp", "w") as f:
                json.dump({"step": step + n}, f)
            os.replace(path + ".tmp", path)

        def search(self, task, devices, tid):
            return {}, PER_BATCH

    return JCheckpointingTech()


class JFakeTask:
    def __init__(self, name, total, pbts, tech):
        self.name, self.total_batches, self.current_batch = name, total, 0
        self.epoch_length, self.hints = 1000, {}
        self.strategies = {g: JStrategy(tech, g, {}, t * total, t) for g, t in pbts.items()}
        self.selected_strategy = self.last_feedback_strategy = None
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


def _port_task(name, total, pbts, tech, save_dir):
    task = Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4,
                                                       vocab_size=256, n_tokens=64 * 4 * 16),
                loss_fn=pretraining_loss,
                hparams=HParams(lr=1e-3, batch_count=total, kwargs={"dtype": torch.float32}),
                name=name, save_dir=save_dir)
    task.strategies = {g: Strategy(tech, g, {"remat": False}, t * total, t)
                       for g, t in pbts.items()}
    # the strategies' times stay as given: the JAX fake realizes none
    task.apply_realized_feedback = lambda: None
    return task


def _outcome(events, completed, failed, steps):
    def kinds(kind, keys):
        return [{k: e.get(k) for k in keys} for e in events if e["kind"] == kind]

    retries = {}
    for e in events:
        if e["kind"] == "task_retry":
            retries[e["task"]] = retries.get(e["task"], 0) + 1
    return {"completed": sorted(completed), "failed": sorted(failed), "steps": steps,
            "retries": retries,
            "preempted": sorted(e["task"] for e in events if e["kind"] == "task_preempted"),
            "topology_change": kinds("topology_change",
                                     ("change", "lost", "gained", "stragglers", "cause")),
            "recovery": kinds("recovery", ("policy", "capacity", "n_tasks")),
            "migration": kinds("migration", ("task", "moved_from", "moved_to")),
            "synthesized": [e.get("synthesized") for e in events if e["kind"] == "replan"]}


def _run_both(tmp_path, losses, specs, n_devices, seed, hold, interval):
    """``specs``: (name, total, {size: per-batch s}). The schedule is each
    package's ``seeded_schedule(seed, 3, n_devices)`` with preemptions only."""
    draw = dict(p_preempt=0.5, p_crash=0.0, p_straggler=0.0)
    schedules = {"torch": faults.seeded_schedule(seed, 3, n_devices, **draw),
                 "jax": jfaults.seeded_schedule(seed, 3, n_devices, **draw)}
    assert [(e.at_interval, e.kind, e.devices, e.after_s) for e in schedules["torch"]] == [
        (e.at_interval, e.kind, e.devices, e.after_s) for e in schedules["jax"]]
    out = {}
    kw = dict(interval=interval, failure_policy="retry", max_task_retries=1,
              solver_time_limit=2.0)
    # the port
    d = tmp_path / "torch"
    tech = HeldDP(losses["torch"], hold)
    tasks = [_port_task(n, tot, pbts, tech, str(d / "ckpts")) for n, tot, pbts in specs]
    mpath = str(d / "m.jsonl")
    res = sat.orchestrate(tasks, topology=SliceTopology([CPU] * n_devices), fusion=False,
                          fault_injector=faults.FaultInjector(schedule=schedules["torch"]),
                          metrics_path=mpath, **kw)
    steps = {t.name: ckpt.load(t.ckpt_path)["step"] for t in tasks}
    out["torch"] = _outcome(read_events(mpath), res["completed"], res["failed"], steps)
    out["torch_calls"] = tech.calls
    out["torch_restored"] = [(r["task"], r["restored"]) for r in tech.intervals]
    for t in tasks:
        t.release_live_state()
    # the JAX package
    d = tmp_path / "jax"
    os.makedirs(d / "ckpts")
    jtech = _fake_tech(losses["jax"], str(d / "ckpts"), hold)
    jtasks = [JFakeTask(n, tot, pbts, jtech) for n, tot, pbts in specs]
    mpath = str(d / "m.jsonl")
    res = j_orchestrate(jtasks, topology=JSliceTopology([object() for _ in range(n_devices)]),
                        fault_injector=jfaults.FaultInjector(schedule=schedules["jax"]),
                        metrics_path=mpath, **kw)
    steps = {t.name: json.load(open(d / "ckpts" / f"{t.name}.json"))["step"] for t in jtasks}
    out["jax"] = _outcome(j_read_events(mpath), res["completed"], res["failed"], steps)
    out["jax_calls"] = jtech.calls
    return out


def test_slice_preemption_of_a_two_device_block(tmp_path, losses):
    specs = [("job0", 12, {2: PER_BATCH}), ("job1", 12, {2: PER_BATCH})]
    out = _run_both(tmp_path, losses, specs, n_devices=4, seed=110,
                    hold={"job0": {2: 1}, "job1": {2: 1}}, interval=0.3)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["completed"] == ["job0", "job1"] and got["steps"] == {"job0": 12, "job1": 12}
    assert got["topology_change"] == [{"change": "shrink", "lost": [2, 3], "gained": [],
                                       "stragglers": [], "cause": "slice_preemption"}]
    assert len(got["preempted"]) == 1 and got["retries"] == {}
    assert [m["task"] for m in got["migration"]] == got["preempted"]
    # (size, offset): from the lost block [2:4] to the surviving [0:2]
    assert got["migration"][0]["moved_from"] == [2, 2]
    assert got["migration"][0]["moved_to"] == [2, 0]
    assert {size for _, size in out["torch_calls"]} == {2}


def test_a_loss_with_no_return_shrinks_four_to_two_and_restores_there(tmp_path, losses):
    specs = [("solo", 12, {2: PER_BATCH, 4: PER_BATCH / 2})]
    out = _run_both(tmp_path, losses, specs, n_devices=4, seed=110,
                    hold={"solo": {2: 1}}, interval=0.15)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["completed"] == ["solo"] and got["steps"] == {"solo": 12}
    assert got["preempted"] == ["solo"]
    assert got["recovery"] == [{"policy": "pause-resolve-resume", "capacity": 2, "n_tasks": 1}]
    assert got["migration"] == [{"task": "solo", "moved_from": [4, 0], "moved_to": [2, 0]}]
    sizes = [size for _, size in out["torch_calls"]]
    assert sizes[:2] == [4, 4] and set(sizes[2:]) == {2}
    # the run on 2 replicas restored the checkpoint the 4 replicas wrote
    assert ("solo", True) in out["torch_restored"]


def test_a_two_device_pool_shrinks_to_one_replica(tmp_path, losses):
    specs = [("pair", 10, {2: PER_BATCH})]
    out = _run_both(tmp_path, losses, specs, n_devices=2, seed=27,
                    hold={"pair": {2: 1}}, interval=0.15)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["completed"] == ["pair"] and got["steps"] == {"pair": 10}
    assert got["topology_change"][0]["lost"] == [1]
    assert got["synthesized"] == [{"pair": [1]}]
    assert got["migration"] == [{"task": "pair", "moved_from": [2, 0], "moved_to": [1, 0]}]
    sizes = [size for _, size in out["torch_calls"]]
    assert sizes[:2] == [2, 2] and set(sizes[2:]) == {1}
    assert ("pair", True) in out["torch_restored"]
