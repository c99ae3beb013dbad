"""The port's online job service against the JAX package's (the cases of
``tests/test_service.py`` and the service half of ``tests/test_crash.py``),
on CPU topologies.

- Units: ``compute_weight``; the queue's transitions and snapshots
  (timestamps aside); ``AdmissionController.admit``'s decisions and reasons
  on the same profiled tasks; ``project_pressure_shed``'s victims.
- The solver's priority weights: ``solve``, ``warm_schedule(
  insert_missing=True)``, ``greedy_plan`` and ``anytime_resolve`` give the
  JAX package's plans with weights and without.
- Journals across the packages: a journal either package's service wrote,
  folded by both packages' ``replay_service_state``, gives the same jobs,
  states, realized counts, dedup keys, tenant charges and pending
  migrations; ``audit_journal`` gives the same codes.
- The service loop and the seeded acceptance scenario (staggered
  priorities, a slice preemption, warm admissions), the kill-replay
  acceptance (no lost job, no iteration run twice, refusal without a
  ``task_provider``; the injector is armed before ``start()``), and the
  port's rule that a resumed job's budget follows its checkpoint.
- End to end: the same tiny GPT-2 jobs, submitted before ``start()``,
  through both packages' services: the same terminal states, and each
  job's final loss within TRAJ_TOL of the JAX package's.
- ``SaturnService``'s and ``serve``'s signatures are the JAX package's.

Tolerances: TRAJ_TOL on losses; weights to 1e-9 relative; none elsewhere.
"""

import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import saturn_tpu
import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu import durability as jdur
from saturn_tpu import resilience as jres
from saturn_tpu import service as jservice
from saturn_tpu.analysis import plan_verifier as jverifier
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.core.technique import BaseTechnique as JBaseTechnique
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.service import admission as jadmission
from saturn_tpu.service import server as jserver
from saturn_tpu.solver import anytime as janytime
from saturn_tpu.solver import milp as jmilp
from saturn_tpu.tenancy import model as jtenancy
from saturn_tpu.utils.metrics import read_events as j_read_events
from saturn_tpu_torch import durability as dur
from saturn_tpu_torch import library
from saturn_tpu_torch import resilience as res
from saturn_tpu_torch import service
from saturn_tpu_torch.analysis import plan_verifier as verifier
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.service import admission, server
from saturn_tpu_torch.service.queue import JobRequest, JobState, SubmissionQueue
from saturn_tpu_torch.solver import anytime, milp
from saturn_tpu_torch.tenancy import model as tenancy
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils.metrics import read_events

pytestmark = pytest.mark.service

TRAJ_TOL = 1e-4  # final losses against the JAX package's (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG",
                 "SATURN_TPU_HBM_BYTES", "SATURN_TPU_GROW_POLL", "SATURN_TPU_PARTITION_MAX",
                 "SATURN_TPU_SENTINEL", "SATURN_TPU_SENTINEL_SPIKE", "SATURN_TPU_MAX_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fakes(strategy_cls, technique_cls):
    class RecordingTech(technique_cls):
        """Sleeps per batch; records (task, block size) launches."""

        name = "svc-fake"

        def __init__(self, per_batch=0.001):
            self.per_batch = per_batch
            self.calls = []
            self.lock = threading.Lock()

        def execute(self, task, devices, tid, override_batch_count=None):
            with self.lock:
                self.calls.append((task.name, len(devices)))
            time.sleep(self.per_batch * (override_batch_count or 1))

        def search(self, task, devices, tid):
            return {}, self.per_batch

    class FailingTech(RecordingTech):
        name = "svc-failing"

        def __init__(self, fail=(), **kw):
            super().__init__(**kw)
            self.fail = set(fail)

        def execute(self, task, devices, tid, override_batch_count=None):
            if task.name in self.fail:
                raise RuntimeError(f"injected failure for {task.name}")
            super().execute(task, devices, tid, override_batch_count)

    class FakeTask:
        """A pre-profiled duck-typed task (admission runs no sweep)."""

        def __init__(self, name, total_batches, sizes, tech, pbt=0.001, hints=None):
            self.name = name
            self.total_batches = total_batches
            self.current_batch = 0
            self.epoch_length = 1000
            self.hints = dict(hints or {})
            self.chip_range = None
            self.strategies = {g: strategy_cls(tech, g, {}, pbt * total_batches, pbt)
                               for g in sizes}
            self.selected_strategy = None

        def feasible_strategies(self):
            return {g: s for g, s in self.strategies.items() if s.feasible}

        def select_strategy(self, g):
            self.selected_strategy = self.strategies[g]

        def reconfigure(self, n):
            self.current_batch = (self.current_batch + n) % self.epoch_length

    return SimpleNamespace(RecordingTech=RecordingTech, FailingTech=FailingTech,
                           FakeTask=FakeTask)


class _Dev:
    platform = "cpu"
    process_index = 0


PKGS = {
    "torch": SimpleNamespace(
        svc=service, Service=service.SaturnService, Client=service.ServiceClient,
        admission=admission, server=server, dur=dur, res=res, tenancy=tenancy,
        JobRequest=JobRequest, fakes=_fakes(Strategy, BaseTechnique),
        topo=lambda n=8: SliceTopology([torch.device("cpu")] * n)),
    "jax": SimpleNamespace(
        svc=jservice, Service=jservice.SaturnService, Client=jservice.ServiceClient,
        admission=jadmission, server=jserver, dur=jdur, res=jres, tenancy=jtenancy,
        JobRequest=jservice.JobRequest, fakes=_fakes(JStrategy, JBaseTechnique),
        topo=lambda n=8: JSliceTopology([_Dev() for _ in range(n)])),
}
T = PKGS["torch"]
F = T.fakes


def topo(n=8):
    return T.topo(n)


# ---------------------------------------------------------------- signatures
def test_signatures_are_the_jax_packages():
    assert (inspect.signature(service.SaturnService.__init__)
            == inspect.signature(jservice.SaturnService.__init__))
    assert inspect.signature(sat.serve) == inspect.signature(saturn_tpu.serve)
    assert "serve" in sat.__all__
    for name in ("submit", "status", "wait", "cancel"):
        assert (inspect.signature(getattr(service.ServiceClient, name))
                == inspect.signature(getattr(jservice.ServiceClient, name)))


def test_compile_ahead_is_not_ported():
    """Named when ``compile_ahead`` raised ``NotImplementedError``: the pool
    is ported now, so the option is taken as the JAX service takes it (the
    pool fed at ADMIT, closed at ``stop()``; ``tests/test_torch_tenancy.py``
    drives it)."""
    from saturn_tpu_torch.tenancy import CompileAheadPool

    pool = CompileAheadPool(workers=1)
    svc = service.SaturnService(topology=topo(1), compile_ahead=pool)
    assert svc.compile_ahead is pool and pool.journal is None
    svc.stop()
    assert not pool.prewarm("k", lambda: 1)  # closed by stop()


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sat.serve()


# -------------------------------------------------------------------- queue
def test_submit_drain_fifo():
    q = SubmissionQueue()
    tech = F.RecordingTech()
    recs = [q.submit(JobRequest(F.FakeTask(f"t{i}", 10, [2], tech))) for i in range(3)]
    assert [r.state for r in recs] == [JobState.QUEUED] * 3
    assert q.depth() == 3
    assert [r.name for r in q.drain()] == ["t0", "t1", "t2"]
    assert q.drain() == []


def test_unique_live_names_and_reuse_after_terminal():
    q = SubmissionQueue()
    tech = F.RecordingTech()
    r1 = q.submit(JobRequest(F.FakeTask("re", 10, [2], tech)))
    with pytest.raises(ValueError, match="unique among active jobs"):
        q.submit(JobRequest(F.FakeTask("re", 10, [2], tech)))
    q.mark(r1, JobState.PROFILING)
    q.mark(r1, JobState.FAILED, error="nope")
    assert q.submit(JobRequest(F.FakeTask("re", 10, [2], tech))).job_id != r1.job_id


def test_illegal_transition_raises():
    q = SubmissionQueue()
    rec = q.submit(JobRequest(F.FakeTask("x", 10, [2], F.RecordingTech())))
    with pytest.raises(RuntimeError, match="illegal job transition"):
        q.mark(rec, JobState.RUNNING)


def test_lifecycle_timestamps_and_sticky_start():
    q = SubmissionQueue()
    rec = q.submit(JobRequest(F.FakeTask("x", 10, [2], F.RecordingTech())))
    for s in (JobState.PROFILING, JobState.SCHEDULED, JobState.RUNNING, JobState.DONE):
        q.mark(rec, s)
    assert (rec.submitted_at <= rec.admitted_at <= rec.scheduled_at <= rec.started_at
            <= rec.finished_at)
    rec = q.submit(JobRequest(F.FakeTask("p", 10, [2], F.RecordingTech())))
    q.drain()
    for s in (JobState.PROFILING, JobState.SCHEDULED, JobState.RUNNING):
        q.mark(rec, s)
    started = rec.started_at
    q.requeue(rec)
    assert rec.state is JobState.QUEUED and rec.requeues == 1
    assert [r.name for r in q.drain()] == ["p"]
    for s in (JobState.PROFILING, JobState.SCHEDULED, JobState.RUNNING, JobState.DONE):
        q.mark(rec, s)
    assert rec.started_at == started  # the first launch's stamp stays


def test_wait_timeout_and_cancel():
    q = SubmissionQueue()
    rec = q.submit(JobRequest(F.FakeTask("w", 10, [2], F.RecordingTech())))
    with pytest.raises(TimeoutError):
        q.wait(rec.job_id, timeout=0.05)
    assert q.cancel(rec.job_id) is True
    assert rec.state is JobState.EVICTED and rec.error == "cancelled"
    assert q.cancel(rec.job_id) is False
    assert q.wait(rec.job_id, timeout=1.0).state is JobState.EVICTED
    assert q.drain() == []


def _queue_script(p):
    """Every transition kind, tenants and a restore, on one queue; the
    snapshots after each step with their timestamps left out."""
    q = p.svc.SubmissionQueue()
    tech = p.fakes.RecordingTech()
    stamps = ("submitted_at", "admitted_at", "scheduled_at", "started_at", "finished_at")
    out = []

    def snap(rec):
        s = rec.snapshot()
        out.append({k: v for k, v in s.items() if k not in stamps})
        out.append((q.depth(), q.live(), q.live_by_tenant(), q.admitted_tenant(rec.tenant)))

    a = q.submit(p.JobRequest(p.fakes.FakeTask("a", 10, [2], tech), priority=2.0,
                              tenant="acme"))
    b = q.submit(p.JobRequest(p.fakes.FakeTask("b", 10, [2], tech), deadline_s=5.0))
    snap(a)
    snap(b)
    for rec, states in ((a, ("PROFILING", "SCHEDULED", "RUNNING", "QUEUED", "PROFILING",
                             "SCHEDULED", "RUNNING", "DONE")),
                        (b, ("PROFILING", "QUEUED", "PROFILING", "FAILED"))):
        for s in states:
            if s == "QUEUED":
                q.requeue(rec)
            else:
                q.mark(rec, p.svc.JobState(s), error="boom" if s == "FAILED" else None)
            snap(rec)
    c = q.submit(p.JobRequest(p.fakes.FakeTask("c", 10, [2], tech)))
    q.cancel(c.job_id)
    snap(c)
    d = q.submit(p.JobRequest(p.fakes.FakeTask("d", 10, [2], tech)))
    q.mark(d, p.svc.JobState.PROFILING)
    q.mark(d, p.svc.JobState.SCHEDULED)
    q.cancel(d.job_id)  # admitted: only flagged
    out.append(d.cancel_requested)
    snap(d)
    restored = p.svc.JobRecord(job_id="j0042-r", request=p.JobRequest(
        p.fakes.FakeTask("r", 5, [2], tech), tenant="acme"))
    q.restore(restored)
    snap(restored)
    out.append([r.job_id for r in q.drain()])
    out.append(q.submit(p.JobRequest(p.fakes.FakeTask("e", 10, [2], tech))).job_id)
    out.append(q.compact())
    return out


def test_queue_transitions_and_snapshots_match_jax():
    assert _queue_script(T) == _queue_script(PKGS["jax"])


# ---------------------------------------------------------------- admission
@pytest.mark.parametrize("priority,slack,est", [(3.0, None, 10.0), (0.0, 10.0, 5.0),
                                                (0.0, 1.0, 5.0), (1.0, None, 0.0),
                                                (0.0, 0.1, 5.0), (-1.5, 3.0, 1e-12),
                                                (5.0, -2.0, 4.0)])
def test_compute_weight_matches_jax(priority, slack, est):
    assert (admission.compute_weight(priority, slack, est)
            == jadmission.compute_weight(priority, slack, est))


def test_compute_weight_classes():
    cw = admission.compute_weight
    assert cw(3.0, None, 10.0) == pytest.approx(8.0)
    assert cw(0.0, 10.0, 5.0) == pytest.approx(1.5)
    assert cw(0.0, 1.0, 5.0) == pytest.approx(2.0)
    assert cw(1.0, None, 0.0) >= cw(0.0, 0.1, 5.0)  # the deadline boost is capped at 2x


def _admissions(p):
    """Decisions on profiled tasks: admit, reject (never fits), defer (a
    degraded topology), an occupancy defer, a requeued job's synthesized
    size, and the weight's priority and hints."""
    fk = p.fakes
    tech = fk.RecordingTech()
    q = p.svc.SubmissionQueue()
    ctrl = p.admission.AdmissionController(p.topo(8), q)
    out = []

    def admit(task, t=None, **kw):
        rec = q.submit(p.JobRequest(task, **kw))
        d = ctrl.admit(rec, t or p.topo(8))
        out.append((d.action, d.reason, d.trials_run, d.revisit_on, d.static_prior,
                    round(d.weight, 9), rec.state.value, dict(task.hints)))
        return rec

    admit(fk.FakeTask("a", 10, [2, 4], tech), priority=2.0)
    admit(fk.FakeTask("big", 10, [16], tech))
    admit(fk.FakeTask("d", 10, [8], tech), t=p.topo(4))
    ctrl.occupancy_gate = lambda task, topology: {"fits": False, "free_bytes": 10,
                                                  "need_bytes": 20}
    admit(fk.FakeTask("occ", 10, [2], tech))
    ctrl.occupancy_gate = None
    rec = q.submit(p.JobRequest(fk.FakeTask("pre", 40, [8], tech, pbt=0.01)))
    rec.requeues = 1  # a preempted job, back through the queue
    d = ctrl.admit(rec, p.topo(4))
    out.append((d.action, sorted(rec.task.feasible_strategies()),
                rec.task.strategies[4].interpolated))
    admit(fk.FakeTask("neg", 10, [1], tech), priority=-1.0)
    out.append(sorted(ctrl.deferred))
    return out


def test_admission_decisions_match_jax():
    got, want = _admissions(T), _admissions(PKGS["jax"])
    assert got == want
    assert got[0][:3] == ("admit", "ok", 0) and got[0][5] == pytest.approx(4.0)
    assert got[0][7] == {"priority": 2.0}
    assert got[1][0] == "reject" and "fits the mesh" in got[1][1]
    assert got[2][0] == "defer" and "degraded" in got[2][1] and got[2][3] == "grow"
    assert got[3][0] == "defer" and got[3][3] == "defrag"
    assert got[4] == ("admit", [4, 8], True)


def test_the_static_screen_rejects_a_job_no_config_fits(monkeypatch):
    """The port's zero-trial memory verdict: a job whose train state is over
    the device's headroom at every config is rejected with no trial (the
    JAX package asks memlens); where the screen cannot tell, it passes."""
    from saturn_tpu_torch.utils import timing

    library.register_default_library()
    task = sat.Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                    get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4,
                                                           vocab_size=256, n_tokens=64 * 4 * 4),
                    loss_fn=pretraining_loss, hparams=sat.HParams(lr=1e-3, batch_count=4),
                    name="huge", save_dir="unused_ckpts")
    ctrl = admission.AdmissionController(topo(1), SubmissionQueue(), technique_names=["dp"])
    assert ctrl._screen_verdict(task, topo(1)) is None  # the CPU has no memory size
    monkeypatch.setattr(timing, "device_memory_bytes", lambda d: 1000)
    verdict = ctrl._screen_verdict(task, topo(1))
    assert verdict["fits"] is False and verdict["capacity_bytes"] == 920
    rec = ctrl.queue.submit(JobRequest(task))
    dec = ctrl.admit(rec, topo(1))
    assert dec.action == "reject" and dec.trials_run == 0 and "static screen" in dec.reason
    monkeypatch.setattr(timing, "device_memory_bytes", lambda d: 80 * 2**30)
    assert ctrl._screen_verdict(task, topo(1)) == {"fits": True}
    ctrl2 = admission.AdmissionController(topo(1), SubmissionQueue(),
                                          technique_names=["dp", "offload"])
    monkeypatch.setattr(timing, "device_memory_bytes", lambda d: 1000)
    assert ctrl2._screen_verdict(task, topo(1)) is None  # offload's host state is not screened


def _pressure(p, tenants=False):
    fk = p.fakes
    tech = fk.RecordingTech()
    q = p.svc.SubmissionQueue()
    jobs = {}
    for name, prio, dl, tenant in (("hi", 2.0, 0.7, "acme"), ("lo", 0.0, None, "acme"),
                                   ("mid", 1.0, None, "quiet"), ("lo2", 0.0, None, "acme")):
        rec = q.submit(p.JobRequest(fk.FakeTask(name, 100, [8], tech, pbt=0.005),
                                    priority=prio, deadline_s=dl, tenant=tenant))
        rec.task.hints["priority"] = prio
        jobs[name] = rec
    led = p.tenancy.TenantLedger() if tenants else None
    shed, proj, limit = p.server.project_pressure_shed(jobs, p.topo(8), None,
                                                       "evict-lowest-priority", tenancy=led)
    return [r.name for r in shed], round(proj, 9)


@pytest.mark.parametrize("tenants", [False, True])
def test_pressure_shed_victims_match_jax(tenants):
    got, want = _pressure(T, tenants), _pressure(PKGS["jax"], tenants)
    assert got == want and got[0]


# ------------------------------------------------------ weighted solver
class _Job:
    def __init__(self, name, strategies):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}


MARKER = object()


def _jobs(seed, n, cap):
    rng = np.random.default_rng(seed)
    tabs, weights = [], {}
    for i in range(n):
        base = float(rng.uniform(10, 100))
        tabs.append((f"t{i:02d}", {g: base / g ** float(rng.uniform(0.5, 1.0))
                                   for g in (1, 2, 4, 8)
                                   if g <= cap and (g == 1 or rng.random() < 0.8)}))
        weights[f"t{i:02d}"] = float(2.0 ** rng.integers(0, 5))
    jj = [_Job(n_, {g: JStrategy(MARKER, g, {}, rt, rt / 10) for g, rt in t.items()})
          for n_, t in tabs]
    tj = [_Job(n_, {g: Strategy(MARKER, g, {}, rt, rt / 10) for g, rt in t.items()})
          for n_, t in tabs]
    return (jj, JSliceTopology([object() for _ in range(cap)]), tj,
            SliceTopology([f"dev{i}" for i in range(cap)]), weights)


def _slots(plan):
    return {n: (a.apportionment, a.block.offset, round(a.start, 6))
            for n, a in plan.assignments.items()}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,n,cap", [(0, 6, 1), (1, 9, 4), (2, 14, 8)])
def test_weighted_greedy_and_warm_plans_match_jax(seed, n, cap, weighted):
    jj, jt, tj, tt, w = _jobs(seed, n, cap)
    w = w if weighted else None
    got, want = milp.greedy_plan(tj, tt, 1.0, weights=w), jmilp.greedy_plan(jj, jt, 1.0,
                                                                             weights=w)
    assert got.to_json() == want.to_json()
    jprev, tprev = jmilp.greedy_plan(jj[:-3], jt, 1.0), milp.greedy_plan(tj[:-3], tt, 1.0)
    for cap_probe in (None, 2):
        got = milp.warm_schedule(tj, tt, tprev, 1.0, insert_missing=True, weights=w,
                                 insertion_probe_cap=cap_probe)
        want = jmilp.warm_schedule(jj, jt, jprev, 1.0, insert_missing=True, weights=w,
                                   insertion_probe_cap=cap_probe)
        assert got.to_json() == want.to_json()
    got = anytime.fast_greedy_plan(tj, tt, weights=w)
    assert got.to_json() == janytime.fast_greedy_plan(jj, jt, weights=w).to_json()
    got, _ = anytime.lp_round_plan(tj, tt, 1.0, w, seed=3)
    want, _ = janytime.lp_round_plan(jj, jt, 1.0, w, seed=3)
    assert _slots(got) == _slots(want)


def test_weights_put_the_heavy_task_first():
    jj, jt, tj, tt, _ = _jobs(5, 5, 1)
    w = {"t04": 32.0}
    order = sorted(milp.greedy_plan(tj, tt, 1.0, weights=w).assignments.items(),
                   key=lambda kv: kv[1].start)
    assert order[0][0] == "t04"
    prev = milp.greedy_plan(tj[:2], tt, 1.0)
    warm = milp.warm_schedule(tj, tt, prev, 1.0, insert_missing=True, weights=w)
    loose = sorted((a.start, n) for n, a in warm.assignments.items() if n not in prev.assignments)
    assert loose[0][1] == "t04"


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,n,cap", [(3, 4, 1), (4, 5, 2), (6, 4, 4)])
def test_weighted_solve_matches_jax(seed, n, cap, weighted):
    """The exact MILP (small enough to prove optimality) with the weighted
    start-time tiebreak, and cold without weights."""
    jj, jt, tj, tt, w = _jobs(seed, n, cap)
    w = w if weighted else None
    got = milp.solve(tj, tt, time_limit=20.0, weights=w)
    want = jmilp.solve(jj, jt, time_limit=20.0, weights=w)
    assert _slots(got) == _slots(want)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-6)
    assert got.dependencies == want.dependencies
    assert verifier.verify_plan(got, topology=tt, tasks=tj).ok


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("deadline,warm,tier", [(0.1, True, 0), (0.3, False, 2),
                                                (1e-3, False, 3), (30.0, False, 1)])
def test_weighted_anytime_resolve_matches_jax(deadline, warm, tier, weighted, monkeypatch):
    monkeypatch.setenv(anytime.PARTITION_MAX_ENV, "4")
    n = 13 if tier != 1 else 4
    jj, jt, tj, tt, w = _jobs(40 + tier, n, 4)
    w = w if weighted else None
    jprev = jmilp.greedy_plan(jj[:-2], jt, 1.0) if warm else None
    tprev = milp.greedy_plan(tj[:-2], tt, 1.0) if warm else None
    got = anytime.anytime_resolve(tj, tt, tprev, 10.0, deadline=deadline, weights=w)
    want = janytime.anytime_resolve(jj, jt, jprev, 10.0, deadline=deadline, weights=w)
    assert got.anytime.tier == want.anytime.tier == tier
    assert _slots(got) == _slots(want)


def test_fusion_groups_weigh_as_their_heaviest_member():
    winners = [(["a", "b", "c"], 1, 10.0, 1.0)]
    assert milp.fusion_weights({"a": 1.0, "b": 8.0, "d": 2.0}, winners) == {
        "a": 8.0, "b": 8.0, "d": 2.0}
    assert milp.fusion_weights(None, winners) is None


# ------------------------------------------------------------- service loop
def _service(pkg="torch", **kw):
    p = PKGS[pkg]
    kw.setdefault("topology", p.topo(8))
    kw.setdefault("interval", 0.2)
    kw.setdefault("poll_s", 0.02)
    return p.Service(**kw)


def test_jobs_complete_with_lifecycle_events(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    tech = F.RecordingTech()
    svc = _service(metrics_path=mpath).start()
    client = service.ServiceClient(svc)
    try:
        ids = [client.submit(F.FakeTask(f"job{i}", 50, [2, 4], tech), priority=float(i))
               for i in range(3)]
        outs = [client.wait(j, timeout=60) for j in ids]
    finally:
        svc.stop(timeout=30)
    assert all(o["state"] == "DONE" for o in outs)
    evs = read_events(mpath)
    for jid in ids:
        kinds = [e["kind"] for e in evs if e.get("job") == jid]
        for k in ("job_submitted", "job_admitted", "job_scheduled", "job_completed"):
            assert k in kinds, (jid, k, kinds)
    assert read_events(mpath, kind="queue_depth") and read_events(mpath, kind="solver_tier")


def test_cancel_a_running_job(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    tech = F.RecordingTech(per_batch=0.01)
    svc = _service(interval=0.15, metrics_path=mpath).start()
    client = service.ServiceClient(svc)
    try:
        jid = client.submit(F.FakeTask("longjob", 400, [4], tech, pbt=0.01))
        deadline = time.monotonic() + 20
        while client.status(jid)["state"] in ("QUEUED", "PROFILING"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert client.cancel(jid) is True
        out = client.wait(jid, timeout=30)
    finally:
        svc.stop(timeout=30)
    assert out["state"] == "EVICTED" and out["error"] == "cancelled"
    assert any(e.get("job") == jid and e["reason"] == "cancelled"
               for e in read_events(mpath, kind="job_evicted"))


def test_a_failed_job_retries_then_fails_in_isolation(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    svc = _service(interval=0.15, metrics_path=mpath).start()
    client = service.ServiceClient(svc)
    try:
        jbad = client.submit(F.FakeTask("bad", 30, [2], F.FailingTech(fail={"bad"})),
                             max_retries=1)
        jgood = client.submit(F.FakeTask("good", 30, [2], F.RecordingTech()))
        bad, good = client.wait(jbad, timeout=60), client.wait(jgood, timeout=60)
    finally:
        svc.stop(timeout=30)
    assert bad["state"] == "FAILED" and bad["attempts"] == 2
    assert good["state"] == "DONE"
    assert read_events(mpath, kind="task_retry")
    assert any(e.get("job") == jbad for e in read_events(mpath, kind="job_failed"))


def test_retry_exhaustion_is_terminal_and_journaled(tmp_path):
    wal = str(tmp_path / "wal")
    svc = _service(interval=0.15, durability_dir=wal).start()
    client = service.ServiceClient(svc)
    try:
        jbad = client.submit(F.FakeTask("bad", 30, [2], F.FailingTech(fail={"bad"})),
                             max_retries=1)
        out = client.wait(jbad, timeout=60)
        assert out["state"] == "FAILED" and out["attempts"] == 2
        jre = client.submit(F.FakeTask("bad", 20, [2], F.RecordingTech()))
        assert client.wait(jre, timeout=60)["state"] == "DONE"
    finally:
        svc.stop(timeout=30)
    states = [r["data"]["state"] for r in dur.replay(wal, strict=True)
              if r["kind"] == "job_state" and r["data"]["job"] == jbad]
    assert states[-1] == "FAILED"
    replayed = dur.replay_service_state(wal)
    assert replayed.jobs[jbad].terminal and replayed.jobs[jbad].error
    assert not replayed.live_jobs()


def test_admission_pressure_sheds_the_lowest_priority(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    tech = F.RecordingTech(per_batch=0.005)
    svc = _service(metrics_path=mpath).start()
    client = service.ServiceClient(svc)
    try:
        jhi = client.submit(F.FakeTask("hi", 100, [8], tech, pbt=0.005), priority=2.0,
                            deadline_s=0.7)
        jlo = client.submit(F.FakeTask("lo", 100, [8], tech, pbt=0.005), priority=0.0)
        hi, lo = client.wait(jhi, timeout=60), client.wait(jlo, timeout=60)
    finally:
        svc.stop(timeout=30)
    assert hi["state"] == "DONE" and lo["state"] == "EVICTED"
    evs = [e for e in read_events(mpath, kind="job_evicted") if e.get("job") == jlo]
    assert evs and evs[0]["reason"] == "admission-pressure"


def test_stop_raises_what_the_loop_raised():
    """No fallback hides a failure of the loop: ``stop()`` raises it, and
    every live job ends FAILED."""

    class Broken(F.RecordingTech):
        pass

    svc = _service()
    client = service.ServiceClient(svc)
    jid = client.submit(F.FakeTask("x", 10, [2], Broken()))
    started = threading.Event()

    def broken(*args, **kwargs):
        started.wait(30)  # after start() returned
        raise SystemError("drain broke")

    svc._drain_arrivals = broken
    svc.start()
    started.set()
    svc._thread.join(30)
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="service loop crashed") as ei:
        svc.stop(timeout=30)
    assert isinstance(ei.value.__cause__, SystemError)
    # a job the loop never admitted stays QUEUED (QUEUED -> FAILED is not a
    # transition), as in the JAX package
    assert client.status(jid)["state"] == "QUEUED"


# ------------------------------------------------------------- acceptance
def _superlinear_pbt(n_devices: int) -> float:
    return 0.0035 * (8.0 / n_devices) ** 1.5


class ProfiledTech(BaseTechnique):
    """Registered in the library, so the admission sweep instantiates it."""

    name = "svc-prof"
    launches = []
    lock = threading.Lock()

    def execute(self, task, devices, tid, override_batch_count=None):
        with ProfiledTech.lock:
            ProfiledTech.launches.append((task.name, len(devices)))
        time.sleep(_superlinear_pbt(len(devices)) * (override_batch_count or 1))

    def search(self, task, devices, tid):
        time.sleep(0.004)  # a compile's stand-in
        return {}, _superlinear_pbt(len(devices))


def _profilable(name, family, total_batches=140, save_dir="unused_ckpts"):
    """A tiny real task (the profile cache fingerprints its model and
    data) with no strategies: admission sweeps it, or finds it in the
    cache. ``family`` separates fingerprints; size 8 only."""
    return sat.Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                    get_dataloader=lambda: make_lm_dataset(context_length=16, batch_size=2,
                                                           vocab_size=256, n_tokens=16 * 2 * 8),
                    loss_fn=pretraining_loss,
                    hparams=sat.HParams(lr=1e-3, batch_count=total_batches), chip_range=[8],
                    hints={"family": family}, name=name, save_dir=save_dir)


def test_warm_arrival_admits_with_zero_trials(tmp_path):
    library.register("svc-prof", ProfiledTech)
    try:
        q = SubmissionQueue()
        ctrl = admission.AdmissionController(topo(8), q, technique_names=["svc-prof"],
                                             profile_cache=str(tmp_path / "pcache"), prune=False)
        save = str(tmp_path / "ck")
        cold = q.submit(JobRequest(_profilable("cold", 1, save_dir=save)))
        assert ctrl.admit(cold, topo(8)).trials_run > 0
        warm = q.submit(JobRequest(_profilable("warm", 1, save_dir=save), priority=3.0))
        dec = ctrl.admit(warm, topo(8))
        assert dec.action == "admit" and dec.trials_run == 0
        assert warm.task.feasible_strategies()
        other = q.submit(JobRequest(_profilable("other", 2, save_dir=save)))
        assert ctrl.admit(other, topo(8)).trials_run > 0
    finally:
        library.deregister("svc-prof")


def test_online_service_seeded_scenario(tmp_path):
    """Six staggered jobs of mixed priorities, a slice preemption during a
    run: every job completes, the later high-priority arrival starts before
    the queued low-priority one, a warm arrival admits with zero trials,
    and the metrics stream holds each job's whole lifecycle."""
    library.register("svc-prof", ProfiledTech)
    ProfiledTech.launches = []
    mpath = str(tmp_path / "svc.jsonl")
    save = str(tmp_path / "ck")
    t8 = topo(8)
    monitor = res.FleetHealthMonitor.for_topology(t8)
    injector = res.FaultInjector(schedule=[
        res.FaultEvent(4, res.FaultKind.SLICE_PREEMPTION, devices=(4, 5, 6, 7), after_s=0.05)])
    # prune=False: anchor-size pruning is not ported (ROADMAP.md, queue 1 item 4)
    svc, client = sat.serve(topology=t8, interval=0.25, metrics_path=mpath,
                            technique_names=["svc-prof"],
                            profile_cache=str(tmp_path / "pcache"), prune=False,
                            health_monitor=monitor, fault_injector=injector, poll_s=0.02)
    try:
        ids = {"j0": client.submit(_profilable("j0", 0, save_dir=save), priority=1.0),
               "j1": client.submit(_profilable("j1", 1, save_dir=save), priority=1.0)}
        time.sleep(0.1)
        ids["jlow"] = client.submit(_profilable("jlow", 2, save_dir=save), priority=0.0)
        ids["jhigh"] = client.submit(_profilable("jhigh", 3, save_dir=save), priority=5.0)
        deadline = time.monotonic() + 30
        while client.status(ids["j0"])["state"] in ("QUEUED", "PROFILING"):
            assert time.monotonic() < deadline, "j0 never admitted"
            time.sleep(0.01)
        ids["j4"] = client.submit(_profilable("j4", 4, save_dir=save), priority=2.0)
        ids["jwarm"] = client.submit(_profilable("jwarm", 0, save_dir=save), priority=1.0)
        outs = {k: client.wait(j, timeout=120) for k, j in ids.items()}
    finally:
        svc.stop(timeout=60)
        library.deregister("svc-prof")
    assert all(o["state"] == "DONE" for o in outs.values()), outs
    assert outs["jhigh"]["submitted_at"] > outs["jlow"]["submitted_at"]
    assert outs["jhigh"]["started_at"] < outs["jlow"]["started_at"]
    evs = read_events(mpath)
    admits = {}
    for e in evs:
        if e["kind"] == "job_admitted" and e["decision"] == "admit":
            admits.setdefault(e["job"], e)
    assert admits[ids["j0"]]["trials_run"] > 0
    assert admits[ids["jwarm"]]["trials_run"] == 0 and admits[ids["jwarm"]]["warm"] is True
    assert any(e["kind"] == "task_preempted" for e in evs)
    assert any(c.get("change") == "shrink" for c in evs if c["kind"] == "topology_change")
    preempted = {e["task"] for e in evs if e["kind"] == "task_preempted"}
    assert all(o["requeues"] >= 1 for o in outs.values() if o["task"] in preempted)
    for key, jid in ids.items():
        kinds = [e["kind"] for e in evs if e.get("job") == jid]
        for k in ("job_submitted", "job_admitted", "job_scheduled", "job_completed"):
            assert k in kinds, (key, k, kinds)


# ------------------------------------------------------- journals across
def _journal_run(p, wal):
    """A durable service with a tenant ledger: a job done, one failed past
    its retries, one cancelled while queued, one with a dedup key; then a
    defrag intent left open and a ckpt publication, as a kill leaves them."""
    fk = p.fakes
    tech = fk.RecordingTech()
    led = p.tenancy.TenantLedger()
    svc = p.Service(topology=p.topo(8), interval=0.15, poll_s=0.02, durability_dir=wal,
                    tenancy=led)
    c = svc.queue.submit(p.JobRequest(fk.FakeTask("cancelled", 10, [2], tech), tenant="acme"))
    svc.queue.cancel(c.job_id)
    svc.start()
    client = p.Client(svc)
    try:
        ids = [client.submit(fk.FakeTask("ok", 40, [2, 4], tech), priority=1.0,
                             spec={"sizes": [2, 4]}),
               client.submit(fk.FakeTask("bad", 30, [2], fk.FailingTech(fail={"bad"})),
                             max_retries=1),
               svc.queue.submit(p.JobRequest(fk.FakeTask("keyed", 20, [4], tech),
                                             dedup_key="k-1", tenant="acme")).job_id]
        for j in ids:
            client.wait(j, timeout=60)
    finally:
        svc.stop(timeout=30)
    j = p.dur.Journal(wal)
    j.append("migration_intent", wave="wave-5-2", interval=5, task="ok", pinned_bytes=1)
    j.append("ckpt_published", task="keyed", path="ck")
    j.append("gateway_lease", epoch=3, owner="gw-a", prev_owner=None)
    j.append("compile_ahead", status="hit")
    j.commit()
    j.close()


def _fold(fold, wal):
    s = fold(wal)
    jobs = {k: (j.task, j.state, j.realized, j.total_batches, j.attempts, j.requeues,
                j.error, j.priority, j.dedup_key, j.tenant, j.spec)
            for k, j in s.jobs.items()}
    return (jobs, s.dedup, {k: round(v, 9) for k, v in s.tenant_charges.items()},
            {k: {f: v for f, v in d.items() if f != "seq"}
             for k, d in s.pending_migrations.items()},
            s.incarnations, s.lease_epoch, s.lease_owner, s.compile_ahead, s.defrag_waves,
            sorted(s.checkpoints), s.n_records, s.last_seq)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_journals_fold_the_same_on_both_packages(tmp_path, writer):
    wal = str(tmp_path / "wal")
    _journal_run(PKGS[writer], wal)
    got, want = _fold(dur.replay_service_state, wal), _fold(jdur.replay_service_state, wal)
    assert got == want
    jobs = got[0]
    assert {v[0]: v[1] for v in jobs.values()} == {"cancelled": "EVICTED", "ok": "DONE",
                                                  "bad": "FAILED", "keyed": "DONE"}
    assert {v[0]: v[2] for v in jobs.values()}["ok"] == 40
    assert list(got[1]) == ["k-1"] and got[2]["acme"] > 0
    assert list(got[3]) == [("wave-5-2", "ok")]
    dur.replay(wal, strict=True)
    jdur.replay(wal, strict=True)


def test_both_services_journal_the_same_outcomes(tmp_path):
    got = _fold(dur.replay_service_state, _run(_journal_run, T, tmp_path / "t"))
    want = _fold(dur.replay_service_state, _run(_journal_run, PKGS["jax"], tmp_path / "j"))
    strip = lambda f: {v[0]: v[1:] for v in f[0].values()}  # noqa: E731 (job ids are the same)
    assert strip(got) == strip(want)
    assert got[1:5] == want[1:5]


def _run(fn, p, root):
    wal = str(root / "wal")
    fn(p, wal)
    return wal


def _audit_codes(mod, wal):
    return sorted(mod.audit_journal(wal).codes())


def test_audit_journal_codes_match_jax(tmp_path):
    wal = _run(_journal_run, T, tmp_path / "t")
    jwal = _run(_journal_run, PKGS["jax"], tmp_path / "j")
    for w in (wal, jwal):
        assert _audit_codes(verifier, w) == _audit_codes(jverifier, w)
        assert "SAT-J001" not in _audit_codes(verifier, w)
    bad = {"makespan": 1.0, "assignments": {"a": [1, 0, 1, 0.0, 1.0], "b": [1, 0, 1, 0.0, 1.0]},
           "dependencies": {"a": [], "b": []}, "coschedule": [], "fused": []}
    j = dur.Journal(wal)
    j.append("plan_commit", interval=9, makespan=1.0, plan=bad)
    j.append("plan_commit", interval=10, makespan=1.0, plan={"broken": True})
    j.commit()
    j.close()
    codes = _audit_codes(verifier, wal)
    assert codes == _audit_codes(jverifier, wal)
    assert "SAT-J001" in codes and "SAT-J002" in codes
    assert (dur.audit_plan_commits(wal).codes()
            == jdur.recovery.audit_plan_commits(wal).codes())
    empty = str(tmp_path / "empty")
    dur.Journal(empty).close()
    assert _audit_codes(verifier, empty) == _audit_codes(jverifier, empty) == ["SAT-J000"]


def test_restore_records_rebuild_the_remaining_budget(tmp_path):
    wal = str(tmp_path / "wal")
    j = dur.Journal(wal)
    j.append("job_submitted", job="j0001-t", task="t", priority=1.0, max_retries=1,
             total_batches=60, spec={"sizes": [2]})
    for s in ("PROFILING", "SCHEDULED", "RUNNING"):
        j.append("job_state", job="j0001-t", state=s)
    j.append("task_progress", task="t", job="j0001-t", batches=25)
    j.append("job_submitted", job="j0002-u", task="u", total_batches=10, spec={"sizes": [2]})
    j.append("task_progress", task="u", job="j0002-u", batches=10)
    j.commit()
    j.close()
    tech = F.RecordingTech()
    specs = []

    def provide(spec):
        specs.append(spec)
        return F.FakeTask(spec["task"], spec["remaining_batches"], spec["spec"]["sizes"], tech)

    state = dur.replay_service_state(wal)
    assert (state.jobs["j0001-t"].realized, state.jobs["j0001-t"].remaining) == (25, 35)
    recs = {r.job_id: r for r in dur.build_restore_records(state, provide)}
    t = recs["j0001-t"]
    assert t.state is JobState.QUEUED and t.requeues == 1 and t.task.total_batches == 35
    assert recs["j0002-u"].state is JobState.DONE  # every batch realized: only the verdict lost
    assert [(s["total_batches"], s["remaining_batches"]) for s in specs] == [(60, 35)]
    jrecs = jdur.recovery.build_restore_records(jdur.replay_service_state(wal), provide)
    assert [(r.job_id, r.state.value, r.requeues) for r in jrecs] == [
        (r.job_id, r.state.value, r.requeues) for r in recs.values()]
    with pytest.raises(RuntimeError, match="task_provider"):
        dur.build_restore_records(state, None)


def test_restore_records_evict_a_journaled_cancel(tmp_path):
    """A live job whose cancel was journaled comes back EVICTED
    ("cancelled") without a provider call, also where no provider is
    given; the JAX package's records of the same journal rebuild it (its
    fold reads the record as the state the job had)."""
    wal = str(tmp_path / "wal")
    j = dur.Journal(wal)
    j.append("job_submitted", job="j0001-c", task="c", total_batches=60, spec={"sizes": [2]})
    for st in ("PROFILING", "SCHEDULED", "RUNNING"):
        j.append("job_state", job="j0001-c", state=st, attempts=0, requeues=0, error=None)
    j.append("job_state", job="j0001-c", state="RUNNING", attempts=0, requeues=0, error=None,
             cancel_requested=True)
    j.append("task_progress", task="c", job="j0001-c", batches=12)
    j.commit()
    j.close()
    state = dur.replay_service_state(wal)
    assert state.jobs["j0001-c"].cancel_requested and not state.live_jobs()[0].terminal
    specs = []
    for provide in (None, lambda spec: specs.append(spec)):
        (rec,) = dur.build_restore_records(state, provide)
        assert (rec.state, rec.error, rec.cancel_requested) == (JobState.EVICTED, "cancelled",
                                                                True)
        assert rec.task.strategies == {}
    assert not specs
    jstate = jdur.replay_service_state(wal)
    assert jstate.jobs["j0001-c"].state == "RUNNING"
    with pytest.raises(RuntimeError, match="task_provider"):
        jdur.recovery.build_restore_records(jstate, None)


# ------------------------------------------------ the checkpoint-following budget
def _tiny_state(step, seed=0):
    torch.manual_seed(seed)
    params = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.randn(3))})
    return {"params": params, "opt_state": torch.optim.SGD(params.values(), lr=0.1),
            "step": step}


@pytest.mark.parametrize("ckpt_step,named_by", [(30, "admission"), (20, "admission"),
                                               (30, "publication"), (None, "admission"),
                                               ("corrupt", "admission")])
def test_a_resumed_budget_follows_the_checkpoint(tmp_path, ckpt_step, named_by):
    """The journal counts 25 of 60 batches; the job's checkpoint is at step
    30 (saved, its commit lost), 20 (the last write did not land), absent or
    corrupt. The job resumes at 60 less the verified step, and the
    difference is journaled as task_progress; without a sound checkpoint
    the journal's count holds."""
    wal, path = str(tmp_path / "wal"), str(tmp_path / "t.pt")
    j = dur.Journal(wal)
    j.append("job_submitted", job="j0001-t", task="t", total_batches=60, spec={})
    j.append("job_admission", job="j0001-t", task="t", decision="admit", reason="ok",
             trials_run=0, weight=1.0, static_prior=False, tenant="default",
             **({"ckpt_path": path} if named_by == "admission" else {}))
    j.append("task_progress", task="t", job="j0001-t", batches=25)
    if named_by == "publication":
        j.append("ckpt_published", task="t", path=path)
    j.commit()
    j.close()
    if isinstance(ckpt_step, int):
        ckpt.save(path, _tiny_state(ckpt_step))
    elif ckpt_step == "corrupt":
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 not a checkpoint")
    remaining = []

    def provide(spec):
        remaining.append(spec["remaining_batches"])
        return F.FakeTask("t", spec["remaining_batches"], [1], F.RecordingTech())

    svc = service.SaturnService(topology=topo(1), durability_dir=wal, task_provider=provide)
    svc.journal.close()
    want = 60 - (ckpt_step if isinstance(ckpt_step, int) else 25)
    assert remaining == [want]
    progress = [r["data"]["batches"] for r in dur.replay(wal, strict=True)
                if r["kind"] == "task_progress"]
    assert sum(progress) == 60 - want
    assert jdur.replay_service_state(wal).jobs["j0001-t"].realized == 60 - want
    if ckpt_step == "corrupt":
        assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


# ------------------------------------------------------------- kill-replay
#: An interval runs 50 batches a job (0.2 s over 0.004 s), and each of the
#: first two kills leaves at most one interval of it durable (mid-interval at
#: the second interval; the mid-fsync tear takes only the last record of
#: interval 1's commits). Every budget is over 100, so the post-checkpoint
#: kill always finds work left: at 90 and 60 how many commits the second
#: incarnation made before its tear decided whether any was.
TOTALS = {"job-a": 150, "job-b": 150, "job-c": 120, "job-d": 120}
PRIORITIES = {"job-a": 0.0, "job-b": 1.0, "job-c": 2.0, "job-d": 3.0}


def _kr_service(wal, tech, barrier=None):
    def provide(spec):
        return F.FakeTask(spec["task"], spec["remaining_batches"], spec["spec"]["sizes"], tech,
                          pbt=0.004)

    return service.SaturnService(topology=topo(8), interval=0.2, poll_s=0.02,
                                 durability_dir=wal, task_provider=provide,
                                 crash_barrier=barrier)


def _killed_incarnation(wal, tech, point, hit, submit=False):
    """One incarnation killed at (point, hit): the injector is armed before
    ``start()`` (after the constructor's own commits), so the kill cannot
    race the loop's first barriers."""
    inj = res.CrashInjector(point, hit=hit, armed=False)
    svc = _kr_service(wal, tech, inj.barrier)
    inj.arm()
    svc.start()
    ids = {}
    if submit:
        client = service.ServiceClient(svc)
        for name, total in TOTALS.items():
            ids[name] = client.submit(F.FakeTask(name, total, [2], tech, pbt=0.004),
                                      priority=PRIORITIES[name], spec={"sizes": [2]})
    res.run_to_kill(inj, svc)
    assert svc.killed
    svc.stop(timeout=10)  # a killed loop raises nothing
    return svc, ids


def test_kill_replay_loses_no_job_and_runs_no_iteration_twice(tmp_path):
    wal = str(tmp_path / "wal")
    tech = F.RecordingTech(per_batch=0.004)
    _, ids = _killed_incarnation(wal, tech, "mid-interval", 2, submit=True)
    _killed_incarnation(wal, tech, "mid-fsync", 2)
    svc3 = _kr_service(wal, tech)
    assert svc3.journal.recovery_report["quarantined"]  # the torn tail, on the next open
    svc3.journal.close()
    _killed_incarnation(wal, tech, "post-checkpoint", 1)
    svc4 = _kr_service(wal, tech).start()
    client = service.ServiceClient(svc4)
    try:
        outs = {n: client.wait(j, timeout=120) for n, j in ids.items()}
    finally:
        svc4.stop(timeout=60)
    assert all(o["state"] == "DONE" for o in outs.values()), outs
    assert {o["job_id"] for o in outs.values()} == set(ids.values())
    recs = dur.replay(wal, strict=True)
    assert recs == jdur.replay(wal, strict=True)
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(set(seqs))
    progress = {}
    for r in recs:
        if r["kind"] == "task_progress":
            progress[r["data"]["task"]] = progress.get(r["data"]["task"], 0) + r["data"]["batches"]
    assert progress == TOTALS
    assert any(r["kind"] == "job_recovered" for r in recs)
    assert [r["data"]["incarnation"] for r in recs if r["kind"] == "recovery"] == [1, 2, 3, 4, 5]
    assert any(".corrupt" in n for n in os.listdir(wal))
    done = {r["data"]["job"] for r in recs
            if r["kind"] == "job_state" and r["data"]["state"] == "DONE"}
    assert done == set(ids.values())
    assert {k: j.realized for k, j in jdur.replay_service_state(wal).jobs.items()} == {
        ids[n]: t for n, t in TOTALS.items()}


def test_recovery_without_a_provider_refuses_to_drop_jobs(tmp_path):
    wal = str(tmp_path / "wal")
    tech = F.RecordingTech()
    inj = res.CrashInjector("mid-interval", hit=1, armed=False)
    svc = _kr_service(wal, tech, inj.barrier)
    inj.arm()
    svc.start()
    service.ServiceClient(svc).submit(F.FakeTask("orphan", 200, [2], tech), spec={"sizes": [2]})
    res.run_to_kill(inj, svc)
    with pytest.raises(RuntimeError, match="task_provider"):
        service.SaturnService(topology=topo(8), durability_dir=wal)


def test_the_cli_prints_the_queue(tmp_path):
    mpath = str(tmp_path / "m.jsonl")
    tech = F.RecordingTech()
    svc = _service(metrics_path=mpath).start()
    client = service.ServiceClient(svc)
    try:
        jdone = client.submit(F.FakeTask("done", 20, [2], tech))
        client.wait(jdone, timeout=60)
        jc = svc.queue.submit(JobRequest(F.FakeTask("gone", 20, [2], tech))).job_id
        svc.queue.cancel(jc)
    finally:
        svc.stop(timeout=30)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-m", "saturn_tpu_torch.service", mpath],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    rows = {line.split()[1]: line.split()[2] for line in out.stdout.splitlines()[1:-1]}
    assert rows == {"done": "DONE", "gone": "EVICTED"}
    assert out.stdout.splitlines()[-1].startswith("queue depth:")
    from saturn_tpu_torch.service import client as tclient

    assert tclient.main([mpath, "--events"]) == 0


# ---------------------------------------------------------------- end to end
SEQ, BATCH, N_BATCHES = 16, 2, 8
NAMES = (("svc-a", 1e-3, 1.0), ("svc-b", 2e-3, 0.0), ("svc-c", 5e-4, 3.0))
_JAX_INIT = {}


def _jax_init_state_dict():
    if "sd" not in _JAX_INIT:
        import jax

        params = j_build_gpt2("test-tiny", seq_len=SEQ).init_fn(jax.random.PRNGKey(0))
        _JAX_INIT["sd"] = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return _JAX_INIT["sd"]


def _spec(**kw):
    spec = build_gpt2("test-tiny", seq_len=SEQ, **kw)
    sd = _jax_init_state_dict()

    def init_fn(generator=None, device=None):
        model = spec.meta_init_fn().to_empty(device=device or "cpu")
        model.load_state_dict(sd)
        return model

    return dataclasses.replace(spec, init_fn=init_fn)


def _loader():
    return make_lm_dataset(context_length=SEQ, batch_size=BATCH, vocab_size=256,
                           n_tokens=SEQ * BATCH * N_BATCHES)


def test_tiny_jobs_end_where_the_jax_service_ends_them(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from saturn_tpu.ops import ce as jce

    # the JAX side's CE head in interpret mode (tests/test_torch_window.py)
    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))
    # both packages forecast from the profiled 1 s a batch
    monkeypatch.setattr(sat.Task, "apply_realized_feedback", lambda self: None)
    monkeypatch.setattr(JTask, "apply_realized_feedback", lambda self: None)

    tech, jtech = DataParallel(), JDataParallel()
    tasks, jtasks = [], []
    for name, lr, _ in NAMES:
        t = sat.Task(get_model=_spec, get_dataloader=_loader, loss_fn=pretraining_loss,
                     hparams=sat.HParams(lr=lr, batch_count=N_BATCHES,
                                         kwargs={"dtype": torch.float32}),
                     name=name, save_dir=str(tmp_path / "ck"))
        t.strategies = {1: sat.Strategy(tech, 1, {"remat": False}, 1.0 * N_BATCHES, 1.0)}
        tasks.append(t)
        jt = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", seq_len=SEQ,
                                                       dtype=jnp.float32, **kw),
                   get_dataloader=lambda: j_make_lm_dataset(context_length=SEQ,
                                                            batch_size=BATCH, vocab_size=256,
                                                            n_tokens=SEQ * BATCH * N_BATCHES),
                   loss_fn=j_pretraining_loss, hparams=JHParams(lr=lr, batch_count=N_BATCHES),
                   name=name, save_dir=str(tmp_path / "jck"))
        jt.strategies = {1: JStrategy(jtech, 1, {}, 1.0 * N_BATCHES, 1.0)}
        jtasks.append(jt)

    def run(p, topology, ts, mpath):
        svc = p.Service(topology=topology, interval=3.5, solver_time_limit=2.0, poll_s=0.02,
                        metrics_path=mpath)
        ids = [svc.queue.submit(p.JobRequest(t, priority=prio)).job_id
               for t, (_, _, prio) in zip(ts, NAMES)]
        svc.start()
        client = p.Client(svc)
        try:
            return [client.wait(j, timeout=300) for j in ids]
        finally:
            svc.stop(timeout=120)

    outs = run(T, SliceTopology([torch.device("cpu")]), tasks, str(tmp_path / "m.jsonl"))
    jmpath = str(tmp_path / "jm.jsonl")
    jouts = run(PKGS["jax"], JSliceTopology(jax.devices()[:1]), jtasks, jmpath)
    assert [o["state"] for o in outs] == [o["state"] for o in jouts] == ["DONE"] * 3
    starts = sorted(outs, key=lambda o: o["started_at"])
    jstarts = sorted(jouts, key=lambda o: o["started_at"])
    assert [o["task"] for o in starts] == [o["task"] for o in jstarts]
    jlast = {e["task"]: e["loss"] for e in j_read_events(jmpath, kind="task_interval")}
    got = [t.last_losses[-1] for t in tasks]
    want = [jlast[name] for name, _, _ in NAMES]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == N_BATCHES
