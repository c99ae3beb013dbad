"""The port's grow coordinator, defragmentation waves and the service's grow
and defrag paths against the JAX package (the cases of
``tests/test_grow.py``), on CPU topologies with duck-typed tasks.

- The monitor's blink hysteresis: the same ``poll`` answers.
- ``plan_defrag_wave``: the same waves (moves, admitted gangs, still
  blocked) on the same scenarios, deterministic.
- ``GrowCoordinator``: the occupancy gate's verdicts (the per-size need
  priced by ``replan.static_need`` where the JAX package asks memlens),
  ``defrag_due``, ``note_grow`` ending the guardian's backoffs, a wave's
  two-phase journal and its rollback.
- Admission's ``revisit_on`` classes, the DEFER pool and its reconciliation
  after a cancel.
- Kills at ``defrag.pre-publish`` / ``pre-commit`` / ``post-commit``: every
  intent closes exactly once on replay, and both packages' folds agree; a
  seeded flap-storm campaign's journal is the same on two runs and on both
  packages.
- The service: a blocked gang drains through a defrag wave, the same
  scenario killed in the wave recovers without losing a job, and a benched
  job re-admits on a grow.

Tolerances: none.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from saturn_tpu import durability as jdur
from saturn_tpu import resilience as jres
from saturn_tpu.core.mesh import Block as JBlock
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.core.technique import BaseTechnique as JBaseTechnique
from saturn_tpu.service import admission as jadmission
from saturn_tpu.service import queue as jqueue
from saturn_tpu_torch import durability as dur
from saturn_tpu_torch import resilience as res
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.service import SaturnService, ServiceClient
from saturn_tpu_torch.service import admission, queue

pytestmark = pytest.mark.grow

CAP = 100          # modeled per-device memory (SATURN_TPU_HBM_BYTES)
PIN = 60           # bytes each live task pins
NEED = 80          # bytes the blocked gang needs per device


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_HBM_BYTES", str(CAP))
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_GROW_POLL", "SATURN_TPU_SOLVE_DEADLINE",
                 "SATURN_TPU_WATCHDOG", "SATURN_TPU_GROW_HYSTERESIS"):
        monkeypatch.delenv(name, raising=False)


def _fakes(strategy_cls, technique_cls):
    class RecordingTech(technique_cls):
        name = "grow-fake"

        def __init__(self, per_batch=0.001):
            self.per_batch = per_batch
            self.calls = []
            self.lock = threading.Lock()

        def execute(self, task, devices, tid, override_batch_count=None):
            with self.lock:
                self.calls.append((task.name, override_batch_count or 1))
            time.sleep(self.per_batch * (override_batch_count or 1))

        def search(self, task, devices, tid):
            return {}, self.per_batch

    class PinnedTask:
        """A task whose live state pins ``resident`` bytes per device while
        ``_live_state`` is set."""

        def __init__(self, name, sizes, resident=0, tech=None, total_batches=10, pbt=0.001):
            self.name = name
            self.total_batches = total_batches
            self.current_batch = 0
            self.epoch_length = 1000
            self.hints = {"resident_bytes": resident} if resident else {}
            self.chip_range = None
            tech = tech or RecordingTech(pbt)
            self.strategies = {g: strategy_cls(tech, g, {}, pbt * total_batches, pbt)
                               for g in sizes}
            self.selected_strategy = None
            if resident:
                self._live_state = object()
            self.released = 0

        def feasible_strategies(self):
            return {g: s for g, s in self.strategies.items() if s.feasible}

        def select_strategy(self, g):
            self.selected_strategy = self.strategies[g]

        def reconfigure(self, n):
            self.current_batch = (self.current_batch + n) % self.epoch_length

        def release_live_state(self):
            self._live_state = None
            self.released += 1

    return RecordingTech, PinnedTask


class _Dev:
    platform = "cpu"
    process_index = 0


class _Slot:
    def __init__(self, block):
        self.block = block


class FakePlan:
    def __init__(self, assignments):
        self.assignments = assignments


def _pkg(name):
    if name == "torch":
        tech, task = _fakes(Strategy, BaseTechnique)
        return SimpleNamespace(res=res, dur=dur, Block=Block, tech=tech, task=task,
                               admission=admission, queue=queue,
                               topo=lambda n=8: SliceTopology([torch.device("cpu")] * n))
    tech, task = _fakes(JStrategy, JBaseTechnique)
    return SimpleNamespace(res=jres, dur=jdur, Block=JBlock, tech=tech, task=task,
                           admission=jadmission, queue=jqueue,
                           topo=lambda n=8: JSliceTopology([_Dev() for _ in range(n)],
                                                           slice_size=n))


PKGS = {name: _pkg(name) for name in ("torch", "jax")}
T = PKGS["torch"]


def _scenario(p):
    """Two live tasks pin opposite ends of the ring; a 4-device gang with
    NEED bytes per device fits nowhere until one victim relocates."""
    a = p.task("live-a", (2,), resident=PIN)
    b = p.task("live-b", (2,), resident=PIN)
    gang = p.task("gang-big", (4,), resident=NEED)
    plan = FakePlan({"live-a": _Slot(p.Block(0, 2)), "live-b": _Slot(p.Block(4, 2))})
    return [a, b], gang, plan


def _heavy(p):
    a = p.task("heavy-a", (4,), resident=90)
    b = p.task("heavy-b", (4,), resident=90)
    gang = p.task("gang", (4,), resident=NEED)
    return [a, b], gang, FakePlan({"heavy-a": _Slot(p.Block(0, 4)),
                                   "heavy-b": _Slot(p.Block(4, 4))})


def _unpinned(p):
    free = p.task("free", (4,), resident=0)
    gang = p.task("gang", (4,), resident=NEED)
    return [free], gang, FakePlan({"free": _Slot(p.Block(0, 4))})


def _halving(p):
    """A victim that has to halve its block to make room."""
    a = p.task("wide", (4, 2), resident=30)
    b = p.task("small", (2,), resident=50)
    gang = p.task("gang", (8, 4), resident=70)
    return [a, b], gang, FakePlan({"wide": _Slot(p.Block(0, 4)),
                                   "small": _Slot(p.Block(4, 2))})


# --------------------------------------------------------- hysteresis blink
def blink_grow(m):
    mon = m.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([4, 5], cause="slice_preemption")
    mon.mark_restored([4, 5])
    return [mon.poll(), mon.poll()]


def blink_then_loss(m):
    mon = m.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([4], cause="slice_preemption")
    mon.mark_restored([4])
    mon.mark_lost([6], cause="device_loss")
    return [mon.poll(), mon.poll()]


def blink_reloss(m):
    mon = m.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([4], cause="slice_preemption")
    mon.mark_restored([4])
    mon.mark_lost([4], cause="device_loss")
    return [mon.poll(), mon.poll(), mon.alive_indices()]


def surfaced_reloss(m):
    mon = m.FleetHealthMonitor(8, grow_hysteresis=2)
    mon.mark_lost([4], cause="device_loss")
    out = [mon.poll()]
    mon.mark_restored([4])
    mon.mark_lost([4], cause="device_loss")
    return out + [mon.poll(), mon.poll()]


def _changes(out):
    return [(c.kind, tuple(c.lost), tuple(c.gained)) if hasattr(c, "kind") else c for c in out]


@pytest.mark.parametrize("script", [blink_grow, blink_then_loss, blink_reloss, surfaced_reloss])
def test_blink_hysteresis_matches_jax(script):
    got, want = _changes(script(res)), _changes(script(jres))
    assert got == want
    if script is blink_grow:
        assert got == [None, ("grow", (), (4, 5))]


# ------------------------------------------------------------ defrag planner
def _wave(p, scenario, cap=CAP):
    live, gang, plan = scenario(p)
    w = p.res.plan_defrag_wave([gang], live, p.topo(8), plan, p.res.default_resident_bytes,
                               cap_bytes=cap)
    return ([(m.task, m.from_block, m.to_block, m.pinned_bytes) for m in w.moves],
            dict(w.admitted), list(w.still_blocked), w.empty)


@pytest.mark.parametrize("scenario", [_scenario, _heavy, _unpinned, _halving])
@pytest.mark.parametrize("cap", [CAP, 0])
def test_defrag_wave_matches_jax(scenario, cap):
    got = _wave(T, scenario, cap)
    assert got == _wave(PKGS["jax"], scenario, cap)
    assert got == _wave(T, scenario, cap)  # deterministic


def test_defrag_wave_relocates_a_victim_and_admits_the_gang():
    moves, admitted, blocked, empty = _wave(T, _scenario)
    assert admitted == {"gang-big": (0, 4)} and blocked == []
    assert moves == [("live-a", (0, 2), (6, 2), PIN)]
    assert _wave(T, _scenario, cap=0) == ([], {}, ["gang-big"], True)
    assert _wave(T, _heavy)[0] == [] and _wave(T, _heavy)[2] == ["gang"]
    assert _wave(T, _unpinned)[:2] == ([], {"gang": (0, 4)})


# ------------------------------------------------------- grow coordinator
@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_occupancy_gate_blocks_then_opens_after_a_wave(tmp_path, pkg):
    p = PKGS[pkg]
    live, gang, plan = _scenario(p)
    jnl = p.dur.Journal(str(tmp_path / "wal"))
    coord = p.res.GrowCoordinator(journal=jnl, poll_every=0)
    gate = coord.occupancy_gate(lambda: live + [gang], lambda: plan)
    assert gate(gang, p.topo(8)) == {"fits": False, "free_bytes": CAP - PIN, "need_bytes": NEED}
    wave = coord.plan_wave([gang], live, p.topo(8), plan)
    wid = coord.execute_wave(wave, {t.name: t for t in live}, 3, publish_fn=lambda t: True)
    assert wid == "wave-3-1" and live[0].released == 1
    assert gate(gang, p.topo(8))["fits"] is True
    jnl.close()
    kinds = [r["kind"] for r in p.dur.replay(str(tmp_path / "wal"))]
    assert kinds.count("migration_intent") == 1 and kinds.count("migration_done") == 1
    assert "defrag_wave" in kinds


def test_occupancy_gate_prices_the_need_per_gang_size(monkeypatch):
    """A smaller gang holds its state over fewer devices and needs more per
    device: each size is priced on its own (``static_need``, the port's
    stand-in for memlens' ``migration_fits``)."""
    from saturn_tpu_torch.resilience import grow

    per_size_need = {4: 50, 2: 110}
    monkeypatch.setattr(grow, "static_need",
                        lambda task, topology, g, cap: {"peak_bytes": per_size_need[g]})
    live = [T.task("live-a", (2,), resident=PIN), T.task("live-b", (2,), resident=PIN)]
    gang = T.task("gang", (2, 4), resident=NEED)
    plan = FakePlan({"live-a": _Slot(Block(0, 2)), "live-b": _Slot(Block(4, 2))})
    coord = res.GrowCoordinator(poll_every=0)
    verdict = coord.occupancy_gate(lambda: live, lambda: plan)(gang, T.topo(8))
    assert verdict is not None and verdict["fits"] is False
    per_size_need[2] = 90
    verdict = coord.occupancy_gate(lambda: live, lambda: plan)(gang, T.topo(8))
    assert verdict["fits"] is True and verdict["need_bytes"] == 90


def test_static_need_reads_the_measured_peak_or_the_state():
    """The static estimate: the trial's measured peak, else the technique's
    fp32 state; None without a technique that counts its state."""

    class Counting(T.tech):
        def state_bytes(self, task, config):
            return 40

    t = T.task("t", (1, 2), tech=Counting())
    topo = T.topo(8)
    assert res.replan.static_need(t, topo, 1, CAP) == {"fits": True, "peak_bytes": 40,
                                                       "capacity_bytes": CAP}
    t.strategies[2].peak_bytes = 95
    assert res.replan.static_need(t, topo, 2, CAP)["fits"] is False
    assert res.replan.static_need(t, topo, 1, 0) is None
    assert res.replan.static_need(T.task("u", (1,)), topo, 1, CAP) is None


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_occupancy_gate_fails_open(monkeypatch, pkg):
    p = PKGS[pkg]
    live, gang, plan = _scenario(p)
    coord = p.res.GrowCoordinator(poll_every=0)
    assert coord.occupancy_gate(lambda: live, lambda: None)(gang, p.topo(8)) is None
    assert coord.occupancy_gate(lambda: [], lambda: FakePlan({}))(gang, p.topo(8)) is None
    monkeypatch.delenv("SATURN_TPU_HBM_BYTES", raising=False)
    assert coord.occupancy_gate(lambda: live, lambda: plan)(gang, p.topo(8)) is None


@pytest.mark.parametrize("interval,grew", [(1, True), (1, False), (4, False), (8, False),
                                           (0, False)])
def test_defrag_due_matches_jax(interval, grew):
    for poll in (4, 0):
        got = res.GrowCoordinator(poll_every=poll).defrag_due(interval, grew)
        assert got == jres.GrowCoordinator(poll_every=poll).defrag_due(interval, grew)


def test_note_grow_ends_the_guardians_backoffs(tmp_path):
    from saturn_tpu_torch.health import GuardianConfig, TrainingGuardian

    jnl = dur.Journal(str(tmp_path / "wal"))
    g = TrainingGuardian(GuardianConfig(backoff_base=64, backoff_cap=64), journal=jnl)
    g._benched["parked-a"] = 99
    g._benched["parked-b"] = 120
    streaks = {("parked-a", "nonfinite"): 2}
    g._streak.update(streaks)
    coord = res.GrowCoordinator(journal=jnl, poll_every=0)
    mon = res.FleetHealthMonitor(8, grow_hysteresis=1)
    mon.mark_lost([7])
    mon.poll()
    mon.mark_restored([7])
    change = mon.poll()
    assert coord.note_grow(change, 5, guardian=g, n_deferred=2, capacity=8) == [
        "parked-a", "parked-b"]
    assert not g.benched("parked-a", 5) and g._streak == streaks
    jnl.close()
    recs = dur.replay(str(tmp_path / "wal"))
    (ge,) = [r["data"] for r in recs if r["kind"] == "grow_event"]
    assert ge["gained"] == [7] and ge["n_parked"] == 2
    assert ge["unbenched"] == ["parked-a", "parked-b"]
    (ub,) = [r["data"] for r in recs if r["kind"] == "health_unbench"]
    assert ub == {"tasks": ["parked-a", "parked-b"], "cause": "grow"}


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_publish_failure_rolls_back_without_touching_state(tmp_path, pkg):
    p = PKGS[pkg]
    live, gang, plan = _scenario(p)
    jnl = p.dur.Journal(str(tmp_path / "wal"))
    coord = p.res.GrowCoordinator(journal=jnl, poll_every=0)
    wave = coord.plan_wave([gang], live, p.topo(8), plan)
    coord.execute_wave(wave, {t.name: t for t in live}, 1, publish_fn=lambda t: False)
    assert live[0].released == 0
    jnl.close()
    kinds = [r["kind"] for r in p.dur.replay(str(tmp_path / "wal"))]
    assert "migration_rollback" in kinds and "migration_done" not in kinds
    for fold in (dur.replay_service_state, jdur.replay_service_state):
        assert fold(str(tmp_path / "wal")).pending_migrations == {}


# ------------------------------------------------------ admission revisit_on
def _ctrl(p, t, journal=None):
    q = p.queue.SubmissionQueue()
    ctrl = p.admission.AdmissionController(t, q)
    ctrl.journal = journal
    return ctrl, q


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_degraded_topology_defers_with_grow_revisit(pkg):
    p = PKGS[pkg]
    ctrl, q = _ctrl(p, p.topo(8))
    rec = q.submit(p.queue.JobRequest(p.task("d", (8,))))
    dec = ctrl.admit(rec, p.topo(4))
    assert dec.action == "defer" and dec.revisit_on == "grow"
    assert ctrl.deferred[rec.job_id]["revisit_on"] == "grow"


def _occupancy_trail(p, root):
    t8 = p.topo(8)
    jnl = p.dur.Journal(root)
    ctrl, q = _ctrl(p, t8, journal=jnl)
    ctrl.occupancy_gate = lambda task, topology: {"fits": False, "free_bytes": 40,
                                                  "need_bytes": NEED}
    rec = q.submit(p.queue.JobRequest(p.task("gang", (4,))))
    decs = [ctrl.admit(rec, t8)]
    first_at = ctrl.deferred[rec.job_id]["deferred_at"]
    q.requeue(rec)
    decs.append(ctrl.admit(rec, t8))  # the same grounds: no new record
    count = ctrl.deferred[rec.job_id]["count"]
    same_at = ctrl.deferred[rec.job_id]["deferred_at"] == first_at
    ctrl.occupancy_gate = lambda task, topology: {"fits": True, "free_bytes": CAP,
                                                  "need_bytes": NEED}
    q.requeue(rec)
    decs.append(ctrl.admit(rec, t8))
    jnl.commit()
    jnl.close()
    deferred = [r["data"]["revisit_on"] for r in p.dur.replay(root)
                if r["kind"] == "job_deferred"]
    return ([(d.action, d.reason, d.revisit_on) for d in decs], count, same_at,
            rec.job_id in ctrl.deferred, deferred)


def test_occupancy_defers_with_defrag_revisit_and_journal_dedup(tmp_path):
    got = _occupancy_trail(T, str(tmp_path / "wal"))
    assert got == _occupancy_trail(PKGS["jax"], str(tmp_path / "jwal"))
    decs, count, same_at, pooled, deferred = got
    assert [d[0] for d in decs] == ["defer", "defer", "admit"]
    assert "occupancy" in decs[0][1] and decs[0][2] == "defrag"
    assert count == 2 and same_at and not pooled and deferred == ["defrag"]


def test_an_occupancy_gate_that_raises_fails_open():
    ctrl, q = _ctrl(T, T.topo(8))

    def boom(task, topology):
        raise RuntimeError("gate crashed")

    ctrl.occupancy_gate = boom
    rec = q.submit(queue.JobRequest(T.task("ok", (2,))))
    assert ctrl.admit(rec, T.topo(8)).action == "admit"


def _deferred_job(svc, name):
    rec = svc.queue.submit(queue.JobRequest(T.task(name, (4,), resident=NEED)))
    svc.admission.occupancy_gate = lambda task, topology: {"fits": False, "free_bytes": 0,
                                                           "need_bytes": NEED}
    svc.admission.begin_pass()
    assert svc.admission.admit(rec, T.topo(8)).action == "defer"
    svc.queue.requeue(rec)
    assert rec.job_id in svc.admission.deferred
    return rec


def test_a_queue_side_cancel_reconciles_the_defer_pool():
    svc = SaturnService(topology=T.topo(8), interval=0.2, poll_s=0.01)
    rec = _deferred_job(svc, "gang-cancel-q")
    assert svc.queue.cancel(rec.job_id) is True
    svc._drain_arrivals({}, T.topo(8), 0, None)
    assert rec.job_id not in svc.admission.deferred


def test_a_cancel_flag_in_the_drain_pops_the_pool_entry():
    svc = SaturnService(topology=T.topo(8), interval=0.2, poll_s=0.01)
    rec = _deferred_job(svc, "gang-cancel-flag")
    rec.cancel_requested = True
    svc._drain_arrivals({}, T.topo(8), 0, None)
    assert rec.state is queue.JobState.EVICTED and rec.error == "cancelled"
    assert rec.job_id not in svc.admission.deferred


# --------------------------------------------------------------- kill-replay
def _run_wave(p, wal, barrier=None, publish=True):
    live, gang, plan = _scenario(p)
    jnl = p.dur.Journal(wal, barrier=barrier)
    coord = p.res.GrowCoordinator(journal=jnl, poll_every=0)
    wave = coord.plan_wave([gang], live, p.topo(8), plan)

    def publish_fn(task):
        if not publish:
            return False
        jnl.log("ckpt_published", task=task.name, path="ck", wave_republish=True)
        return True

    coord.execute_wave(wave, {t.name: t for t in live}, 7, publish_fn=publish_fn)
    jnl.close()


def _recover_and_close(wal):
    """The service's recovery closure, once per open intent."""
    state = dur.replay_service_state(wal)
    resume, rollback = state.resolve_pending_migrations()
    jnl = dur.Journal(wal)
    for rec in resume:
        jnl.log("migration_done", wave=rec["wave"], task=rec["task"], recovered=True)
    for rec in rollback:
        jnl.log("migration_rollback", wave=rec["wave"], task=rec["task"], cause="recovery",
                recovered=True)
    jnl.close()
    return resume, rollback


def _folds(wal):
    out = []
    for fold in (dur.replay_service_state, jdur.replay_service_state):
        s = fold(wal)
        out.append((s.pending_migrations, s.migrations_done, s.migrations_rolled_back,
                    s.defrag_waves, s.last_ckpt_seq))
    return out


@pytest.mark.parametrize("point,resumed", [("defrag.pre-publish", 0), ("defrag.pre-commit", 1),
                                           ("defrag.post-commit", None)])
def test_a_kill_in_a_wave_closes_each_intent_once(tmp_path, point, resumed):
    wal = str(tmp_path / "wal")
    with pytest.raises(res.SimulatedKill):
        _run_wave(T, wal, barrier=res.CrashInjector(point).barrier)
    got, want = _folds(wal)
    assert got == want
    if resumed is None:  # migration_done committed before the kill
        assert got[0] == {} and got[1] == 1
    else:
        assert len(got[0]) == 1
        resume, rollback = _recover_and_close(wal)
        assert (len(resume), len(rollback)) == (resumed, 1 - resumed)
        got, want = _folds(wal)
        assert got == want and got[0] == {}
    assert _recover_and_close(wal) == ([], [])  # a second replay closes nothing
    dur.replay(wal, strict=True)
    jdur.replay(wal, strict=True)


POINTS = ("defrag.pre-publish", "defrag.pre-commit", "defrag.post-commit")


def _campaign(p, wal, seed):
    """A flap storm (one shrink, one grow), a seeded kill in a wave, the
    recovery's closure and the backlog drain."""
    mon = p.res.FleetHealthMonitor(8, grow_hysteresis=2)
    surfaced = []
    mon.mark_lost([6, 7], cause="slice_preemption")
    surfaced.append(mon.poll())
    for _ in range(3):
        mon.mark_restored([6, 7])
        surfaced.append(mon.poll())
        mon.mark_lost([6, 7], cause="slice_preemption")
        surfaced.append(mon.poll())
    mon.mark_restored([6, 7])
    surfaced.append(mon.poll())
    surfaced.append(mon.poll())
    changes = [c for c in surfaced if c is not None]
    assert [c.kind for c in changes] == ["shrink", "grow"]
    jnl = p.dur.Journal(wal)
    p.res.GrowCoordinator(journal=jnl, poll_every=0).note_grow(changes[-1], 9, n_deferred=1,
                                                               capacity=8)
    inj = p.res.CrashInjector.seeded(seed, max_hit=1, points=POINTS)
    live, gang, plan = _scenario(p)
    jnl2 = p.dur.Journal(wal, barrier=inj.barrier)
    coord2 = p.res.GrowCoordinator(journal=jnl2, poll_every=0)
    wave = coord2.plan_wave([gang], live, p.topo(8), plan)

    def publish_fn(task):
        jnl2.log("ckpt_published", task=task.name, path="ck", wave_republish=True)
        return True

    with pytest.raises(p.res.SimulatedKill):
        coord2.execute_wave(wave, {t.name: t for t in live}, 9, publish_fn=publish_fn)
    state = p.dur.replay_service_state(wal)
    resume, rollback = state.resolve_pending_migrations()
    jnl3 = p.dur.Journal(wal)
    for rec in resume:
        jnl3.log("migration_done", wave=rec["wave"], task=rec["task"], recovered=True)
    for rec in rollback:
        jnl3.log("migration_rollback", wave=rec["wave"], task=rec["task"], cause="recovery",
                 recovered=True)
    p.res.GrowCoordinator(journal=jnl3, poll_every=0).note_drained([gang.name], 10,
                                                                   trigger="grow")
    jnl3.close()


def _trajectory(wal):
    return [(r["kind"], json.dumps(r["data"], sort_keys=True)) for r in dur.replay(wal)
            if r["kind"] not in ("segment_open", "recovery")]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_kill_campaign(tmp_path, seed):
    """Zero lost jobs (every intent closed once), zero duplicate drains, the
    same journal on two runs of a seed and on the JAX package's run."""
    wal_a, wal_b, wal_j = (str(tmp_path / f"{k}{seed}") for k in "abj")
    _campaign(T, wal_a, seed)
    _campaign(T, wal_b, seed)
    _campaign(PKGS["jax"], wal_j, seed)
    state = dur.replay_service_state(wal_a)
    assert state.pending_migrations == {}
    assert state.migrations_done + state.migrations_rolled_back >= 1
    closures = {}
    for r in dur.replay(wal_a):
        if r["kind"] in ("migration_done", "migration_rollback"):
            key = (r["data"]["wave"], r["data"]["task"])
            closures[key] = closures.get(key, 0) + 1
    assert closures and all(n == 1 for n in closures.values())
    drained = [j for r in dur.replay(wal_a) if r["kind"] == "backlog_drain"
               for j in r["data"]["jobs"]]
    assert drained == sorted(set(drained))
    assert _trajectory(wal_a) == _trajectory(wal_b) == _trajectory(wal_j)


# --------------------------------------------------------- recovery folding
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_grow_records_fold_on_both_packages(tmp_path, writer):
    wal = str(tmp_path / "wal")
    j = PKGS[writer].dur.Journal(wal)
    j.append("grow_event", interval=2, gained=[7], cause="device_return")
    j.append("backlog_drain", interval=2, jobs=["j1", "j2"], trigger="grow")
    j.append("job_deferred", job="j9", task="t9", tenant="acme", reason="occupancy",
             revisit_on="defrag", at=1.0)
    j.append("defrag_wave", wave="wave-3-4", interval=3, moves=[], rolled_back=[],
             admitted={}, still_blocked=[])
    j.commit()
    j.close()
    for fold in (dur.replay_service_state, jdur.replay_service_state):
        s = fold(wal)
        assert (s.grow_events, s.backlog_drained, s.defrag_waves) == (1, 2, 4)
        assert s.deferred["j9"]["revisit_on"] == "defrag"


def test_the_resolution_arbitrates_on_the_checkpoint_seq():
    s = dur.ServiceRecovery()
    s.pending_migrations[("w", "early")] = {"wave": "w", "task": "early", "seq": 5}
    s.pending_migrations[("w", "late")] = {"wave": "w", "task": "late", "seq": 5}
    s.last_ckpt_seq = {"early": 6, "late": 4}
    resume, rollback = s.resolve_pending_migrations()
    assert [r["task"] for r in resume] == ["early"]
    assert [r["task"] for r in rollback] == ["late"]


# ------------------------------------------------------- service integration
PIN_BATCHES = 600  # 0.6 s of work per pin at 1 ms a batch: three intervals of 0.2 s


def _provider(tech):
    def provide(spec):
        return T.task(spec["task"], spec["spec"]["sizes"], tech=tech,
                      resident=spec["spec"].get("resident", 0),
                      total_batches=spec["remaining_batches"])
    return provide


def _mk_service(wal, barrier=None, provider=None):
    return SaturnService(topology=T.topo(8), interval=0.2, poll_s=0.02, durability_dir=wal,
                         task_provider=provider, crash_barrier=barrier)


def _submit_pins(client, tech):
    return {name: client.submit(T.task(name, (4,), resident=30, tech=tech,
                                       total_batches=PIN_BATCHES),
                                spec={"sizes": [4], "resident": 30})
            for name in ("pin-a", "pin-b")}


def _pins_running_then_gang(svc, client, tech, ids, tmp_path):
    deadline = time.monotonic() + 30
    while not all(client.status(ids[n])["state"] == "RUNNING" for n in ("pin-a", "pin-b")):
        assert time.monotonic() < deadline, "pins never ran"
        time.sleep(0.01)
    # the victims' checkpoints exist and the service knows them (the
    # interval boundary's publication, which the fakes do not write)
    for n in ("pin-a", "pin-b"):
        p = str(tmp_path / f"{n}.pt")
        torch.save({"step": 0}, p)
        svc._last_ckpt[n] = p
    ids["gang"] = client.submit(T.task("gang", (4,), resident=NEED, tech=tech, total_batches=20),
                                spec={"sizes": [4], "resident": NEED})


def test_a_blocked_gang_drains_through_a_defrag_wave(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_GROW_POLL", "1")
    wal = str(tmp_path / "wal")
    tech = T.tech(per_batch=0.001)
    svc = _mk_service(wal, provider=_provider(tech)).start()
    client = ServiceClient(svc)
    try:
        ids = _submit_pins(client, tech)
        _pins_running_then_gang(svc, client, tech, ids, tmp_path)
        outs = {k: client.wait(j, timeout=90) for k, j in ids.items()}
    finally:
        svc.stop(timeout=60)
    assert all(o["state"] == "DONE" for o in outs.values()), outs
    recs = dur.replay(wal, strict=True)
    kinds = [r["kind"] for r in recs]
    assert "job_deferred" in kinds
    assert "migration_intent" in kinds and "migration_done" in kinds and "defrag_wave" in kinds
    # the wave admitted the gang (a wave in the interval of the gang's first
    # defer drains it there, before any backlog_drain could name it)
    waves = [r["data"] for r in recs if r["kind"] == "defrag_wave"]
    assert any("gang" in w["admitted"] for w in waves)
    drains = [j for r in recs if r["kind"] == "backlog_drain" for j in r["data"]["jobs"]]
    assert set(drains) <= {ids["gang"]}
    assert jdur.replay_service_state(wal).pending_migrations == {}


def test_a_kill_in_the_wave_recovers_without_losing_jobs(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_GROW_POLL", "1")
    wal = str(tmp_path / "wal")
    tech = T.tech(per_batch=0.001)
    inj = res.CrashInjector("defrag.pre-commit", hit=1, armed=False)
    svc = _mk_service(wal, barrier=inj.barrier, provider=_provider(tech)).start()
    client = ServiceClient(svc)
    ids = _submit_pins(client, tech)
    _pins_running_then_gang(svc, client, tech, ids, tmp_path)
    res.run_to_kill(inj, svc)
    assert svc.killed
    svc2 = _mk_service(wal, provider=_provider(tech)).start()
    client2 = ServiceClient(svc2)
    try:
        outs = {k: client2.wait(j, timeout=90) for k, j in ids.items()}
    finally:
        svc2.stop(timeout=60)
    assert all(o["state"] == "DONE" for o in outs.values()), outs
    recs = dur.replay(wal, strict=True)
    done = [r["data"] for r in recs if r["kind"] == "migration_done"]
    assert any(d.get("recovered") for d in done)
    closures = {}
    for r in recs:
        if r["kind"] in ("migration_done", "migration_rollback"):
            key = (r["data"]["wave"], r["data"]["task"])
            closures[key] = closures.get(key, 0) + 1
    assert all(n == 1 for n in closures.values()), closures
    for fold in (dur.replay_service_state, jdur.replay_service_state):
        assert fold(wal).pending_migrations == {}


def test_a_benched_job_readmits_on_a_grow(tmp_path):
    """A job the guardian benched for 64 intervals runs again at the grow."""
    from saturn_tpu_torch.health import GuardianConfig, NumericFaultError, TrainingGuardian
    from saturn_tpu_torch.health import sentinel

    class FaultOnceTech(T.tech):
        def __init__(self):
            super().__init__(per_batch=0.002)
            self.faulted = False

        def execute(self, task, devices, tid, override_batch_count=None):
            if task.name == "sick" and not self.faulted:
                self.faulted = True
                raise NumericFaultError(task.name, 0, sentinel.CAUSE_NONFINITE, step=0,
                                        loss=float("nan"), batch_indices=(), bad_count=1)
            super().execute(task, devices, tid, override_batch_count)

    wal = str(tmp_path / "wal")
    t8 = T.topo(8)
    mon = res.FleetHealthMonitor.for_topology(t8)
    injector = res.FaultInjector(schedule=[
        res.FaultEvent(3, res.FaultKind.DEVICE_LOSS, devices=(7,)),
        res.FaultEvent(4, res.FaultKind.DEVICE_RETURN, devices=(7,)),
    ])
    guardian = TrainingGuardian(GuardianConfig(retry_budget=9, backoff_base=64, backoff_cap=64))
    svc = SaturnService(topology=t8, interval=0.2, poll_s=0.02, durability_dir=wal,
                        health_monitor=mon, fault_injector=injector,
                        health_guardian=guardian).start()
    client = ServiceClient(svc)
    t0 = time.monotonic()
    try:
        jid = client.submit(T.task("sick", (2,), tech=FaultOnceTech(), total_batches=40),
                            spec={"sizes": [2]})
        out = client.wait(jid, timeout=60)
    finally:
        svc.stop(timeout=60)
    assert out["state"] == "DONE"
    assert time.monotonic() - t0 < 12.0  # the 64-interval bench alone is about 13 s
    recs = dur.replay(wal)
    kinds = [r["kind"] for r in recs]
    assert "health_backoff" in kinds and "grow_event" in kinds
    (ub,) = [r for r in recs if r["kind"] == "health_unbench"]
    assert ub["data"]["tasks"] == ["sick"]
