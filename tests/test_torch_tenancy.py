"""The port's tenant ledger, the service's tenant gates and the
compile-ahead pool against the JAX package's (the cases of
``tests/test_tenancy.py`` without the gateway and lease, which
``tests/test_torch_gateway.py`` holds).

- ``TenantLedger``: quotas, charges, budgets, fair targets and shares, the
  clamped multiplier, ``restore`` and ``snapshot``: each case runs on both
  packages' ledgers and must give the same answers, and a seeded script of
  charges and live counts gives the same trail on both.
- The admission controller's tenant gates (over-share weight scaling,
  ``max_live_jobs`` within one pass, an exhausted budget) on both
  packages' services: the same decisions, reasons and weights.
- Chip-second charges across a kill: a service killed after a job charged
  its tenant, restarted on the same journal, re-seats the ledger from the
  ``tenant_charge`` records and does not double them; both packages' folds
  of the journal agree.
- ``CompileAheadPool``: the six cases of the JAX suite run on both
  packages' pools with the same answers; one prewarm / acquire sequence
  gives both the same ledger and journal statuses; ``prewarm_build`` keys
  a build by its library's digest name and loads it; a service with a pool
  prewarms at ADMIT and journals ``requested`` / ``ready`` / ``hit``, which
  both packages' ``replay_service_state`` fold alike.

Tolerances: none but float sums, compared to 1e-9.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.core.technique import BaseTechnique as JBaseTechnique
from saturn_tpu.durability import replay_service_state as j_replay_service_state
from saturn_tpu.service import SaturnService as JSaturnService
from saturn_tpu.service.queue import JobRequest as JJobRequest
from saturn_tpu.tenancy import CompileAheadPool as JCompileAheadPool
from saturn_tpu.tenancy import model as jmodel
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.durability import replay_service_state
from saturn_tpu_torch.resilience import CrashInjector, run_to_kill
from saturn_tpu_torch.service import SaturnService, ServiceClient
from saturn_tpu_torch.service.queue import JobRequest
from saturn_tpu_torch.tenancy import CompileAheadPool, model
from saturn_tpu_torch.tenancy.compile_ahead import build_thunks

pytestmark = pytest.mark.service


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG",
                 "SATURN_TPU_HBM_BYTES"):
        monkeypatch.delenv(name, raising=False)


def _fakes(strategy_cls, technique_cls):
    class RecordingTech(technique_cls):
        name = "tenancy-fake"

        def __init__(self, per_batch=0.001):
            self.per_batch = per_batch
            self.lock = threading.Lock()
            self.calls = []

        def execute(self, task, devices, tid, override_batch_count=None):
            with self.lock:
                self.calls.append((task.name, override_batch_count))
            time.sleep(self.per_batch * (override_batch_count or 1))

        def search(self, task, devices, tid):
            return {}, self.per_batch

    class FakeTask:
        def __init__(self, name, total_batches, sizes, tech, pbt=0.001):
            self.name = name
            self.total_batches = total_batches
            self.current_batch = 0
            self.epoch_length = 1000
            self.hints = {}
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

    return RecordingTech, FakeTask


class _Dev:
    pass


PKGS = {
    "torch": SimpleNamespace(
        model=model, Service=SaturnService, JobRequest=JobRequest,
        topo=lambda n=8: SliceTopology([torch.device("cpu")] * n),
        fakes=_fakes(Strategy, BaseTechnique), replay_service_state=replay_service_state),
    "jax": SimpleNamespace(
        model=jmodel, Service=JSaturnService, JobRequest=JJobRequest,
        topo=lambda n=8: JSliceTopology([_Dev() for _ in range(n)]),
        fakes=_fakes(JStrategy, JBaseTechnique), replay_service_state=j_replay_service_state),
}


class FakeJournal:
    def __init__(self):
        self.records = []

    def append(self, kind, **data):
        self.records.append((kind, data))

    log = append

    def of(self, kind):
        return [d for k, d in self.records if k == kind]


# ------------------------------------------------------------ the ledger
def case_quota_resolution(m):
    led = m.TenantLedger({"paid": m.TenantQuota(max_live_jobs=4, weight=2.0)})
    return [led.quota("paid").max_live_jobs, led.quota("unknown").max_live_jobs,
            led.quota(None).weight, led.resolve(None), led.resolve(""), led.resolve("acme"),
            m.DEFAULT_TENANT]


def case_charges_journal(m):
    led = m.TenantLedger()
    led.journal = jnl = FakeJournal()
    out = [led.charge("acme", 1.5, job="j1"), led.charge("acme", 0.5, job="j2"),
           led.charged("acme"), led.charged("other")]
    return out + [jnl.records]


def case_budget(m):
    led = m.TenantLedger({"meter": m.TenantQuota(chip_seconds=1.0)})
    out = [led.budget_exhausted("meter")]
    led.charge("meter", 0.6)
    out.append(led.budget_exhausted("meter"))
    led.charge("meter", 0.4)  # >= is exhausted
    out.append(led.budget_exhausted("meter"))
    led.charge("unlimited", 1e9)
    return out + [led.budget_exhausted("unlimited")]


def case_fair_share(m):
    led = m.TenantLedger({"big": m.TenantQuota(weight=1.0), "small": m.TenantQuota(weight=1.0)})
    live = {"big": 4, "small": 1}
    crowd = {"hog": 1000, **{f"t{i}": 1 for i in range(7)}}
    return [led.fair_target("big", live), led.over_fair_share("big", live),
            led.over_fair_share("small", live), sorted(led.over_share_tenants(live)),
            led.fair_share_multiplier("big", live), led.fair_share_multiplier("small", live),
            led.fair_share_multiplier("hog", crowd),
            led.fair_share_multiplier("quiet", {"hog": 1000, "quiet": 1})]


def case_weighted_and_idle(m):
    led = m.TenantLedger({"gold": m.TenantQuota(weight=3.0), "bronze": m.TenantQuota(weight=1.0)})
    live = {"gold": 3, "bronze": 1}
    return [led.fair_target("gold", live), led.over_fair_share("gold", live),
            led.over_fair_share("bronze", live), led.fair_target("idle", {"busy": 4}),
            led.over_fair_share("idle", {"busy": 4})]


def case_restore_and_snapshot(m):
    led = m.TenantLedger({"acme": m.TenantQuota(max_inflight=2)})
    led.charge("acme", 5.0)
    led.restore({"acme": 2.0, "zeta": 1.0})
    led.restore({"acme": 2.0, "zeta": 1.0})  # a fold replayed twice doubles nothing
    led.note_admit("acme")
    led.note_shed("acme")
    return [led.charged("acme"), led.charged("zeta"), led.snapshot(), led.tenants()]


@pytest.mark.parametrize("case", [case_quota_resolution, case_charges_journal, case_budget,
                                  case_fair_share, case_weighted_and_idle,
                                  case_restore_and_snapshot])
def test_ledger_cases_match_jax(case):
    assert case(model) == case(jmodel)


def test_ledger_answers_what_the_jax_cases_assert():
    """The JAX suite's assertions, on the port's ledger."""
    fair = case_fair_share(model)
    assert fair[0] == pytest.approx(2.5) and fair[1] and not fair[2]
    assert fair[3] == ["big"] and fair[4] < 1.0 < fair[5]
    assert fair[6] == 0.25 and fair[7] == 4.0
    assert case_budget(model) == [False, False, True, False]
    charged = case_restore_and_snapshot(model)
    assert charged[0] == pytest.approx(2.0) and charged[1] == pytest.approx(1.0)
    assert charged[2]["acme"]["admitted"] == 1 and charged[2]["acme"]["max_inflight"] == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_ledger_script_matches_jax(seed):
    """Random charges, quotas and live counts: the same trail of charges,
    budgets, targets, multipliers and over-share sets on both packages."""

    def run(m):
        rng = np.random.default_rng(seed)
        tenants = ["a", "b", "c", None]
        led = m.TenantLedger({"a": m.TenantQuota(weight=2.0, chip_seconds=5.0),
                              "b": m.TenantQuota(weight=0.5)},
                             default=m.TenantQuota(weight=1.0, chip_seconds=8.0))
        out = []
        for _ in range(40):
            t = tenants[int(rng.integers(len(tenants)))]
            live = {x or "default": int(rng.integers(0, 5)) for x in tenants}
            out.append((led.charge(t, float(rng.random() * 2)), led.budget_exhausted(t),
                        led.fair_target(t, live), led.fair_share_multiplier(t, live),
                        sorted(led.over_share_tenants(live))))
        return out, led.snapshot()

    got, want = run(model), run(jmodel)
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        assert g[1:2] + g[4:] == w[1:2] + w[4:]
        np.testing.assert_allclose([g[0], g[2], g[3]], [w[0], w[2], w[3]], rtol=1e-12)


# ------------------------------------------------- the admission tenant gates
def _service(pkg, **kw):
    return pkg.Service(topology=pkg.topo(8), interval=0.2, poll_s=0.02, **kw)


def _over_share(pkg):
    tech_cls, task_cls = pkg.fakes
    tech = tech_cls()
    led = pkg.model.TenantLedger()
    svc = _service(pkg, tenancy=led)
    for i in range(3):
        svc.queue.submit(pkg.JobRequest(task=task_cls(f"bg-{i}", 3, [2, 4], tech),
                                        tenant="big"))
    big = svc.queue.submit(pkg.JobRequest(task=task_cls("big-new", 3, [2, 4], tech),
                                          tenant="big"))
    small = svc.queue.submit(pkg.JobRequest(task=task_cls("small-new", 3, [2, 4], tech),
                                            tenant="small"))
    svc.admission.begin_pass()
    decs = [svc.admission.admit(big, pkg.topo(8)), svc.admission.admit(small, pkg.topo(8))]
    return decs, led.snapshot()


def _max_live(pkg):
    tech_cls, task_cls = pkg.fakes
    tech = tech_cls()
    led = pkg.model.TenantLedger({"capped": pkg.model.TenantQuota(max_live_jobs=1)})
    svc = _service(pkg, tenancy=led)
    recs = [svc.queue.submit(pkg.JobRequest(task=task_cls(f"cap-{i}", 3, [2, 4], tech),
                                            tenant="capped")) for i in range(3)]
    svc.admission.begin_pass()
    decs = [svc.admission.admit(r, pkg.topo(8)) for r in recs]
    return decs, {k: v["revisit_on"] for k, v in svc.admission.deferred.items()}


def _budget(pkg):
    tech_cls, task_cls = pkg.fakes
    tech = tech_cls()
    led = pkg.model.TenantLedger({"meter": pkg.model.TenantQuota(chip_seconds=1.0)})
    led.charge("meter", 2.0)
    svc = _service(pkg, tenancy=led)
    rec = svc.queue.submit(pkg.JobRequest(task=task_cls("metered", 3, [2, 4], tech),
                                          tenant="meter"))
    svc.admission.begin_pass()
    return [svc.admission.admit(rec, pkg.topo(8))], rec.state.value


def _decisions(decs):
    return [(d.action, d.reason, d.trials_run, round(d.weight, 9), d.revisit_on) for d in decs]


@pytest.mark.parametrize("scenario", [_over_share, _max_live, _budget])
def test_tenant_gates_match_jax(scenario):
    got, want = scenario(PKGS["torch"]), scenario(PKGS["jax"])
    assert _decisions(got[0]) == _decisions(want[0])
    assert got[1] == want[1]


def test_tenant_gates_decide_as_the_jax_suite_asserts():
    decs, snap = _over_share(PKGS["torch"])
    assert [d.action for d in decs] == ["admit", "admit"]
    assert decs[0].weight < 1.0 < decs[1].weight and snap["big"]["admitted"] == 1
    decs, deferred = _max_live(PKGS["torch"])
    assert [d.action for d in decs] == ["admit", "defer", "defer"]
    assert "max_live_jobs" in decs[1].reason and set(deferred.values()) == {"interval"}
    decs, state = _budget(PKGS["torch"])
    assert decs[0].action == "reject" and "budget exhausted" in decs[0].reason
    assert state == "PROFILING"  # the caller applies the verdict


# ------------------------------------------------- charges across a kill
def test_charges_survive_a_kill_without_doubling(tmp_path):
    pkg = PKGS["torch"]
    tech_cls, task_cls = pkg.fakes
    tech = tech_cls()
    wal = str(tmp_path / "wal")

    def provide(spec):
        return task_cls(spec["task"], spec["remaining_batches"], spec["spec"]["sizes"], tech)

    led = model.TenantLedger()
    svc = _service(pkg, tenancy=led, durability_dir=wal, task_provider=provide).start()
    client = ServiceClient(svc)
    try:
        jid = client.submit(task_cls("kr-one", 30, [2], tech), spec={"sizes": [2]})
        assert client.wait(jid, timeout=60)["state"] == "DONE"
    finally:
        svc.stop(timeout=60)
    charged = led.charged("default")
    assert charged == pytest.approx(30 * 0.001 * 2)

    # a second incarnation, killed mid-interval while a second job charges
    inj = CrashInjector("mid-interval", hit=1, armed=False)
    led2 = model.TenantLedger()
    svc2 = _service(pkg, tenancy=led2, durability_dir=wal, task_provider=provide,
                    crash_barrier=inj.barrier)
    assert led2.charged("default") == pytest.approx(charged)
    svc2.queue.submit(JobRequest(task=task_cls("kr-two", 400, [2], tech), spec={"sizes": [2]}))
    svc2.start()
    run_to_kill(inj, svc2)
    assert svc2.killed
    folded = replay_service_state(wal).tenant_charges
    assert folded == pytest.approx({"default": charged})  # the kill lost the buffered charge

    led3 = model.TenantLedger()
    svc3 = _service(pkg, tenancy=led3, durability_dir=wal, task_provider=provide).start()
    try:
        jobs = {r.name: r.job_id for r in svc3.queue.jobs()}
        assert ServiceClient(svc3).wait(jobs["kr-two"], timeout=60)["state"] == "DONE"
    finally:
        svc3.stop(timeout=60)
    state, jstate = replay_service_state(wal), j_replay_service_state(wal)
    assert state.tenant_charges == pytest.approx(jstate.tenant_charges)
    assert state.tenant_charges["default"] == pytest.approx(led3.charged("default"))
    assert state.tenant_charges["default"] == pytest.approx((30 + 400) * 0.001 * 2)


# ------------------------------------------------------- compile-ahead pool
def _pool_hit(pool_cls):
    jnl = FakeJournal()
    pool = pool_cls(workers=2, journal=jnl)
    try:
        ok = pool.prewarm("k1", lambda: "exe-1", job="j1", tenant="acme")
        idle = pool.wait_idle(timeout=5.0)
        got = pool.acquire("k1")
        return ok, idle, got, pool.ledger(), jnl.records
    finally:
        pool.close()


def _pool_duplicates(pool_cls):
    pool = pool_cls(workers=1)
    try:
        first, second = pool.prewarm("k", lambda: 1), pool.prewarm("k", lambda: 2)
        idle = pool.wait_idle(timeout=5.0)
        third = pool.prewarm("k", lambda: 3)  # already ready
        return first, second, idle, third, pool.acquire("k"), pool.ledger()
    finally:
        pool.close()


def _pool_error(pool_cls):
    pool = pool_cls(workers=1)
    try:
        def boom():
            raise RuntimeError("nvcc says no")

        ok = pool.prewarm("bad", boom)
        idle = pool.wait_idle(timeout=5.0)
        return ok, idle, pool.acquire("bad"), pool.error("bad"), pool.ledger()
    finally:
        pool.close()


def _pool_waits_inflight(pool_cls):
    pool = pool_cls(workers=1)
    try:
        pool.prewarm("slow", lambda: (time.sleep(0.2), "done")[1])
        return pool.acquire("slow", timeout=5.0), pool.ledger()
    finally:
        pool.close()


def _pool_unknown_key(pool_cls):
    pool = pool_cls(workers=1)
    try:
        return pool.acquire("never-asked"), pool.ledger()
    finally:
        pool.close()


def _pool_closed(pool_cls):
    pool = pool_cls(workers=1)
    pool.close()
    return pool.prewarm("k", lambda: 1), pool.ledger()


POOL_CASES = [_pool_hit, _pool_duplicates, _pool_error, _pool_waits_inflight,
              _pool_unknown_key, _pool_closed]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: c.__name__)
def test_compile_ahead_pool_cases_match_jax(case):
    assert case(CompileAheadPool) == case(JCompileAheadPool)


def test_compile_ahead_pool_answers_what_the_jax_suite_asserts():
    ok, idle, got, led, records = _pool_hit(CompileAheadPool)
    assert ok and idle and got == "exe-1"
    assert led["requested"] == 1 and led["ready"] == 1
    assert led["ahead_hits"] == 1 and led["hit_rate"] == 1.0
    assert [d["status"] for k, d in records if k == "compile_ahead"] == \
        ["requested", "ready", "hit"]
    first, second, idle, third, got, led = _pool_duplicates(CompileAheadPool)
    assert first and not second and idle and not third and got == 1
    assert led["duplicates"] == 2
    ok, idle, got, err, led = _pool_error(CompileAheadPool)
    assert ok and idle and got is None and "nvcc says no" in err
    assert led["errors"] == 1 and led["ahead_misses"] == 1
    assert _pool_waits_inflight(CompileAheadPool)[0] == "done"
    got, led = _pool_unknown_key(CompileAheadPool)
    assert got is None and led["ahead_misses"] == 1
    assert _pool_closed(CompileAheadPool)[0] is False


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_pool_sequence_gives_the_jax_ledger_and_statuses(seed):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(12):
        op = ("prewarm", "prewarm_bad", "wait", "acquire")[int(rng.integers(0, 4))]
        script.append((op, f"k{int(rng.integers(0, 4))}"))

    def run(pool_cls):
        jnl = FakeJournal()
        pool = pool_cls(workers=2, journal=jnl)
        out = []
        try:
            for op, key in script:
                if op == "prewarm":
                    out.append(pool.prewarm(key, lambda key=key: f"exe-{key}", job="j"))
                elif op == "prewarm_bad":
                    out.append(pool.prewarm(key, lambda: 1 / 0, job="j"))
                elif op == "wait":
                    out.append(pool.wait_idle(timeout=5.0))
                else:
                    pool.wait_idle(timeout=5.0)  # the worker's order is not the script's
                    out.append(pool.acquire(key))
            pool.wait_idle(timeout=5.0)
            # the workers' ready / error records interleave with the caller's
            # requested / hit / miss in thread order: compare per key
            per_key = {}
            for kind, d in jnl.records:
                per_key.setdefault(d["key"], []).append(d["status"])
            return out, pool.ledger(), per_key
        finally:
            pool.close()

    assert run(CompileAheadPool) == run(JCompileAheadPool)


def test_prewarm_build_keys_by_digest_and_loads():
    from saturn_tpu_torch import native
    from saturn_tpu_torch.utils import cuda_build

    pairs = build_thunks(["flash_attn", "linear_ce", "spase"])
    assert [k for k, _ in pairs] == [cuda_build.library_path("flash_attn").name,
                                     cuda_build.library_path("linear_ce").name,
                                     native.library_path("spase").name]
    with pytest.raises(KeyError):
        build_thunks(["no_such_source"])
    jnl = FakeJournal()
    pool = CompileAheadPool(workers=1, journal=jnl)
    try:
        keys = pool.prewarm_build(["spase"], job="j-1", tenant="acme")
        assert keys == [native.library_path("spase").name]
        assert pool.wait_idle(timeout=300.0)
        assert pool.acquire(keys[0]) is native.load("spase")  # loaded once, shared
        assert pool.prewarm_build(["spase"]) == keys and pool.ledger()["duplicates"] == 1
    finally:
        pool.close()
    assert [d["status"] for d in jnl.of("compile_ahead")] == ["requested", "ready", "hit"]
    assert jnl.of("compile_ahead")[0]["job"] == "j-1"


def _prewarm_service_run(pkg, wal):
    """One job with the compile-ahead hook through a durable service with a
    pool (``TestServiceCompileAhead`` of the JAX suite)."""
    tech_cls, task_cls = pkg.fakes

    class PrewarmTask(task_cls):
        def compile_ahead(self, topology):
            return [(f"ca-{self.name}", lambda: f"exe-{self.name}")]

    class BrokenHookTask(task_cls):
        def compile_ahead(self, topology):
            raise RuntimeError("a hook that raises costs nothing")

    tech = tech_cls()
    pool = (CompileAheadPool if pkg is PKGS["torch"] else JCompileAheadPool)(workers=1)
    svc = _service(pkg, durability_dir=wal, health_guardian=False, compile_ahead=pool,
                   task_provider=lambda p: task_cls(p["task"], p["remaining_batches"],
                                                    p["spec"]["sizes"], tech))
    assert svc.compile_ahead is pool and pool.journal is svc.journal
    svc.start()
    try:
        rec = svc.queue.submit(pkg.JobRequest(task=PrewarmTask("pw-0", 3, [4, 8], tech),
                                              spec={"sizes": [4, 8]}))
        broken = svc.queue.submit(pkg.JobRequest(task=BrokenHookTask("pw-1", 3, [4, 8], tech),
                                                 spec={"sizes": [4, 8]}))
        states = [svc.queue.wait(r.job_id, timeout=30).state.value for r in (rec, broken)]
        assert pool.wait_idle(timeout=5.0)
        got = pool.acquire("ca-pw-0")
        led = pool.ledger()
    finally:
        svc.stop(timeout=30)
    return states, got, led


def test_service_prewarms_at_admit_and_journals(tmp_path):
    states, got, led = _prewarm_service_run(PKGS["torch"], str(tmp_path / "wal"))
    assert states == ["DONE", "DONE"] and got == "exe-pw-0"
    assert led["requested"] == 1 and led["ready"] == 1 and led["hit_rate"] == 1.0
    # the lifecycle is durable, and both packages fold it alike
    state = replay_service_state(str(tmp_path / "wal"))
    assert state.compile_ahead == {"requested": 1, "ready": 1, "hit": 1}
    assert j_replay_service_state(str(tmp_path / "wal")).compile_ahead == state.compile_ahead
    jwal = str(tmp_path / "jwal")
    assert _prewarm_service_run(PKGS["jax"], jwal) == (states, got, led)
    assert replay_service_state(jwal).compile_ahead == state.compile_ahead


def test_pool_ledger_holds_under_concurrent_prewarm_and_acquire():
    """More threads than cores prewarm and acquire overlapping keys with a
    short switch interval: every key is built once, and the ledger accounts
    for every call (a lost update would break a count)."""
    import os
    import sys

    n_threads, n_keys, rounds = 2 * (os.cpu_count() or 4), 16, 20
    built, built_lock = [], threading.Lock()

    def thunk(key):
        with built_lock:
            built.append(key)
        return key

    pool = CompileAheadPool(workers=4)
    calls = {"prewarm": 0, "acquire": 0}
    calls_lock = threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(rounds):
            key = f"k{int(rng.integers(0, n_keys))}"
            pool.prewarm(key, lambda key=key: thunk(key))
            got = pool.acquire(key, timeout=5.0)
            assert got in (None, key)
            with calls_lock:
                calls["prewarm"] += 1
                calls["acquire"] += 1

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert pool.wait_idle(timeout=10.0)
    finally:
        sys.setswitchinterval(saved)
        pool.close()
    led = pool.ledger()
    assert sorted(built) == sorted(set(built))  # each key built once
    assert led["requested"] == led["ready"] == len(built)
    assert led["requested"] + led["duplicates"] == calls["prewarm"]
    assert led["ahead_hits"] + led["ahead_misses"] == calls["acquire"]
    assert led["ahead_misses"] == 0  # every acquire waited out its own key's build
