"""The port's solver above the MILP's task limit and its default control
path — the native SPASE scheduler, ``milp.solve`` past ``milp_task_limit``,
the anytime tier ladder and the plan verifier — against the JAX package on
the same seeded strategy tables."""

import numpy as np
import pytest

import saturn_tpu_torch as sat
from saturn_tpu.analysis import plan_verifier as jverifier
from saturn_tpu.core.mesh import Block as JBlock
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.solver import anytime as janytime
from saturn_tpu.solver import milp as jmilp
from saturn_tpu.solver import native_sched as jnative
from saturn_tpu_torch import native
from saturn_tpu_torch.analysis import PlanVerificationError
from saturn_tpu_torch.analysis import plan_verifier as verifier
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.solver import anytime, milp, native_sched

MARKER = object()  # any non-None executor marks a strategy feasible
REL = 1e-6  # makespans: both packages run the same arithmetic in float64


class _Job:
    """A solver-facing task stand-in: a name and a strategy table."""

    def __init__(self, name, strategies):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}


def _tables(seed, n, cap):
    """``n`` seeded (name, {size: runtime}) tables over sizes up to ``cap``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = float(rng.uniform(10, 100))
        out.append((f"t{i:02d}", {
            g: base / g ** float(rng.uniform(0.5, 1.0))
            for g in (1, 2, 4, 8) if g <= cap and (g == 1 or rng.random() < 0.8)
        }))
    return out


def _both(seed, n, cap):
    """The same tables as JAX jobs on a JAX topology and port jobs on a port
    topology of ``cap`` placeholder devices."""
    tabs = _tables(seed, n, cap)
    jjobs = [_Job(nm, {g: JStrategy(MARKER, g, {}, rt) for g, rt in t.items()})
             for nm, t in tabs]
    tjobs = [_Job(nm, {g: sat.Strategy(MARKER, g, {}, rt) for g, rt in t.items()})
             for nm, t in tabs]
    return (jjobs, JSliceTopology([object() for _ in range(cap)]),
            tjobs, SliceTopology([f"dev{i}" for i in range(cap)]))


def _slots(plan):
    return {n: (a.apportionment, a.block.offset, a.start)
            for n, a in plan.assignments.items()}


@pytest.fixture(autouse=True)
def _no_deadline_override(monkeypatch):
    monkeypatch.delenv(anytime.DEADLINE_ENV, raising=False)
    monkeypatch.delenv(anytime.PARTITION_MAX_ENV, raising=False)


def test_native_library_builds_into_its_own_directory():
    lib = native.library_path("spase")
    native.load("spase")
    assert lib.exists() and lib.parent == native.BUILD_DIR


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises: no Python stand-in takes the native plan's place."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native build of broken.cpp failed"):
        native.load("broken")


@pytest.mark.parametrize("seed,n,cap", [(0, 13, 1), (1, 17, 2), (2, 24, 4),
                                        (3, 31, 8), (4, 40, 8), (5, 40, 2)])
def test_solve_native_constructor_matches_jax(seed, n, cap):
    """``time_limit=0``: the constructor's plan, identical assignments and
    starts in both packages."""
    jjobs, jtopo, tjobs, topo = _both(seed, n, cap)
    want = jnative.solve_native(jjobs, jtopo, time_limit=0.0)
    got = native_sched.solve_native(tjobs, topo, time_limit=0.0)
    assert _slots(got) == _slots(want)
    assert got.makespan == want.makespan


@pytest.mark.parametrize("seed,n,cap", [(6, 13, 4), (7, 25, 8)])
def test_solve_native_search_is_valid_and_no_worse(seed, n, cap):
    jjobs, jtopo, tjobs, topo = _both(seed, n, cap)
    for pkg, jobs, tp in ((jnative, jjobs, jtopo), (native_sched, tjobs, topo)):
        ctor = pkg.solve_native(jobs, tp, time_limit=0.0)
        searched = pkg.solve_native(jobs, tp, time_limit=0.2)
        assert pkg._valid(searched, tp, 1.0)
        assert searched.makespan <= ctor.makespan + 1e-9


@pytest.mark.parametrize("seed,n,cap", [(8, 13, 1), (9, 16, 4), (10, 30, 8)])
def test_milp_solve_above_task_limit_matches_jax(seed, n, cap):
    """Past ``milp_task_limit`` both packages hand over to the native
    scheduler (``time_limit=0``: its deterministic constructor), cold and
    warm-started from a plan of a subset."""
    jjobs, jtopo, tjobs, topo = _both(seed, n, cap)
    want = jmilp.solve(jjobs, jtopo, time_limit=0.0)
    got = milp.solve(tjobs, topo, time_limit=0.0)
    assert got.makespan == pytest.approx(want.makespan, rel=REL)
    assert _slots(got) == _slots(want)
    jwarm = jmilp.solve(jjobs[:-3], jtopo, time_limit=0.0)
    twarm = milp.solve(tjobs[:-3], topo, time_limit=0.0)
    want = jmilp.solve(jjobs, jtopo, time_limit=0.0, warm=jwarm)
    got = milp.solve(tjobs, topo, time_limit=0.0, warm=twarm)
    assert got.makespan == pytest.approx(want.makespan, rel=REL)


@pytest.mark.parametrize("seed", [11, 12])
def test_milp_below_limit_is_seeded_by_the_native_plan(seed):
    """Below the limit the native plan is the MILP's incumbent: the exact
    answer is never worse, and matches the JAX package's."""
    jjobs, jtopo, tjobs, topo = _both(seed, 6, 4)
    nplan = native_sched.solve_native(tjobs, topo, time_limit=0.0)
    got = milp.solve(tjobs, topo, time_limit=30.0)
    want = jmilp.solve(jjobs, jtopo, time_limit=30.0)
    assert got.makespan <= nplan.makespan + 1e-6
    assert got.makespan == pytest.approx(want.makespan, rel=1e-3)  # HiGHS gap 1e-4


def _assert_verified(jplan, plan, jjobs, jtopo, tjobs, topo):
    for pl in (jplan, plan):
        jrep = jverifier.verify_plan(pl, topology=jtopo, tasks=jjobs)
        trep = verifier.verify_plan(pl, topology=topo, tasks=tjobs)
        assert jrep.ok and trep.ok, (jrep.codes(), trep.codes())


@pytest.mark.parametrize("tier,n,cap,deadline,warm", [
    (0, 13, 4, 0.1, True),    # a covering previous plan, no budget for tier 1
    (1, 13, 2, 30.0, False),  # partitions of at most 4, each an exact MILP
    (1, 8, 4, 30.0, True),    # one partition: the exact MILP, warm-started
    (2, 13, 4, 0.3, False),   # no previous plan, no budget for tier 1
    (3, 13, 4, 1e-3, False),  # no budget but the floor's
])
def test_anytime_tiers_match_jax(tier, n, cap, deadline, warm, monkeypatch):
    if n > 8:
        # partitions of 4 tasks prove their MILPs optimal inside their
        # slices, so both packages stitch the same plan whatever the host's
        # load; partitions of 10 run to their time limit here, and a HiGHS
        # incumbent at its time limit depends on the clock
        monkeypatch.setenv(anytime.PARTITION_MAX_ENV, "4")
    jjobs, jtopo, tjobs, topo = _both(20 + tier, n, cap)
    jprev = tprev = None
    if warm:
        jprev = jmilp.greedy_plan(jjobs[:-2], jtopo, 1.0)
        tprev = milp.greedy_plan(tjobs[:-2], topo, 1.0)
    jplan, jrep = janytime.anytime_solve(jjobs, jtopo, deadline, previous=jprev)
    plan, rep = anytime.anytime_solve(tjobs, topo, deadline, previous=tprev)
    assert rep.tier == jrep.tier == tier
    assert rep.tiers_tried == jrep.tiers_tried
    assert plan.makespan == pytest.approx(jplan.makespan, rel=REL)
    assert rep.lower_bound == pytest.approx(jrep.lower_bound, rel=REL)
    _assert_verified(jplan, plan, jjobs, jtopo, tjobs, topo)


def test_anytime_chain_dependencies_above_the_dense_limit():
    """Past 256 tasks plans carry per-device chains; both verifiers (their
    per-device sweeps) accept them."""
    jjobs, jtopo, tjobs, topo = _both(30, 300, 8)
    jplan = janytime.fast_greedy_plan(jjobs, jtopo)
    plan = anytime.fast_greedy_plan(tjobs, topo)
    assert plan.makespan == pytest.approx(jplan.makespan, rel=REL)
    assert plan.dependencies == jplan.dependencies
    _assert_verified(jplan, plan, jjobs, jtopo, tjobs, topo)


def test_anytime_frontier_incremental_above_the_backfill_limit():
    """Past 160 tasks tier 0 places on the frontier (no backfill): the
    survivors keep their slots and the delta lands where JAX puts it."""
    jjobs, jtopo, tjobs, topo = _both(32, 200, 8)
    jprev = janytime.fast_greedy_plan(jjobs[:-5], jtopo)
    tprev = anytime.fast_greedy_plan(tjobs[:-5], topo)
    jplan = janytime.incremental_plan(jjobs, jtopo, jprev)
    plan = anytime.incremental_plan(tjobs, topo, tprev)
    assert len(tjobs) > anytime._INCR_BACKFILL_N
    assert _slots(plan) == pytest.approx(_slots(jplan), rel=REL)
    assert plan.makespan == pytest.approx(jplan.makespan, rel=REL)
    _assert_verified(jplan, plan, jjobs, jtopo, tjobs, topo)


def test_anytime_resolve_slides_or_adopts_like_jax(monkeypatch):
    events = []
    monkeypatch.setattr(anytime.metrics, "event", lambda kind, **kw: events.append((kind, kw)))
    jjobs, jtopo, tjobs, topo = _both(31, 13, 4)
    jfirst = janytime.anytime_resolve(jjobs, jtopo, None, 10.0, deadline=0.3)
    first = anytime.anytime_resolve(tjobs, topo, None, 10.0, deadline=0.3)
    for threshold in (0.0, 1e9):
        jnext = janytime.anytime_resolve(jjobs, jtopo, jfirst, 10.0, threshold,
                                         deadline=0.1)
        nxt = anytime.anytime_resolve(tjobs, topo, first, 10.0, threshold, deadline=0.1)
        assert nxt.anytime.outcome == jnext.anytime.outcome
        assert nxt.makespan == pytest.approx(jnext.makespan, rel=REL)
    assert [k for k, _ in events] == ["solver_tier"] * 3
    assert events[-1][1]["outcome"] == "slid" and events[-1][1]["n_tasks"] == 13


def test_resolve_deadline_env_wins(monkeypatch):
    assert anytime.resolve_deadline(None, 8.0) == 4.0
    assert anytime.resolve_deadline(2.5, 8.0) == 2.5
    monkeypatch.setenv(anytime.DEADLINE_ENV, "0.75")
    assert anytime.resolve_deadline(2.5, 8.0) == 0.75


# ------------------------------------------------------------ plan verifier
def _plan_pair(spec):
    """The same hand-written plan in both packages' types: ``spec`` maps a
    name to (size, offset, start, runtime, deps). Blocks skip their
    alignment check so a misaligned block can be written down."""
    out = []
    for P, A, B in ((jmilp.Plan, jmilp.Assignment, JBlock),
                    (milp.Plan, milp.Assignment, Block)):
        assignments = {}
        for name, (size, offset, start, runtime, _) in spec.items():
            blk = object.__new__(B)
            object.__setattr__(blk, "offset", offset)
            object.__setattr__(blk, "size", size)
            assignments[name] = A(size if name != "wrong_size" else 2 * size,
                                  blk, start, runtime)
        ends = [s + r for _, _, s, r, _ in spec.values()]
        plan = P(assignments=assignments, makespan=max(ends))
        plan.dependencies = {n: list(v[4]) for n, v in spec.items()}
        out.append(plan)
    return out


CORRUPT = {
    "overlap": {"a": (1, 0, 0.0, 5.0, ()), "b": (1, 0, 0.0, 5.0, ())},
    "cycle": {"a": (1, 0, 0.0, 5.0, ("b",)), "b": (1, 0, 6.0, 5.0, ("a",))},
    # Block() refuses a misaligned offset; one that crosses the pool's end
    "misaligned": {"a": (2, 3, 0.0, 5.0, ()), "b": (1, 0, 6.0, 5.0, ())},
    "outside": {"a": (2, 4, 0.0, 5.0, ())},
    "wrong_size": {"wrong_size": (1, 0, 0.0, 5.0, ())},
    "missing": {"a": (1, 0, 0.0, 5.0, ("ghost",)), "b": (1, 1, 0.0, 5.0, ())},
    "negative": {"a": (1, 0, -1.0, 5.0, ())},
    "order": {"a": (1, 0, 0.0, 5.0, ("b",)), "b": (1, 0, 6.0, 5.0, ())},
    "unprofiled": {"a": (4, 0, 0.0, 5.0, ())},
    "clean": {"a": (1, 0, 0.0, 5.0, ()), "b": (1, 0, 6.0, 5.0, ("a",))},
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_verify_plan_codes_match_jax(case):
    jplan, plan = _plan_pair(CORRUPT[case])
    jjobs = [_Job(n, {1: JStrategy(MARKER, 1, {}, 5.0), 2: JStrategy(MARKER, 2, {}, 3.0)})
             for n in CORRUPT[case]]
    tjobs = [_Job(n, {1: sat.Strategy(MARKER, 1, {}, 5.0), 2: sat.Strategy(MARKER, 2, {}, 3.0)})
             for n in CORRUPT[case]]
    jrep = jverifier.verify_plan(jplan, topology=JSliceTopology([object()] * 4), tasks=jjobs)
    rep = verifier.verify_plan(plan, topology=SliceTopology(["d"] * 4), tasks=tjobs)
    assert rep.codes() == jrep.codes()
    assert rep.ok == jrep.ok == (case in ("clean", "missing"))  # P010 warns
    assert ([d.counterexample for d in rep.diagnostics]
            == [d.counterexample for d in jrep.diagnostics])
    if not rep.ok:
        with pytest.raises(PlanVerificationError):
            verifier.verify_or_raise(plan, topology=SliceTopology(["d"] * 4), tasks=tjobs)


@pytest.mark.parametrize("case", ["overlap", "cycle"])
def test_launch_invariants_raise_like_jax(case):
    jplan, plan = _plan_pair(CORRUPT[case])
    with pytest.raises(RuntimeError) as jerr:
        jverifier.check_launch_invariants(list(jplan.assignments), jplan)
    with pytest.raises(RuntimeError) as err:
        verifier.check_launch_invariants(list(plan.assignments), plan)
    assert str(err.value) == str(jerr.value)


def test_sweep_mode_agrees_on_races():
    jplan, plan = _plan_pair(CORRUPT["overlap"])
    want = [d.code for d in jverifier.launch_diagnostics(["a", "b"], jplan, force_sweep=True)]
    got = [d.code for d in verifier.launch_diagnostics(["a", "b"], plan, force_sweep=True)]
    assert got == want == ["SAT-P001"]

