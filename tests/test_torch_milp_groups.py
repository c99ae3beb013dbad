"""The port's co-schedule and fusion terms of the solver, its plan groups and
the verifier's group checks against the JAX package, on synthetic strategy
tables with set ``host_fraction`` and ``fused_per_batch_time``:

- ``coschedule_candidates`` and ``fusion_priced_groups`` (with a
  ``fusion_fits`` veto, an unknown gate, an exclusion) return the JAX
  package's groups, options and prices (float64 on both sides: 1e-9
  relative);
- ``solve`` returns the JAX package's plan on the same tables: its groups,
  its slots and its makespan (1e-6 relative: the same model through HiGHS);
- ``Plan.to_json`` / ``from_json`` round trip both packages' plans with
  groups;
- the verifier gives the JAX package's diagnostic codes and counterexamples
  on the hand-built plans of ``tests/test_fused.py``'s ``TestPlanFusedWire``
  and on bad co-schedule groups;
- a ``plan_commit`` record with groups is byte for byte the JAX package's.
"""

import os
import time

import pytest

import saturn_tpu_torch as sat
from saturn_tpu import durability as jdur
from saturn_tpu.analysis import plan_verifier as jverifier
from saturn_tpu.core.mesh import Block as JBlock
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.solver import anytime as janytime
from saturn_tpu.solver import milp as jmilp
from saturn_tpu_torch import durability as dur
from saturn_tpu_torch.analysis import plan_verifier as verifier
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.solver import anytime, milp

MARKER = object()  # any non-None executor marks a strategy feasible
REL = 1e-6


class _Job:
    def __init__(self, name, strategies):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}


def _jobs(spec, cap):
    """``spec``: [(name, {size: (runtime, per_batch, host_fraction, fused_pbt)})]
    -> (JAX jobs, JAX topology, port jobs, port topology)."""
    def make(cls):
        return [_Job(n, {g: cls(MARKER, g, {}, rt, pbt, host_fraction=hf,
                                 fused_per_batch_time=fp)
                         for g, (rt, pbt, hf, fp) in t.items()}) for n, t in spec]
    return (make(JStrategy), JSliceTopology([object() for _ in range(cap)]),
            make(sat.Strategy), SliceTopology([f"dev{i}" for i in range(cap)]))


def _choices(jobs, topo, block_cls):
    return {t.name: [(s, b, st.runtime) for s, st in sorted(t.feasible_strategies().items())
                     for b in topo.blocks(s)] for t in jobs}


def _slots(plan):
    return {n: (a.apportionment, a.block.offset, a.block.size, round(a.start, 6),
                round(a.runtime, 6)) for n, a in plan.assignments.items()}


def _cands(out):
    return [(n1, n2, [(i1, i2, round(c, 9)) for i1, i2, c in common])
            for n1, n2, common in out]


@pytest.fixture(autouse=True)
def _no_deadline_override(monkeypatch):
    monkeypatch.delenv(anytime.DEADLINE_ENV, raising=False)
    monkeypatch.delenv(anytime.PARTITION_MAX_ENV, raising=False)


# -------------------------------------------------------------- co-schedule
@pytest.mark.parametrize("hfs,min_gain", [((0.6, 0.5, 0.0), 1.15), ((0.3, 0.3, 0.8), 1.15),
                                          ((0.6, 0.5, 0.7), 1.5), ((0.0, 0.0, 0.0), 1.0)])
def test_coschedule_candidates_match_jax(hfs, min_gain):
    spec = [(f"t{i}", {1: (10.0 + 3 * i, 0.1, hf, None), 2: (6.0 + i, 0.06, hf, None)})
            for i, hf in enumerate(hfs)]
    jj, jt, tj, tt = _jobs(spec, 2)
    got = milp.coschedule_candidates(tj, _choices(tj, tt, Block), min_gain)
    want = jmilp.coschedule_candidates(jj, _choices(jj, jt, JBlock), min_gain)
    assert _cands(got) == _cands(want)


# ----------------------------------------------------------------- fusion
FUSE = [(n, {1: (10.0, 0.1, 0.0, 0.12), 2: (6.0, 0.06, 0.0, 0.1)}) for n in "abc"]


@pytest.mark.parametrize("case", ["wins", "veto", "unknown", "exclude", "unpriced", "slower",
                                  "partly_priced"])
def test_fusion_priced_groups_match_jax(case):
    spec, kw, jkw = FUSE, {}, {}
    if case == "veto":
        kw = jkw = {"fusion_fits": lambda members, size, n: size != 1}
    elif case == "unknown":
        kw = jkw = {"fusion_fits": lambda members, size, n: None}
    elif case == "exclude":
        kw = jkw = {"fusion_exclude": {"b"}}
    elif case == "unpriced":
        spec = [(n, {1: (10.0, 0.1, 0.0, None)}) for n in "abc"]
    elif case == "slower":
        spec = [(n, {1: (10.0, 0.1, 0.0, 1.0)}) for n in "abc"]
    elif case == "partly_priced":
        spec = FUSE[:2] + [("c", {1: (10.0, 0.1, 0.0, None), 2: (6.0, 0.06, 0.0, 0.1)})]
    jj, jt, tj, tt = _jobs(spec, 2)
    got = milp.fusion_priced_groups(tj, [["a", "b", "c"]], tt, **kw)
    want = jmilp.fusion_priced_groups(jj, [["a", "b", "c"]], jt, **jkw)
    assert [(g, s, round(rt, 9), round(p, 9)) for g, s, rt, p in got] == \
        [(g, s, round(rt, 9), round(p, 9)) for g, s, rt, p in want]
    if case == "wins":
        assert got and got[0][0] == ["a", "b", "c"]
    if case in ("veto",):
        assert got and got[0][1] == 2


@pytest.mark.parametrize("case", ["fused", "fused_and_solo", "unpriced", "coschedule",
                                  "coschedule_excluded"])
def test_solve_matches_jax(case):
    kw = {}
    if case == "fused":
        spec, cap, kw = FUSE, 2, {"fusion": [["a", "b", "c"]]}
    elif case == "fused_and_solo":
        spec = FUSE + [("d", {1: (8.0, 0.2, 0.0, None), 2: (5.0, 0.125, 0.0, None)})]
        cap, kw = 2, {"fusion": [["a", "b", "c"]]}
    elif case == "unpriced":
        spec = [(n, {1: (10.0, 0.1, 0.0, None), 2: (6.0, 0.06, 0.0, None)}) for n in "abc"]
        cap, kw = 2, {"fusion": [["a", "b", "c"]]}
    else:
        spec = [("x", {1: (10.0, 0.1, 0.6, None)}), ("y", {1: (8.0, 0.1, 0.5, None)}),
                ("z", {1: (4.0, 0.1, 0.0, None)})]
        cap = 1
        if case == "coschedule_excluded":
            kw = {"coschedule_exclude": {"y"}}
    jj, jt, tj, tt = _jobs(spec, cap)
    got = milp.solve(tj, tt, time_limit=20.0, **kw)
    want = jmilp.solve(jj, jt, time_limit=20.0, **kw)
    assert got.fused == want.fused and got.coschedule == want.coschedule
    assert _slots(got) == _slots(want)
    assert got.makespan == pytest.approx(want.makespan, rel=REL)
    assert got.dependencies == want.dependencies
    if case == "fused":
        assert got.fused == [["a", "b", "c"]]
    if case == "coschedule":
        assert got.coschedule == [["x", "y"]]
    if case == "coschedule_excluded":
        assert all("y" not in g for g in got.coschedule)
    assert verifier.verify_plan(got, topology=tt, tasks=tj).ok


def test_anytime_ladder_carries_the_groups():
    """Fusion groups reach the plan whichever tier wins: the exact tier
    with a budget, the greedy floor (tier 3) without one; a slid plan keeps
    its groups, and excluding a member makes the fresh plan win."""
    jj, jt, tj, tt = _jobs(FUSE, 2)
    first = anytime.anytime_resolve(tj, tt, None, 100.0, deadline=5.0,
                                    fusion=[["a", "b", "c"]])
    assert first.fused == [["a", "b", "c"]] and first.anytime.tier == 1
    want = janytime.anytime_resolve(jj, jt, None, 100.0, deadline=5.0,
                                    fusion=[["a", "b", "c"]])
    assert first.fused == want.fused and _slots(first) == _slots(want)
    floor, report = anytime.anytime_solve(tj, tt, 1e-3, fusion=[["a", "b", "c"]])
    assert report.tier == 3 and floor.fused == [["a", "b", "c"]]
    assert len({_slots(floor)[n] for n in "abc"}) == 1
    slid = anytime.anytime_resolve(tj, tt, first, 0.5, threshold=1e9, deadline=5.0,
                                   fusion=[["a", "b", "c"]])
    assert slid.anytime.outcome == "slid" and slid.fused == [["a", "b", "c"]]
    fresh = anytime.anytime_resolve(tj, tt, first, 0.5, threshold=1e9, deadline=5.0,
                                    fusion=[["a", "b", "c"]], fusion_exclude={"b"})
    assert fresh.anytime.outcome != "slid" and fresh.fused == [["a", "c"]]


# ------------------------------------------------------------------- plans
def _wire(pkg_milp, block_cls, b_offset=0):
    return pkg_milp.Plan(
        assignments={"a": pkg_milp.Assignment(1, block_cls(0, 1), 0.0, 1.0),
                     "b": pkg_milp.Assignment(1, block_cls(b_offset, 1), 0.0, 1.0),
                     "c": pkg_milp.Assignment(1, block_cls(4, 1), 0.0, 1.0)},
        makespan=1.0, fused=[["a", "b"]])


def test_plan_json_round_trips_with_groups():
    plan, jplan = _wire(milp, Block), _wire(jmilp, JBlock)
    plan.coschedule, jplan.coschedule = [["c", "a"]], [["c", "a"]]
    plan.compute_dependencies()
    jplan.compute_dependencies()
    assert plan.to_json() == jplan.to_json()
    assert plan.fused_group_of() == jplan.fused_group_of() == {"a": 0, "b": 0}
    assert plan.coschedule_group_of() == jplan.coschedule_group_of()
    back = milp.Plan.from_json(jplan.to_json())
    assert back.fused == [["a", "b"]] and back.coschedule == [["c", "a"]]
    assert back.to_json() == jplan.to_json()
    assert jmilp.Plan.from_json(plan.to_json()).to_json() == plan.to_json()
    old = plan.to_json()
    del old["fused"], old["coschedule"]
    assert milp.Plan.from_json(old).fused == [] == jmilp.Plan.from_json(old).fused
    # fusion members are exempt from each other's ordering edges
    assert plan.dependencies["a"] == [] and plan.dependencies["b"] == []


def _diags(report):
    return sorted((d.code, d.severity, repr(sorted(d.counterexample.items())))
                  for d in report.diagnostics)


def _fake_topo(pkg, n=8):
    return (SliceTopology([f"dev{i}" for i in range(n)]) if pkg == "torch"
            else JSliceTopology([object() for _ in range(n)]))


def _bad_plans(pkg_milp, block_cls):
    A = pkg_milp.Assignment
    plans = {
        "exempt_overlap": _wire(pkg_milp, block_cls),
        "divergent_slots": pkg_milp.Plan(
            assignments={"a": A(1, block_cls(0, 1), 0.0, 1.0),
                         "b": A(1, block_cls(1, 1), 0.0, 1.0)},
            makespan=1.0, fused=[["a", "b"]]),
        "unknown_and_small": pkg_milp.Plan(
            assignments={"a": A(1, block_cls(0, 1), 0.0, 1.0)}, makespan=1.0,
            coschedule=[["a", "ghost"]], fused=[["a", "phantom"]]),
        "twice": pkg_milp.Plan(
            assignments={n: A(1, block_cls(0, 1), 0.0, 1.0) for n in "abc"}, makespan=1.0,
            coschedule=[["a", "b"], ["b", "c"]]),
        "groupmate_edge": pkg_milp.Plan(
            assignments={n: A(1, block_cls(0, 1), 0.0, 1.0) for n in "ab"}, makespan=1.0,
            coschedule=[["a", "b"]], dependencies={"a": ["b"], "b": []}),
        "coschedule_split": pkg_milp.Plan(
            assignments={"a": A(1, block_cls(0, 1), 0.0, 1.0),
                         "b": A(1, block_cls(1, 1), 0.0, 1.0)},
            makespan=1.0, coschedule=[["a", "b"]]),
        "race": pkg_milp.Plan(
            assignments={"a": A(1, block_cls(0, 1), 0.0, 1.0),
                         "b": A(2, block_cls(0, 2), 0.5, 1.0)}, makespan=1.5),
    }
    for name, p in plans.items():
        if name not in ("groupmate_edge", "race"):
            p.compute_dependencies()
        if name == "race":
            p.dependencies = {"a": [], "b": []}
    return plans


@pytest.mark.parametrize("name", ["exempt_overlap", "divergent_slots", "unknown_and_small",
                                  "twice", "groupmate_edge", "coschedule_split", "race",
                                  "unpriced"])
def test_verifier_diagnostics_match_jax(name):
    tasks = jtasks = None
    if name == "unpriced":
        plans = {"unpriced": _wire(milp, Block)}
        jplans = {"unpriced": _wire(jmilp, JBlock)}
        for p in (plans["unpriced"], jplans["unpriced"]):
            p.compute_dependencies()
        spec = [("a", {1: (1.0, 0.1, 0.0, None)}), ("b", {1: (1.0, 0.1, 0.0, 0.05)}),
                ("c", {1: (1.0, 0.1, 0.0, None)})]
        jtasks, _, tasks, _ = _jobs(spec, 8)
    else:
        plans, jplans = _bad_plans(milp, Block), _bad_plans(jmilp, JBlock)
    got = verifier.verify_plan(plans[name], topology=_fake_topo("torch"), tasks=tasks)
    want = jverifier.verify_plan(jplans[name], topology=_fake_topo("jax"), tasks=jtasks)
    assert _diags(got) == _diags(want)
    codes = {d.code for d in got.diagnostics}
    expect = {"exempt_overlap": set(), "divergent_slots": {"SAT-P025"},
              "unknown_and_small": {"SAT-P011", "SAT-P012", "SAT-P014", "SAT-P015"},
              "twice": {"SAT-P013"}, "groupmate_edge": {"SAT-P003"},
              "coschedule_split": {"SAT-P023"}, "race": {"SAT-P001"},
              "unpriced": {"SAT-P026"}}[name]
    assert expect <= codes
    if name == "exempt_overlap":
        assert got.ok
    # the engine's guard and the static verifier share the condensed graph
    launch = verifier.launch_diagnostics(list(plans[name].assignments), plans[name])
    jlaunch = jverifier.launch_diagnostics(list(jplans[name].assignments), jplans[name])
    assert [d.code for d in launch] == [d.code for d in jlaunch]
    sweep = verifier.launch_diagnostics(list(plans[name].assignments), plans[name],
                                        force_sweep=True)
    jsweep = jverifier.launch_diagnostics(list(jplans[name].assignments), jplans[name],
                                          force_sweep=True)
    assert [d.code for d in sweep] == [d.code for d in jsweep]


def test_coschedule_find_matches_jax():
    plan, jplan = _wire(milp, Block), _wire(jmilp, JBlock)
    plan.coschedule, jplan.coschedule = [["b", "c"]], [["b", "c"]]
    names = ["a", "b", "c"]
    find, jfind = verifier.coschedule_find(names, plan), jverifier.coschedule_find(names, jplan)
    assert len({find(n) for n in names}) == len({jfind(n) for n in names}) == 1


def test_plan_commit_with_groups_is_the_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1754390400.1234567)
    jj, jt, tj, tt = _jobs(FUSE, 2)
    plan = milp.solve(tj, tt, time_limit=20.0, fusion=[["a", "b", "c"]])
    jplan = jmilp.solve(jj, jt, time_limit=20.0, fusion=[["a", "b", "c"]])
    for root, journal, p in ((tmp_path / "torch", dur.Journal, plan),
                             (tmp_path / "jax", jdur.Journal, jplan)):
        j = journal(str(root))
        j.append("plan_commit", interval=0, makespan=p.makespan, plan=p.to_json())
        j.commit()
        j.close()
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    state = dur.replay_batch_state(str(tmp_path / "torch"))
    assert milp.Plan.from_json(state.plan).fused == [["a", "b", "c"]]
    assert jdur.replay(str(tmp_path / "torch"), strict=True)
