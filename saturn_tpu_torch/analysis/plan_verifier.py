"""Static plan verifier: checks a ``Plan`` before it reaches the devices.

Counterpart of ``saturn_tpu/analysis/plan_verifier.py``, for what the
default path calls — ``verify_plan`` / ``verify_or_raise`` (the gate on
every fresh and re-solved plan) and ``check_launch_invariants`` (the
engine's guard before each gang launch):

- **Launch invariants**: device-block overlap races, dependency cycles and
  dependencies inside a co-schedule or fusion group, checked between the
  groups of the condensed graph (``coschedule_find``, shared with the
  engine).
- **Structure**: dependencies and group members that name unknown tasks,
  groups of fewer than two assigned members, a task in two groups.
- **Feasibility** (with a topology and / or task list): blocks inside the
  buddy capacity, apportionment equal to block size, a feasible strategy at
  the assigned size; a co-schedule group on one block with measured host
  fractions, a fusion group's members on identical slots with a measured
  ``fused_per_batch_time``.
- **Timeline**: non-negative starts and runtimes, start order consistent
  with the dependency edges, makespan and deadline arithmetic.

- **Journal audit** (``audit_journal``): every ``plan_commit`` of a
  durability journal, so that a restart never resurrects a plan the
  verifier rejects.

Pure Python over plan data.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from saturn_tpu_torch.analysis.diagnostics import (
    AnalysisReport,
    Diagnostic,
    PlanVerificationError,
    make,
)

#: Above this many gang members the O(N²)-pairs + transitive-closure exact
#: check hands off to the per-device sweep (the JAX package's variable).
SWEEP_THRESHOLD = int(os.environ.get("SATURN_TPU_VERIFY_SWEEP_THRESHOLD", "256"))


def _race(n1: str, a1: Any, n2: str, a2: Any) -> Diagnostic:
    return make(
        "SAT-P001", "error",
        f"plan races tasks {n1!r} and {n2!r}: blocks "
        f"[{a1.block.offset}:{a1.block.end}] and "
        f"[{a2.block.offset}:{a2.block.end}] overlap with no "
        "ordering path or co-schedule edge between them",
        counterexample={
            "tasks": [n1, n2],
            "blocks": [[a1.block.offset, a1.block.end],
                       [a2.block.offset, a2.block.end]],
        },
        category="launch",
    )


def _cycle(witness: str, nodes: List[str]) -> Diagnostic:
    return make(
        "SAT-P002", "error",
        f"plan dependency cycle through task {witness!r}: the gang "
        "launch would deadlock (every thread in the cycle waits "
        "on another's completion event)",
        counterexample={"cycle_witness": witness, "cycle_nodes": nodes},
        category="launch",
    )


def coschedule_find(names: Iterable[str], plan: Any) -> Callable[[str], str]:
    """Union-find root function over the plan's co-schedule and fusion
    groups, restricted to ``names``. Members of one group are one condensed
    node (co-schedule members run interleaved on one launcher, fusion
    members as one stacked program), so ordering and races are checked
    between groups, never inside one; groups that share a member merge.
    The engine's launcher grouping uses the same function."""
    running = set(names)
    parent: Dict[str, str] = {n: n for n in running}

    def find(n: str) -> str:
        while parent[n] != n:
            parent[n] = parent[parent[n]]  # path halving
            n = parent[n]
        return n

    for attr in ("coschedule", "fused"):
        for grp in getattr(plan, attr, None) or []:
            members = [n for n in grp if n in running]
            for a, b in zip(members, members[1:]):
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
    return find


def _condensed(order: List[str], plan: Any, find) -> Tuple[Dict[str, set], List[Diagnostic]]:
    """Dependency edges between the condensed nodes of ``order``, and a
    SAT-P003 diagnostic for each edge inside a group."""
    running = set(order)
    out: List[Diagnostic] = []
    cdeps: Dict[str, set] = {find(n): set() for n in order}
    for n in order:
        rn = find(n)
        for d in plan.dependencies.get(n, ()):
            if d not in running:
                continue
            rd = find(d)
            if rd == rn:
                if d != n:
                    out.append(make(
                        "SAT-P003", "error",
                        f"plan makes co-scheduled task {n!r} depend on its "
                        f"groupmate {d!r}: group members run interleaved on "
                        "one launcher, so an intra-group completion wait "
                        "would deadlock the group",
                        counterexample={"task": n, "groupmate": d},
                        category="launch",
                    ))
                continue
            cdeps[rn].add(rd)
    return cdeps, out


def launch_diagnostics(names: Sequence[str], plan: Any, *,
                       force_exact: bool = False,
                       force_sweep: bool = False) -> List[Diagnostic]:
    """The gang-launch invariants as diagnostics, in the JAX package's
    order: edges inside a group, cycles, then pairwise races, over the
    condensed graph. A plan that violates them would run two programs on
    one device at once or park launcher threads on events that never fire.
    Above ``SWEEP_THRESHOLD`` tasks the per-device sweep replaces the exact
    check (``force_exact`` / ``force_sweep`` pin it)."""
    if force_sweep or (not force_exact and len(set(names)) > SWEEP_THRESHOLD):
        return _launch_diagnostics_sweep(names, plan)
    order = list(dict.fromkeys(names))
    find = coschedule_find(order, plan)
    deps, out = _condensed(order, plan, find)
    reach: Dict[str, set] = {}

    def reachable(r: str) -> set:
        if r in reach:
            return reach[r]
        reach[r] = set()  # placeholder breaks self-recursion on cycles
        out_set = set()
        for d in deps[r]:
            out_set.add(d)
            out_set |= reachable(d)
        reach[r] = out_set
        return out_set

    for r in deps:
        if r in reachable(r):
            out.append(_cycle(r, sorted(
                n for n in deps if r in reachable(n) and n in reachable(r) or n == r)))
            break  # one witness is the minimal counterexample

    items = [(n, plan.assignments.get(n)) for n in order]
    for i, (n1, a1) in enumerate(items):
        if a1 is None:
            continue
        for n2, a2 in items[i + 1:]:
            if a2 is None or not a1.block.overlaps(a2.block):
                continue
            r1, r2 = find(n1), find(n2)
            if r1 == r2:
                continue  # one group: the shared block is the point
            if r1 not in reachable(r2) and r2 not in reachable(r1):
                out.append(_race(n1, a1, n2, a2))
    return out


def _launch_diagnostics_sweep(names: Sequence[str], plan: Any) -> List[Diagnostic]:
    """Large-N launch check: Kahn's toposort for cycles, then on every device
    consecutive occupants in start order must be directly ordered by an
    edge (either direction). Sound, and stricter than the exact check: every
    solver-produced dependency shape (all overlapping pairs, or per-device
    chains) provides such edges."""
    order = list(dict.fromkeys(names))
    find = coschedule_find(order, plan)
    deps, out = _condensed(order, plan, find)

    indeg: Dict[str, int] = {r: 0 for r in deps}
    for ds in deps.values():
        for d in ds:
            indeg[d] += 1
    queue = [r for r, k in indeg.items() if k == 0]
    seen = 0
    while queue:
        u = queue.pop()
        seen += 1
        for d in deps[u]:
            indeg[d] -= 1
            if indeg[d] == 0:
                queue.append(d)
    if seen != len(deps):
        stuck = sorted(r for r, k in indeg.items() if k > 0)
        out.append(_cycle(stuck[0], stuck))

    per_device: Dict[int, List[Tuple[float, str]]] = {}
    for n in order:
        a = plan.assignments.get(n)
        if a is None:
            continue
        for d in range(a.block.offset, a.block.end):
            per_device.setdefault(d, []).append((a.start, n))
    flagged: set = set()
    for occ in per_device.values():
        occ.sort()
        for (_, n1), (_, n2) in zip(occ, occ[1:]):
            r1, r2 = find(n1), find(n2)
            if r1 == r2 or r1 in deps.get(r2, ()) or r2 in deps.get(r1, ()):
                continue
            key = (n1, n2) if n1 <= n2 else (n2, n1)
            if key in flagged:
                continue
            flagged.add(key)
            out.append(_race(n1, plan.assignments[n1], n2, plan.assignments[n2]))
    return out


def check_launch_invariants(names: Sequence[str], plan: Any) -> None:
    """Raise ``RuntimeError`` on the first launch-invariant violation: the
    engine's refusal before a gang launch."""
    for diag in launch_diagnostics(names, plan):
        raise RuntimeError(diag.message)


def _structure_diagnostics(plan: Any) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    known = set(plan.assignments)
    for n, deps in (plan.dependencies or {}).items():
        for d in deps:
            if d not in known:
                out.append(make(
                    "SAT-P010", "warning",
                    f"dependency of {n!r} names unknown task {d!r} "
                    "(no assignment in the plan)",
                    counterexample={"task": n, "unknown": d},
                    category="structure",
                ))
    groups = (("coschedule", "co-schedule", ("SAT-P011", "SAT-P012", "SAT-P013"),
               "the engine merges them into one launcher", "nothing to interleave"),
              ("fused", "fusion", ("SAT-P014", "SAT-P015", "SAT-P016"),
               "one task can belong to only one stacked program", "nothing to stack"))
    for attr, kind, (unknown, small, twice), twice_why, small_why in groups:
        seen: Dict[str, int] = {}
        for gi, grp in enumerate(getattr(plan, attr, None) or []):
            for m in grp:
                if m not in known:
                    out.append(make(
                        unknown, "warning", f"{kind} group {gi} names unknown task {m!r}",
                        counterexample={"group": gi, "unknown": m}, category="structure",
                    ))
                if m in seen and seen[m] != gi:
                    out.append(make(
                        twice, "warning",
                        f"task {m!r} appears in {kind} groups {seen[m]} and {gi} — "
                        f"{twice_why}",
                        counterexample={"task": m, "groups": [seen[m], gi]},
                        category="structure",
                    ))
                seen.setdefault(m, gi)
            if len([m for m in grp if m in known]) < 2:
                out.append(make(
                    small, "warning",
                    f"{kind} group {gi} has fewer than two assigned members — {small_why}",
                    counterexample={"group": gi, "members": list(grp)},
                    category="structure",
                ))
    return out


def _feasibility_diagnostics(plan: Any, topology: Any,
                             tasks: Optional[Sequence[Any]]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    capacity = getattr(topology, "capacity", None)
    by_name = {getattr(t, "name", None): t for t in (tasks or [])}
    for n, a in plan.assignments.items():
        if capacity is not None and a.block.end > capacity:
            out.append(make(
                "SAT-P020", "error",
                f"assignment for {n!r} occupies devices "
                f"[{a.block.offset}:{a.block.end}] but the topology's buddy "
                f"capacity is {capacity}",
                counterexample={"task": n, "block": [a.block.offset, a.block.end],
                                "capacity": capacity},
                category="feasibility",
            ))
        if a.apportionment != a.block.size:
            out.append(make(
                "SAT-P021", "error",
                f"assignment for {n!r} apportions {a.apportionment} devices "
                f"but its block holds {a.block.size}: the profiled strategy "
                "would run on a block it was never measured for",
                counterexample={"task": n, "apportionment": a.apportionment,
                                "block_size": a.block.size},
                category="feasibility",
            ))
        t = by_name.get(n)
        if t is not None:
            strat = getattr(t, "strategies", {}).get(a.apportionment)
            if strat is None or not getattr(strat, "feasible", True):
                out.append(make(
                    "SAT-P022", "error",
                    f"task {n!r} has no feasible strategy at apportionment "
                    f"{a.apportionment} — the plan schedules a configuration "
                    "the sweep rejected or never measured",
                    counterexample={"task": n, "apportionment": a.apportionment,
                                    "known_sizes": sorted(getattr(t, "strategies", {}))},
                    category="feasibility",
                ))
    for gi, grp in enumerate(getattr(plan, "coschedule", None) or []):
        assigned = [(m, plan.assignments[m]) for m in grp if m in plan.assignments]
        blocks = {(a.block.offset, a.block.size) for _, a in assigned}
        if len(blocks) > 1:
            out.append(make(
                "SAT-P023", "warning",
                f"co-schedule group {gi} members do not share one device "
                "block — interleaving only hides bubbles when the group is "
                "co-located",
                counterexample={"group": gi, "blocks": sorted(blocks)},
                category="feasibility",
            ))
        for m, a in assigned:
            t = by_name.get(m)
            if t is None:
                continue
            strat = getattr(t, "strategies", {}).get(a.apportionment)
            hf = getattr(strat, "host_fraction", 0.0) if strat else 0.0
            bubble = getattr(strat, "bubble_fraction", 0.0) if strat else 0.0
            if (not hf or hf <= 0.0) and (not bubble or bubble <= 0.0):
                out.append(make(
                    "SAT-P024", "warning",
                    f"co-scheduled task {m!r} has no measured host fraction "
                    "or schedule bubble at its apportionment — the "
                    "co-location term had no idle window to fill",
                    counterexample={"task": m, "group": gi,
                                    "apportionment": a.apportionment},
                    category="feasibility",
                ))
    for gi, grp in enumerate(getattr(plan, "fused", None) or []):
        assigned = [(m, plan.assignments[m]) for m in grp if m in plan.assignments]
        slots = {(a.apportionment, a.block.offset, a.block.size, a.start)
                 for _, a in assigned}
        if len(slots) > 1:
            out.append(make(
                "SAT-P025", "error",
                f"fusion group {gi} members do not hold IDENTICAL "
                "(size, block, start) assignments — a stacked program is "
                "one step on one block; divergent slots would dispatch the "
                "same stack twice",
                counterexample={"group": gi, "slots": sorted(slots)},
                category="feasibility",
            ))
        for m, a in assigned:
            t = by_name.get(m)
            if t is None:
                continue
            strat = getattr(t, "strategies", {}).get(a.apportionment)
            fpbt = getattr(strat, "fused_per_batch_time", None) if strat else None
            if fpbt is None:
                out.append(make(
                    "SAT-P026", "warning",
                    f"fused task {m!r} has no measured fused_per_batch_time "
                    "at its apportionment — the fusion pre-pass prices "
                    "strictly on measured lockstep cost, so this group was "
                    "fused on guesswork",
                    counterexample={"task": m, "group": gi,
                                    "apportionment": a.apportionment},
                    category="feasibility",
                ))
    return out


def _timeline_diagnostics(plan: Any, tasks: Optional[Sequence[Any]]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    by_name = {getattr(t, "name", None): t for t in (tasks or [])}
    last_end = 0.0
    for n, a in plan.assignments.items():
        if a.start < 0 or a.runtime < 0:
            out.append(make(
                "SAT-P030", "error",
                f"assignment for {n!r} has negative timing "
                f"(start={a.start}, runtime={a.runtime})",
                counterexample={"task": n, "start": a.start, "runtime": a.runtime},
                category="timeline",
            ))
        last_end = max(last_end, a.start + max(a.runtime, 0.0))
        for d in plan.dependencies.get(n, ()):
            da = plan.assignments.get(d)
            if da is not None and a.start < da.start:
                out.append(make(
                    "SAT-P031", "error",
                    f"task {n!r} starts at {a.start:.1f}s but depends on "
                    f"{d!r} which starts later ({da.start:.1f}s) — the "
                    "schedule contradicts its own ordering edges",
                    counterexample={"task": n, "start": a.start,
                                    "dep": d, "dep_start": da.start},
                    category="timeline",
                ))
        t = by_name.get(n)
        hints = getattr(t, "hints", None) or {}
        deadline = hints.get("deadline") if isinstance(hints, dict) else None
        if isinstance(deadline, (int, float)) and deadline > 0:
            if a.start + a.runtime > float(deadline):
                out.append(make(
                    "SAT-P033", "warning",
                    f"task {n!r} is scheduled to finish at "
                    f"{a.start + a.runtime:.1f}s, past its deadline "
                    f"{float(deadline):.1f}s",
                    counterexample={"task": n, "finish": a.start + a.runtime,
                                    "deadline": float(deadline)},
                    category="timeline",
                ))
    makespan = getattr(plan, "makespan", None)
    if isinstance(makespan, (int, float)) and last_end > makespan + 1e-6:
        out.append(make(
            "SAT-P032", "warning",
            f"recorded makespan {makespan:.1f}s is below the last "
            f"assignment's end {last_end:.1f}s — stale after a slide or "
            "hand edit",
            counterexample={"makespan": makespan, "last_end": last_end},
            category="timeline",
        ))
    return out


def verify_plan(plan: Any, topology: Any = None,
                tasks: Optional[Sequence[Any]] = None,
                names: Optional[Sequence[str]] = None,
                subject: str = "plan") -> AnalysisReport:
    """Full static verification of one plan. ``topology`` / ``tasks`` unlock
    the feasibility checks; ``names`` restricts the launch invariants to a
    subset (default: every assigned task)."""
    report = AnalysisReport(subject=subject)
    launch_names = list(names) if names is not None else list(plan.assignments)
    report.extend(launch_diagnostics(launch_names, plan))
    report.extend(_structure_diagnostics(plan))
    if topology is not None or tasks is not None:
        report.extend(_feasibility_diagnostics(plan, topology, tasks))
    report.extend(_timeline_diagnostics(plan, tasks))
    return report


def verify_or_raise(plan: Any, topology: Any = None,
                    tasks: Optional[Sequence[Any]] = None,
                    names: Optional[Sequence[str]] = None,
                    source: str = "plan") -> AnalysisReport:
    """The adoption gate: verify, raise :class:`PlanVerificationError` on
    any error-severity diagnostic, return the report otherwise."""
    report = verify_plan(plan, topology=topology, tasks=tasks, names=names,
                         subject=source)
    if not report.ok:
        raise PlanVerificationError(report, source=source)
    return report


# ---------------------------------------------------------------------------
# journal audit
# ---------------------------------------------------------------------------

def audit_journal(root: str, topology: Any = None,
                  tasks: Optional[Sequence[Any]] = None) -> AnalysisReport:
    """Verify every ``plan_commit`` record of a durability journal: an
    undecodable payload or an unreadable journal is SAT-J002, a plan that
    fails verification SAT-J001 (each plan's own diagnostics follow), a
    journal with no plan SAT-J000 (info)."""
    report = AnalysisReport(subject=f"journal:{root}")
    try:
        from saturn_tpu_torch.durability import journal as _journal

        records = _journal.replay(root)
    except Exception as e:  # an unreadable tree, a corrupt segment
        report.extend([make("SAT-J002", "error",
                            f"journal at {root!r} unreadable: {type(e).__name__}: {e}",
                            category="journal")])
        return report
    from saturn_tpu_torch.solver import milp

    n_plans = 0
    for rec in records:
        if rec.get("kind") != "plan_commit":
            continue
        n_plans += 1
        seq = rec.get("seq")
        payload = (rec.get("data") or {}).get("plan")
        try:
            plan = milp.Plan.from_json(payload)
        except Exception as e:
            report.extend([make("SAT-J002", "error",
                                f"plan_commit seq={seq} undecodable: {type(e).__name__}: {e}",
                                counterexample={"seq": seq}, category="journal")])
            continue
        sub = verify_plan(plan, topology=topology, tasks=tasks, subject=f"plan_commit seq={seq}")
        if not sub.ok:
            codes = [d.code for d in sub.errors]
            report.extend([make("SAT-J001", "error",
                                f"plan_commit seq={seq} fails static verification ({codes}) "
                                "— quarantine on replay",
                                counterexample={"seq": seq, "codes": codes},
                                category="journal")])
        report.extend(sub.diagnostics)
    if n_plans == 0:
        report.extend([make("SAT-J000", "info", f"journal at {root!r} holds no plan_commit records",
                            category="journal")])
    return report
