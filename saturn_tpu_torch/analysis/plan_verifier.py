"""Static plan verifier: checks a ``Plan`` before it reaches the devices.

Counterpart of ``saturn_tpu/analysis/plan_verifier.py``, for what the
default path calls — ``verify_plan`` / ``verify_or_raise`` (the gate on
every fresh and re-solved plan) and ``check_launch_invariants`` (the
engine's guard before each gang launch):

- **Launch invariants**: device-block overlap races and dependency cycles.
- **Structure**: dependencies that name unknown tasks.
- **Feasibility** (with a topology and / or task list): blocks inside the
  buddy capacity, apportionment equal to block size, a feasible strategy at
  the assigned size.
- **Timeline**: non-negative starts and runtimes, start order consistent
  with the dependency edges, makespan and deadline arithmetic.

Port plans carry no co-schedule or fusion groups yet, so the JAX package's
group checks (SAT-P003, P011-P016, P023-P026) and its ``coschedule_find``
have no counterpart; ``audit_journal`` waits for the durability journal.
Pure Python over plan data.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def _edges(order: List[str], plan: Any) -> Dict[str, set]:
    running = set(order)
    return {
        n: {d for d in plan.dependencies.get(n, ()) if d in running and d != n}
        for n in order
    }


def launch_diagnostics(names: Sequence[str], plan: Any, *,
                       force_exact: bool = False,
                       force_sweep: bool = False) -> List[Diagnostic]:
    """The gang-launch invariants as diagnostics, in the JAX package's
    order: cycles, then pairwise races. A plan that violates them would run
    two programs on one device at once or park launcher threads on events
    that never fire. Above ``SWEEP_THRESHOLD`` tasks the per-device sweep
    replaces the exact check (``force_exact`` / ``force_sweep`` pin it)."""
    if force_sweep or (not force_exact and len(set(names)) > SWEEP_THRESHOLD):
        return _launch_diagnostics_sweep(names, plan)
    out: List[Diagnostic] = []
    order = list(dict.fromkeys(names))
    deps = _edges(order, plan)
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
            if n1 not in reachable(n2) and n2 not in reachable(n1):
                out.append(_race(n1, a1, n2, a2))
    return out


def _launch_diagnostics_sweep(names: Sequence[str], plan: Any) -> List[Diagnostic]:
    """Large-N launch check: Kahn's toposort for cycles, then on every device
    consecutive occupants in start order must be directly ordered by an
    edge (either direction). Sound, and stricter than the exact check: every
    solver-produced dependency shape (all overlapping pairs, or per-device
    chains) provides such edges."""
    out: List[Diagnostic] = []
    order = list(dict.fromkeys(names))
    deps = _edges(order, plan)

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
            if n1 == n2 or n1 in deps.get(n2, ()) or n2 in deps.get(n1, ()):
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
