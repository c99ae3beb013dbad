"""The SPASE MILP: jointly select strategy, allocate a block, and schedule.

Counterpart of ``saturn_tpu/solver/milp.py``: one joint binary per task over
(block size, aligned block) options, start times, pairwise big-M ordering
for tasks that may share a device, a makespan objective with an area cut,
solved exactly with HiGHS (``solver/lp.py``). The introspective re-solve
is ``solver/anytime.anytime_resolve``, whose tiers call in here; the JAX
package's ``milp.resolve`` has no caller in the port.

As in the JAX package, the native C++ scheduler (``native_sched``) seeds
the MILP with its plan, and above ``milp_task_limit`` tasks it takes over
the whole solve. The co-location and fusion terms and priority ``weights``
are later items.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.solver.lp import Expr, Model

log = logging.getLogger("saturn_tpu_torch")


@dataclass
class Assignment:
    """One task's slot in the plan."""

    apportionment: int      # block size (devices)
    block: Block            # which aligned block
    start: float            # start time, seconds from interval origin
    runtime: float          # estimated remaining runtime under this strategy


@dataclass
class Plan:
    """Decoded schedule."""

    assignments: Dict[str, Assignment]          # task name -> slot
    makespan: float
    dependencies: Dict[str, List[str]] = field(default_factory=dict)

    def compute_dependencies(self) -> None:
        """Edges between tasks whose blocks overlap: the later start depends
        on the earlier one."""
        deps: Dict[str, List[str]] = {name: [] for name in self.assignments}
        items = list(self.assignments.items())
        for i, (n1, a1) in enumerate(items):
            for n2, a2 in items[i + 1 :]:
                if a1.block.overlaps(a2.block):
                    if a1.start <= a2.start:
                        deps[n2].append(n1)
                    else:
                        deps[n1].append(n2)
        self.dependencies = deps


class DeviceTimeline:
    """Per-device busy intervals with the earliest-free-slot rule (the
    list-scheduling primitive ``warm_schedule`` and ``greedy_plan`` share)."""

    def __init__(self, capacity: int):
        self._events: Dict[int, List[Tuple[float, float]]] = {
            d: [] for d in range(capacity)
        }

    def earliest_free(self, blk: Block, duration: float) -> float:
        """Earliest t such that [t, t+duration) is free on all devices of blk."""
        busy = sorted(
            iv for d in range(blk.offset, blk.end) for iv in self._events[d]
        )
        t0 = 0.0
        for s, e in busy:
            if t0 + duration <= s:
                break
            t0 = max(t0, e)
        return t0

    def occupy(self, blk: Block, start: float, end: float) -> None:
        for d in range(blk.offset, blk.end):
            self._events[d].append((start, end))

    def place(self, blk: Block, runtime: float, slack: float) -> float:
        """Book the earliest slack-padded slot for ``runtime`` on ``blk``;
        returns the start time."""
        st = self.earliest_free(blk, runtime + slack)
        self.occupy(blk, st, st + runtime + slack)
        return st


def _min_finish_slot(t, topology: SliceTopology, timeline: DeviceTimeline,
                     ordering_slack: float, probe_cap: Optional[int] = None):
    """(finish, start, size, block, runtime) of the task's earliest-finishing
    (strategy, block) slot, or None when no strategy fits. ``probe_cap``
    stops the search, in the sorted option order, after that many slots once
    one was found."""
    best = None
    probes = 0
    for size, strat in sorted(t.feasible_strategies().items()):
        if size > topology.capacity:
            continue
        for blk in topology.blocks(size):
            if probe_cap is not None and probes >= probe_cap and best is not None:
                return best
            probes += 1
            st = timeline.earliest_free(blk, strat.runtime + ordering_slack)
            fin = st + strat.runtime
            if best is None or fin < best[0]:
                best = (fin, st, size, blk, strat.runtime)
    return best


def _longest_first(t) -> float:
    return -min(s.runtime for s in t.feasible_strategies().values())


def warm_schedule(
    task_list: List,
    topology: SliceTopology,
    previous: Plan,
    ordering_slack: float = 1.0,
    insert_missing: bool = False,
    insertion_probe_cap: Optional[int] = None,
) -> Optional[Plan]:
    """Fix-and-optimize warm start: keep each task's previous (size, block),
    list-schedule the starts under CURRENT runtimes in previous start order.
    Returns None if a task has no usable previous choice, unless
    ``insert_missing``, which appends such tasks at their min-finish slot
    (at most ``insertion_probe_cap`` slots probed each, once one fits: the
    anytime solver's tier 0)."""
    pinned: List[Tuple[object, int, Block, float]] = []
    loose: List = []
    for t in task_list:
        a = previous.assignments.get(t.name)
        strat = (
            t.feasible_strategies().get(a.apportionment) if a is not None else None
        )
        if a is None or strat is None or a.block.end > topology.capacity:
            if not insert_missing:
                return None
            loose.append(t)
            continue
        pinned.append((t, a.apportionment, a.block, strat.runtime))
    pinned.sort(key=lambda p: previous.assignments[p[0].name].start)

    timeline = DeviceTimeline(topology.capacity)
    assignments: Dict[str, Assignment] = {}
    for t, size, blk, rt in pinned:
        st = timeline.place(blk, rt, ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    for t in sorted(loose, key=_longest_first):
        best = _min_finish_slot(t, topology, timeline, ordering_slack,
                                probe_cap=insertion_probe_cap)
        if best is None:
            return None
        fin, st, size, blk, rt = best
        timeline.occupy(blk, st, fin + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)

    makespan = max((a.start + a.runtime for a in assignments.values()), default=0.0)
    plan = Plan(assignments=assignments, makespan=makespan)
    plan.compute_dependencies()
    return plan


def greedy_plan(
    task_list: List, topology: SliceTopology, ordering_slack: float = 0.0,
) -> Plan:
    """List scheduling: longest task first, each at its earliest-finishing
    (strategy, block) slot."""
    timeline = DeviceTimeline(topology.capacity)
    assignments: Dict[str, Assignment] = {}
    for t in sorted(task_list, key=_longest_first):
        best = _min_finish_slot(t, topology, timeline, ordering_slack)
        if best is None:
            raise ValueError(
                f"task {t.name}: no strategy fits topology capacity {topology.capacity}"
            )
        fin, st, size, blk, rt = best
        timeline.occupy(blk, st, fin + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    makespan = max((a.start + a.runtime for a in assignments.values()), default=0.0)
    plan = Plan(assignments=assignments, makespan=makespan)
    plan.compute_dependencies()
    return plan


def solve(
    task_list: List,
    topology: SliceTopology,
    time_limit: Optional[float] = None,
    ordering_slack: float = 1.0,
    milp_task_limit: int = 12,
    warm: Optional[Plan] = None,
) -> Plan:
    """Build and solve the joint strategy/placement/schedule MILP over each
    task's feasible strategies.

    Above ``milp_task_limit`` tasks the exact MILP's pairwise ordering rows
    explode, and the native scheduler (``native_sched``) takes over: the
    same option set, a validated plan, seeded with ``warm``'s choices and
    given ``time_limit`` (5 s when None). Below it a short native pass
    (at most 1 s, taken off ``time_limit``) seeds the MILP: its plan and the
    fix-and-optimize plan of ``warm`` are incumbents, the better one's
    makespan is a cut, and it is the answer when HiGHS strikes out. A native
    plan that fails validation gives way to ``greedy_plan``. The JAX
    package's priority ``weights`` serve its online service, which the port
    does not have yet."""
    for t in task_list:
        if not t.feasible_strategies():
            raise ValueError(f"task {t.name} has no feasible strategy; run search first")
        if all(size > topology.capacity for size in t.feasible_strategies()):
            raise ValueError(
                f"task {t.name}: no strategy fits topology capacity {topology.capacity}"
            )
    from saturn_tpu_torch.solver import native_sched

    wplan = (
        warm_schedule(task_list, topology, warm, ordering_slack, insert_missing=True)
        if warm is not None else None
    )

    if len(task_list) > milp_task_limit:
        plan = native_sched.solve_native(
            task_list, topology,
            time_limit=time_limit if time_limit is not None else 5.0,
            ordering_slack=ordering_slack, warm=warm,
        )
        if plan is not None:
            log.info("large batch (%d tasks): native scheduler makespan %.1fs",
                     len(task_list), plan.makespan)
            if wplan is not None and wplan.makespan < plan.makespan:
                return wplan
            return plan
        if wplan is not None:
            return wplan
        return greedy_plan(task_list, topology, ordering_slack)

    t_pre = time.perf_counter()
    incumbent = native_sched.solve_native(
        task_list, topology, time_limit=min(1.0, time_limit or 1.0),
        ordering_slack=ordering_slack, warm=warm,
    )
    if time_limit is not None:
        time_limit = max(0.1, time_limit - (time.perf_counter() - t_pre))
    if wplan is not None and (incumbent is None or wplan.makespan < incumbent.makespan):
        incumbent = wplan

    m = Model("spase")
    choices: Dict[str, List[Tuple[int, Block, float]]] = {}
    x: Dict[str, List] = {}
    for t in task_list:
        opts = []
        for size, strat in sorted(t.feasible_strategies().items()):
            if size > topology.capacity:
                continue
            for blk in topology.blocks(size):
                opts.append((size, blk, strat.runtime))
        choices[t.name] = opts
        x[t.name] = [m.binary(f"x_{t.name}_{s}_{b.offset}") for s, b, _ in opts]
        m.add(sum(x[t.name][1:], Expr.of(x[t.name][0])) == 1)

    # Horizon: serial sum of worst-case runtimes plus ordering slack; the
    # big-M must relax an ordering row even with a start at the horizon.
    T = sum(max(s.runtime for s in t.feasible_strategies().values()) for t in task_list)
    T += max(0, len(task_list) - 1) * ordering_slack
    T = max(T, 1.0) * 1.05
    M = 2.0 * T + 1.0

    sta = {t.name: m.continuous(f"sta_{t.name}", lb=0.0, ub=T) for t in task_list}
    makespan = m.continuous("makespan", lb=0.0, ub=T)

    def runtime_expr(name: str) -> Expr:
        e = Expr()
        for xi, (_, _, rt) in zip(x[name], choices[name]):
            e = e + xi * rt
        return e

    def occ_expr(name: str, dev: int) -> Expr:
        """Does the task occupy device ``dev``?"""
        e = Expr()
        for xi, (_, blk, _) in zip(x[name], choices[name]):
            if blk.offset <= dev < blk.end:
                e = e + xi
        return e

    names = [t.name for t in task_list]
    rt = {n: runtime_expr(n) for n in names}
    for n in names:
        m.add(makespan >= sta[n] + rt[n])

    # Tasks sharing any device are fully ordered, with slack between them.
    for i, n1 in enumerate(names):
        for n2 in names[i + 1 :]:
            if not any(
                b1.overlaps(b2) for _, b1, _ in choices[n1] for _, b2, _ in choices[n2]
            ):
                continue
            boa = m.binary(f"boa_{n1}_{n2}")  # 1 => n1 before n2
            for dev in range(topology.capacity):
                o1, o2 = occ_expr(n1, dev), occ_expr(n2, dev)
                m.add(sta[n2] >= sta[n1] + rt[n1] + ordering_slack
                      - M * (1 - Expr.of(boa)) - M * (2 - o1 - o2))
                m.add(sta[n1] >= sta[n2] + rt[n2] + ordering_slack
                      - M * Expr.of(boa) - M * (2 - o1 - o2))

    # Area cut: the selected options' work cannot exceed makespan x capacity.
    area = Expr()
    for t in task_list:
        for xi, (size, _, r) in zip(x[t.name], choices[t.name]):
            area = area + xi * (size * r)
    m.add(makespan >= area * (1.0 / topology.capacity))

    # tiny pressure toward early starts keeps solutions canonical
    m.minimize(
        makespan + sum((sta[n] for n in names), Expr()) * (1e-6 / max(len(names), 1))
    )
    if incumbent is not None:
        m.add(makespan <= incumbent.makespan + 1e-6 * max(incumbent.makespan, 1.0))

    res = m.solve(time_limit=time_limit)
    if not res.ok:
        if incumbent is not None:
            log.info("MILP found nothing better than the incumbent in time — keeping it")
            return incumbent
        log.warning("MILP infeasible or failed — taking the greedy plan")
        return greedy_plan(task_list, topology, ordering_slack)

    assignments: Dict[str, Assignment] = {}
    for t in task_list:
        vals = [res.value(xi) for xi in x[t.name]]
        k = max(range(len(vals)), key=lambda i: vals[i])
        size, blk, r = choices[t.name][k]
        assignments[t.name] = Assignment(
            apportionment=size, block=blk,
            start=max(0.0, res.value(sta[t.name])), runtime=r,
        )
    plan = Plan(assignments=assignments, makespan=res.value(makespan))
    plan.compute_dependencies()
    return plan

