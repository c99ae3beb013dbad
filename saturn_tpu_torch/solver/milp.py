"""The SPASE MILP: jointly select strategy, allocate a block, and schedule.

Counterpart of ``saturn_tpu/solver/milp.py``: one joint binary per task over
(block size, aligned block) options, start times, pairwise big-M ordering
for tasks that may share a device, a makespan objective with an area cut,
solved exactly with HiGHS (``solver/lp.py``). The introspective re-solve
is ``solver/anytime.anytime_resolve``, whose tiers call in here; the JAX
package's ``milp.resolve`` has no caller in the port.

As in the JAX package, the native C++ scheduler (``native_sched``) seeds
the MILP with its plan, and above ``milp_task_limit`` tasks it takes over
the whole solve. The co-location term packs a pair of tasks whose measured
host fractions predict an interleave win onto one block at one start
(``Plan.coschedule``), and the fusion pre-pass collapses each fusion group
that its measured lockstep time prices ahead of serial and co-scheduled
runs into one pseudo-task (``Plan.fused``), as in the JAX package. The
online service passes priority ``weights`` (task name -> urgency, from its
admission controller): they order the inserted tasks of ``warm_schedule``
and the list order of ``greedy_plan``, and in the exact MILP they replace
the canonical early-start term with a weighted start-time tiebreak, as in
the JAX package. ``weights=None`` leaves every plan as it was.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

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
    # Co-schedule groups: task names whose windows the engine interleaves
    # on one block (one shared launcher) instead of ordering them. Made by
    # the MILP's co-location term where the measured host fractions predict
    # that one job's host phases hide under the other's device windows.
    coschedule: List[List[str]] = field(default_factory=list)
    # Fusion groups: task names the engine trains as one stacked program
    # (``parallel/fused.py``), every member a batch per lockstep step. The
    # members hold identical assignments by construction. Made only by the
    # fusion pre-pass of :func:`solve`, where every member carries a measured
    # ``fused_per_batch_time`` and the stack beats serial and co-scheduled.
    fused: List[List[str]] = field(default_factory=list)

    def coschedule_group_of(self) -> Dict[str, int]:
        """task name -> index of its co-schedule group (absent = solo)."""
        return {n: gi for gi, grp in enumerate(self.coschedule) for n in grp}

    def fused_group_of(self) -> Dict[str, int]:
        """task name -> index of its fusion group (absent = not fused)."""
        return {n: gi for gi, grp in enumerate(self.fused) for n in grp}

    def compute_dependencies(self) -> None:
        """Edges between tasks whose blocks overlap: the later start depends
        on the earlier one. Members of one co-schedule group are exempt
        (their overlap is the point: one launcher interleaves them), and so
        are members of one fusion group (they are one program)."""
        group_of = self.coschedule_group_of()
        fgroup_of = self.fused_group_of()
        deps: Dict[str, List[str]] = {name: [] for name in self.assignments}
        items = list(self.assignments.items())
        for i, (n1, a1) in enumerate(items):
            for n2, a2 in items[i + 1 :]:
                g1, g2 = group_of.get(n1), group_of.get(n2)
                if g1 is not None and g1 == g2:
                    continue
                f1, f2 = fgroup_of.get(n1), fgroup_of.get(n2)
                if f1 is not None and f1 == f2:
                    continue
                if a1.block.overlaps(a2.block):
                    if a1.start <= a2.start:
                        deps[n2].append(n1)
                    else:
                        deps[n1].append(n2)
        self.dependencies = deps

    def migrations_from(self, previous: "Plan") -> Dict[str, dict]:
        """Each task's placement against ``previous`` (the elastic
        replanner's migration report): a task "moved" when its block size
        or offset changed, so its next interval restores its checkpoint on
        the new block instead of keeping its live state."""
        out: Dict[str, dict] = {}
        for name, a in self.assignments.items():
            p = previous.assignments.get(name)
            if p is None:
                out[name] = {"moved": True, "from": None,
                             "to": [a.apportionment, a.block.offset]}
                continue
            moved = (a.apportionment != p.apportionment or a.block.offset != p.block.offset
                     or a.block.size != p.block.size)
            out[name] = {"moved": moved, "from": [p.apportionment, p.block.offset],
                         "to": [a.apportionment, a.block.offset]}
        return out

    def to_json(self) -> dict:
        """The JAX package's dict form (``plan_commit`` journal records)."""
        return {
            "makespan": self.makespan,
            "assignments": {
                n: [a.apportionment, a.block.offset, a.block.size, a.start, a.runtime]
                for n, a in self.assignments.items()
            },
            "dependencies": self.dependencies,
            "coschedule": [list(g) for g in self.coschedule],
            "fused": [list(g) for g in self.fused],
        }

    @staticmethod
    def from_json(d: dict) -> "Plan":
        """A plan from :meth:`to_json`'s form, the JAX package's included
        (groups absent in older records read as none)."""
        return Plan(
            assignments={
                n: Assignment(int(app), Block(int(off), int(size)), float(st), float(rt))
                for n, (app, off, size, st, rt) in d["assignments"].items()
            },
            makespan=float(d["makespan"]),
            dependencies={k: list(v) for k, v in d["dependencies"].items()},
            coschedule=[list(g) for g in d.get("coschedule", [])],
            fused=[list(g) for g in d.get("fused", [])],
        )


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


def _priority_order(weights: Optional[Dict[str, float]]):
    """The list order of the greedy rules: higher weight first, then the
    longest first (with no weights, the longest first alone)."""
    w = weights or {}
    return lambda t: (-w.get(t.name, 0.0), _longest_first(t))


def warm_schedule(
    task_list: List,
    topology: SliceTopology,
    previous: Plan,
    ordering_slack: float = 1.0,
    insert_missing: bool = False,
    weights: Optional[Dict[str, float]] = None,
    insertion_probe_cap: Optional[int] = None,
) -> Optional[Plan]:
    """Fix-and-optimize warm start: keep each task's previous (size, block),
    list-schedule the starts under CURRENT runtimes in previous start order.
    Returns None if a task has no usable previous choice, unless
    ``insert_missing``, which appends such tasks at their min-finish slot
    (at most ``insertion_probe_cap`` slots probed each, once one fits: the
    anytime solver's tier 0), in descending ``weights`` order (priority
    first, then the longest first): the online service's incremental warm
    start, where an arrival perturbs the live plan instead of voiding it."""
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
    for t in sorted(loose, key=_priority_order(weights)):
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
    weights: Optional[Dict[str, float]] = None,
) -> Plan:
    """List scheduling: longest task first (after the higher ``weights``,
    where given), each at its earliest-finishing (strategy, block) slot."""
    timeline = DeviceTimeline(topology.capacity)
    assignments: Dict[str, Assignment] = {}
    for t in sorted(task_list, key=_priority_order(weights)):
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


def _host_fraction_of(task, size: int) -> float:
    """Measured host fraction of the task's strategy at ``size``, in [0, 1];
    0.0 when unmeasured, which predicts no interleave win."""
    strat = getattr(task, "strategies", {}).get(size)
    if strat is None:
        return 0.0
    hf = float(getattr(strat, "host_fraction", 0.0) or 0.0)
    return min(max(hf, 0.0), 1.0)


def _fillable_fraction_of(task, size: int) -> float:
    """Fraction of a steady-state batch in which the task's devices are idle
    and a co-scheduled partner could run: the measured host fraction plus
    the schedule's bubble fraction, clamped to [0, 1]."""
    strat = getattr(task, "strategies", {}).get(size)
    if strat is None:
        return 0.0
    hf = float(getattr(strat, "host_fraction", 0.0) or 0.0)
    bubble = float(getattr(strat, "bubble_fraction", 0.0) or 0.0)
    return min(max(hf, 0.0) + max(bubble, 0.0), 1.0)


def coschedule_candidates(
    task_list: List,
    choices: Dict[str, List[Tuple[int, Block, float]]],
    min_gain: float,
) -> List[Tuple[str, str, List[Tuple[int, int, float]]]]:
    """Task pairs whose measured host fractions predict an interleave win.

    For each (size, block) option both tasks could take, the interleaved
    pair holds the block for ``comb = max(rt1, rt2, dev1 + dev2)``, where
    ``dev = (1 - fillable) * rt``: device phases serialize, host staging and
    schedule bubbles hide under the partner's device windows. A pair is a
    candidate when its best common option predicts ``(rt1 + rt2) / comb >=
    min_gain``; two compute-bound jobs (gain 1.0) never are. Returns
    ``(n1, n2, [(i1, i2, comb), ...])`` with option indices into each task's
    choice list."""
    by_name = {t.name: t for t in task_list}
    names = [t.name for t in task_list]
    out: List[Tuple[str, str, List[Tuple[int, int, float]]]] = []
    for i, n1 in enumerate(names):
        for n2 in names[i + 1 :]:
            opt2 = {(s, b.offset, b.size): (j, rt) for j, (s, b, rt) in enumerate(choices[n2])}
            common: List[Tuple[int, int, float]] = []
            best_gain = 0.0
            for i1, (s, b, rt1) in enumerate(choices[n1]):
                hit = opt2.get((s, b.offset, b.size))
                if hit is None:
                    continue
                i2, rt2 = hit
                f1 = _fillable_fraction_of(by_name[n1], s)
                f2 = _fillable_fraction_of(by_name[n2], s)
                comb = max(rt1, rt2, (1.0 - f1) * rt1 + (1.0 - f2) * rt2)
                common.append((i1, i2, comb))
                if comb > 1e-9:
                    best_gain = max(best_gain, (rt1 + rt2) / comb)
            if common and best_gain >= min_gain:
                out.append((n1, n2, common))
    return out


class _FusedPseudoTask:
    """What the solver schedules in place of a whole fusion group: only the
    sizes the group was priced at, so no solver path can place it at a size
    its stacked program was never profiled for. Its strategies carry no host
    or bubble fraction, which keeps it out of the co-location term."""

    def __init__(self, name: str, strategies: Dict[int, Any]):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self) -> Dict[int, Any]:
        return self.strategies


def _remaining_batches(strat) -> Optional[float]:
    """Remaining batches implied by a strategy's runtime and per-batch time;
    None where the per-batch time was never measured (fusion pricing does
    not guess)."""
    pbt = float(getattr(strat, "per_batch_time", 0.0) or 0.0)
    if pbt <= 0.0:
        return None
    return max(0.0, float(strat.runtime) / pbt)


def fusion_priced_groups(
    task_list: List,
    proposed: List[List[str]],
    topology: SliceTopology,
    fusion_exclude=None,
    fusion_fits=None,
) -> List[Tuple[List[str], int, float, float]]:
    """Price each proposed fusion group on measured cost; keep the winners.

    At each size where every member holds a feasible strategy with a
    measured ``fused_per_batch_time``, the stack holds the block for
    ``max_m(remaining batches) * max_m(fused_per_batch_time)`` (lockstep).
    The group fuses only where that beats the serial sum of the members'
    runtimes and the co-scheduled alternative (members paired longest with
    longest, each pair at its interleaved occupancy, pairs serialized).
    ``fusion_exclude`` drops members (the guardian's detached tasks); the
    rest may still fuse if two remain. ``fusion_fits(member_tasks, size,
    n_members)`` is the residency gate: False vetoes the size, None
    (unknown) does not. Returns ``[(member names, size, fused runtime,
    fused per-batch time)]``, each group at its best size."""
    by_name = {t.name: t for t in task_list}
    excl = set(fusion_exclude or ())
    out: List[Tuple[List[str], int, float, float]] = []
    claimed: set = set()
    for group in proposed:
        names = [n for n in group if n in by_name and n not in excl and n not in claimed]
        if len(names) < 2:
            continue
        members = [by_name[n] for n in names]
        common = None
        for m in members:
            sizes = {
                s for s, strat in m.feasible_strategies().items()
                if s <= topology.capacity
                and getattr(strat, "fused_per_batch_time", None) is not None
            }
            common = sizes if common is None else (common & sizes)
        best: Optional[Tuple[float, int, float]] = None  # (fused_rt, size, fpbt)
        for size in sorted(common or ()):
            strats = [m.feasible_strategies()[size] for m in members]
            batches = [_remaining_batches(s) for s in strats]
            if any(b is None for b in batches):
                continue
            fpbt = max(float(s.fused_per_batch_time) for s in strats)
            fused_rt = max(batches) * fpbt
            serial = sum(float(s.runtime) for s in strats)
            ordered = sorted(zip(members, strats), key=lambda p: -float(p[1].runtime))
            cosched = 0.0
            i = 0
            while i < len(ordered):
                if i + 1 < len(ordered):
                    (t1, s1), (t2, s2) = ordered[i], ordered[i + 1]
                    f1 = _fillable_fraction_of(t1, size)
                    f2 = _fillable_fraction_of(t2, size)
                    rt1, rt2 = float(s1.runtime), float(s2.runtime)
                    cosched += max(rt1, rt2, (1.0 - f1) * rt1 + (1.0 - f2) * rt2)
                    i += 2
                else:
                    cosched += float(ordered[i][1].runtime)
                    i += 1
            if fused_rt >= min(serial, cosched):
                continue
            if fusion_fits is not None and fusion_fits(members, size, len(members)) is False:
                continue
            if best is None or fused_rt < best[0]:
                best = (fused_rt, size, fpbt)
        if best is not None:
            fused_rt, size, fpbt = best
            out.append((names, size, fused_rt, fpbt))
            claimed.update(names)
    return out


def fusion_reduce(task_list: List, fusion: List[List[str]], topology: SliceTopology,
                  fusion_exclude=None, fusion_fits=None):
    """The fusion pre-pass: ``(reduced task list, winners)``, where each
    group :func:`fusion_priced_groups` keeps becomes one
    :class:`_FusedPseudoTask` named after its first member, with every size
    the group was priced at; ``winners`` is empty when none is kept.
    :func:`fusion_expand` maps a plan of the reduced list back, and
    :func:`fusion_weights` the priority weights onto the reduced list."""
    winners = fusion_priced_groups(task_list, fusion, topology,
                                   fusion_exclude=fusion_exclude, fusion_fits=fusion_fits)
    if not winners:
        return list(task_list), []
    from saturn_tpu_torch.core.strategy import Strategy

    by_name = {t.name: t for t in task_list}
    fused_member = {n for names, _, _, _ in winners for n in names}
    reduced: List = []
    for names, _, _, _ in winners:
        strategies: Dict[int, Any] = {}
        common = None
        for n in names:
            sizes = {
                s for s, st in by_name[n].feasible_strategies().items()
                if s <= topology.capacity
                and getattr(st, "fused_per_batch_time", None) is not None
                and _remaining_batches(st) is not None
            }
            common = sizes if common is None else (common & sizes)
        for size in sorted(common or ()):
            strats = [by_name[n].feasible_strategies()[size] for n in names]
            fpbt = max(float(s.fused_per_batch_time) for s in strats)
            fused_rt = max(_remaining_batches(s) for s in strats) * fpbt
            if fusion_fits is not None and fusion_fits(
                    [by_name[n] for n in names], size, len(names)) is False:
                continue
            strategies[size] = Strategy(
                executor=strats[0].executor, apportionment=size,
                params=dict(strats[0].params or {}), runtime=fused_rt,
                per_batch_time=fpbt,
            )
        reduced.append(_FusedPseudoTask(names[0], strategies))
    reduced.extend(t for t in task_list if t.name not in fused_member)
    return reduced, winners


def fusion_weights(weights: Optional[Dict[str, float]], winners):
    """``weights`` over :func:`fusion_reduce`'s list: a group's pseudo-task
    weighs as its heaviest member. None stays None."""
    if not weights:
        return weights
    out = dict(weights)
    for names, _, _, _ in winners:
        out[names[0]] = max((weights.get(n, 0.0) for n in names), default=0.0)
    return out


def fusion_expand(inner: Plan, winners) -> Plan:
    """A plan of :func:`fusion_reduce`'s list with every fusion group's
    members holding their pseudo-task's assignment, and ``Plan.fused``
    naming the groups."""
    assignments = dict(inner.assignments)
    for names, _, _, _ in winners:
        rep_a = assignments[names[0]]
        for n in names[1:]:
            assignments[n] = Assignment(rep_a.apportionment, rep_a.block, rep_a.start,
                                        rep_a.runtime)
    plan = Plan(assignments=assignments, makespan=inner.makespan,
                coschedule=inner.coschedule,
                fused=[list(names) for names, _, _, _ in winners])
    plan.compute_dependencies()
    log.info("fusion pre-pass: %d group(s) priced in favor of stacking (%s)", len(winners),
             "; ".join(f"{len(names)}@{size} fused={rt:.1f}s"
                       for names, size, rt, _ in winners))
    return plan


def solve(
    task_list: List,
    topology: SliceTopology,
    time_limit: Optional[float] = None,
    ordering_slack: float = 1.0,
    milp_task_limit: int = 12,
    warm: Optional[Plan] = None,
    weights: Optional[Dict[str, float]] = None,
    coschedule_min_gain: float = 1.15,
    coschedule_exclude=None,
    fusion: Optional[List[List[str]]] = None,
    fusion_exclude=None,
    fusion_fits=None,
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
    plan that fails validation gives way to ``greedy_plan``.

    ``coschedule_min_gain``: the least predicted pair speedup (serial sum
    over interleaved occupancy, :func:`coschedule_candidates`) for a pair
    to enter the co-location term; only the exact MILP forms co-schedule
    groups. ``coschedule_exclude``: names kept out of it (the guardian's
    detached tasks). ``fusion``: proposed fusion groups
    (``parallel.fused.fusion_candidates``), priced by
    :func:`fusion_priced_groups` with ``fusion_exclude`` and
    ``fusion_fits``; each winner is solved as one pseudo-task by every
    path and expanded after (:func:`fusion_reduce`, :func:`fusion_expand`).

    ``weights`` (task name -> nonnegative urgency, from the service's
    admission controller) adds a priority term to the objective: among
    makespan-equal schedules, higher-weight tasks start earlier. The term
    is at most 0.5 % of the horizon, so it reorders and never trades
    makespan away; the greedy and warm paths take the same order."""
    for t in task_list:
        if not t.feasible_strategies():
            raise ValueError(f"task {t.name} has no feasible strategy; run search first")
        if all(size > topology.capacity for size in t.feasible_strategies()):
            raise ValueError(
                f"task {t.name}: no strategy fits topology capacity {topology.capacity}"
            )
    if fusion:
        reduced, winners = fusion_reduce(task_list, fusion, topology,
                                         fusion_exclude=fusion_exclude,
                                         fusion_fits=fusion_fits)
        if winners:
            inner = solve(reduced, topology, time_limit=time_limit,
                          ordering_slack=ordering_slack, milp_task_limit=milp_task_limit,
                          warm=warm, weights=fusion_weights(weights, winners),
                          coschedule_min_gain=coschedule_min_gain,
                          coschedule_exclude=coschedule_exclude)
            return fusion_expand(inner, winners)
    from saturn_tpu_torch.solver import native_sched

    wplan = (
        warm_schedule(task_list, topology, warm, ordering_slack, insert_missing=True,
                      weights=weights)
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
        return greedy_plan(task_list, topology, ordering_slack, weights=weights)

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

    # Co-location term: a binary ``co`` per candidate pair pins both tasks
    # to one common (size, block) option at one start; their ordering rows
    # relax, and each member's effective runtime (what third parties on the
    # block and the makespan see) rises to the pair's combined occupancy.
    co_pairs = coschedule_candidates(task_list, choices, coschedule_min_gain)
    if coschedule_exclude:
        excl = set(coschedule_exclude)
        co_pairs = [(n1, n2, c) for n1, n2, c in co_pairs
                    if n1 not in excl and n2 not in excl]
    co_of: Dict[Tuple[str, str], Any] = {}
    eff: Dict[str, Expr] = {n: runtime_expr(n) for n in names}
    per_task_cos: Dict[str, List] = {}
    for n1, n2, common in co_pairs:
        co = m.binary(f"co_{n1}_{n2}")
        co_of[(n1, n2)] = co
        per_task_cos.setdefault(n1, []).append(co)
        per_task_cos.setdefault(n2, []).append(co)
        common1 = {i1 for i1, _, _ in common}
        common2 = {i2 for _, i2, _ in common}
        for j, xi in enumerate(x[n1]):
            if j not in common1:
                m.add(Expr.of(xi) <= Expr.of(1.0) - co)
        for j, xi in enumerate(x[n2]):
            if j not in common2:
                m.add(Expr.of(xi) <= Expr.of(1.0) - co)
        for i1, i2, _ in common:
            m.link_when(co, x[n1][i1], x[n2][i2], 1.0)
        m.link_when(co, sta[n1], sta[n2], M)
    if per_task_cos:
        for n, cos in per_task_cos.items():
            # one partner per task: groups stay pairs
            if len(cos) > 1:
                m.add(sum(cos[1:], Expr.of(cos[0])) <= 1)
            ert = m.continuous(f"ert_{n}", lb=0.0, ub=M)
            m.add(Expr.of(ert) >= runtime_expr(n))
            eff[n] = Expr.of(ert)
        for n1, n2, common in co_pairs:
            co = co_of[(n1, n2)]
            comb_expr = Expr()
            for i1, _, comb in common:
                comb_expr = comb_expr + x[n1][i1] * comb
            m.add(eff[n1] >= comb_expr - (Expr.of(1.0) - co) * M)
            m.add(eff[n2] >= comb_expr - (Expr.of(1.0) - co) * M)

    for n in names:
        m.add(makespan >= sta[n] + eff[n])

    # Tasks sharing any device are fully ordered, with slack between them,
    # unless their co binary is set.
    for i, n1 in enumerate(names):
        for n2 in names[i + 1 :]:
            if not any(
                b1.overlaps(b2) for _, b1, _ in choices[n1] for _, b2, _ in choices[n2]
            ):
                continue
            boa = m.binary(f"boa_{n1}_{n2}")  # 1 => n1 before n2
            co = co_of.get((n1, n2))
            co_relax = Expr.of(co) * M if co is not None else Expr.of(0.0)
            for dev in range(topology.capacity):
                o1, o2 = occ_expr(n1, dev), occ_expr(n2, dev)
                m.add(sta[n2] >= sta[n1] + eff[n1] + ordering_slack
                      - M * (1 - Expr.of(boa)) - M * (2 - o1 - o2) - co_relax)
                m.add(sta[n1] >= sta[n2] + eff[n2] + ordering_slack
                      - M * Expr.of(boa) - M * (2 - o1 - o2) - co_relax)

    # Area cut: the selected options' work cannot exceed makespan x capacity;
    # a co-scheduled pair's host phases take no device area.
    area = Expr()
    for t in task_list:
        for xi, (size, _, r) in zip(x[t.name], choices[t.name]):
            area = area + xi * (size * r)
    for n1, n2, common in co_pairs:
        co = co_of[(n1, n2)]
        sav = m.continuous(f"sav_{n1}_{n2}", lb=0.0, ub=M * topology.capacity)
        savings_expr = Expr()
        for i1, i2, comb in common:
            size, _, rt1 = choices[n1][i1]
            _, _, rt2 = choices[n2][i2]
            savings_expr = savings_expr + x[n1][i1] * (max(0.0, rt1 + rt2 - comb) * size)
        m.add(Expr.of(sav) <= savings_expr)
        m.add(Expr.of(sav) <= Expr.of(co) * (M * topology.capacity))
        area = area - Expr.of(sav)
    m.add(makespan >= area * (1.0 / topology.capacity))

    # tiny pressure against co-location among makespan-equal schedules
    co_term = sum((Expr.of(c) for c in co_of.values()), Expr()) * (1e-4 * T)
    if weights:
        # priority pressure: weighted starts, normalized so the whole term
        # is at most 0.5 % of the horizon (a tiebreak, never a makespan trade)
        wsum = sum(max(weights.get(n, 0.0), 0.0) for n in names) or 1.0
        wterm = Expr()
        for n in names:
            wn = max(weights.get(n, 0.0), 0.0)
            if wn > 0.0:
                wterm = wterm + sta[n] * (wn / wsum)
        m.minimize(makespan + wterm * 5e-3 + co_term)
    else:
        # toward early starts (keeps solutions canonical)
        m.minimize(
            makespan + sum((sta[n] for n in names), Expr()) * (1e-6 / max(len(names), 1))
            + co_term
        )
    if incumbent is not None:
        m.add(makespan <= incumbent.makespan + 1e-6 * max(incumbent.makespan, 1.0))

    res = m.solve(time_limit=time_limit)
    if not res.ok:
        if incumbent is not None:
            log.info("MILP found nothing better than the incumbent in time — keeping it")
            return incumbent
        log.warning("MILP infeasible or failed — taking the greedy plan")
        return greedy_plan(task_list, topology, ordering_slack, weights=weights)

    assignments: Dict[str, Assignment] = {}
    for t in task_list:
        vals = [res.value(xi) for xi in x[t.name]]
        k = max(range(len(vals)), key=lambda i: vals[i])
        size, blk, r = choices[t.name][k]
        assignments[t.name] = Assignment(
            apportionment=size, block=blk,
            start=max(0.0, res.value(sta[t.name])), runtime=r,
        )
    groups = [[n1, n2] for (n1, n2), co in co_of.items() if res.value(co) > 0.5]
    plan = Plan(assignments=assignments, makespan=res.value(makespan), coschedule=groups)
    plan.compute_dependencies()
    return plan
