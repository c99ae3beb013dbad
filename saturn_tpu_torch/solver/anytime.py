"""Anytime tiered solver: deadline-bounded solves and re-solves.

Counterpart of ``saturn_tpu/solver/anytime.py``. The orchestrator makes
every solve and re-solve through :func:`anytime_resolve`, which always
returns a plan inside a caller-supplied deadline by racing down a quality
ladder, cheapest-sufficient tier first:

- **tier 0 — incremental**: warm-started delta re-placement. Survivors keep
  last interval's (size, block) choice; only the delta since the last
  adopted plan (arrivals, evictions, strategy changes) is inserted, each at
  a probe-capped min-finish slot. Extends ``warm_schedule`` below
  ``_INCR_BACKFILL_N`` tasks (backfill quality); above it a frontier
  timeline keeps placement O(block size).
- **tier 1 — hierarchical decomposition**: partition jobs by slice affinity
  (previous block) and preferred size class, solve each partition's MILP
  independently under a per-partition time slice, stitch with a
  conflict-resolving merge (partition start order, min-finish block choice
  on the partition-chosen size). A single-partition instance degenerates to
  the exact MILP — small batches lose nothing.
- **tier 2 — LP relaxation + randomized rounding**: the apportionment LP
  (per-task fractional size choice + the area bound), built directly on
  scipy arrays, then seeded rounding rounds list-scheduled on the frontier.
  Round 0 is the plain greedy, so tier 2 is never worse than the floor; the
  LP optimum doubles as a quality lower bound.
- **tier 3 — greedy floor**: ``milp.greedy_plan`` (backfill) at small N,
  frontier greedy at large N. Never fails; adopted only when every richer
  tier was deadline-starved.

Every produced plan is a plain :class:`~saturn_tpu_torch.solver.milp.Plan`
that passes the ``analysis.plan_verifier`` gate; large plans carry sparse
per-device *chain* dependencies (consecutive occupants of each device)
instead of the O(N²) all-overlapping-pairs edge set — same race-freedom
guarantee, linear size.

``anytime_resolve`` keeps the compare-and-swap contract of the JAX
package's ``milp.resolve`` and emits one ``solver_tier`` metrics event per call (tier chosen, wall
time, deadline, job count, quality estimate). Fusion groups are priced and
collapsed once, before the ladder (``milp.fusion_reduce``): every tier
places a winning group as one pseudo-task, and the adopted plan is expanded
(``milp.fusion_expand``). Co-schedule groups come from the exact MILP only
(tier 1 at one partition), and ``coschedule_exclude`` reaches it; a slid
plan keeps the groups whose members all remain, and a group holding an
excluded member makes the fresh plan win. The online service's priority
``weights`` reach every tier, as in the JAX package: tier 0 inserts the
delta heaviest first, tier 1's MILPs take the weighted start-time
tiebreak, tiers 2 and 3 list-schedule heaviest first (then the longest
first); a fusion group weighs as its heaviest member. ``weights=None``
leaves every plan as it was.

Operator knobs (environment, the JAX package's names):

- ``SATURN_TPU_SOLVE_DEADLINE``: per-re-solve deadline override in seconds
  (wins over the interval-derived budget).
- ``SATURN_TPU_PARTITION_MAX``: max jobs per tier-1 partition (default 10;
  also the size below which an instance is solved exactly).
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.solver.milp import Assignment, Plan
from saturn_tpu_torch.utils import metrics

log = logging.getLogger("saturn_tpu_torch")

DEADLINE_ENV = "SATURN_TPU_SOLVE_DEADLINE"
PARTITION_MAX_ENV = "SATURN_TPU_PARTITION_MAX"

TIER_NAMES = {0: "incremental", 1: "partition", 2: "lp_round", 3: "greedy"}

# --- ladder applicability thresholds (calibrated on the bench host; every
# estimate errs high so a tier that starts is expected to finish in budget).
_INCR_BACKFILL_N = 160    # below: tier 0 reuses warm_schedule's backfill rule
_CHAIN_DEP_N = 256        # above: plans carry sparse chain dependencies
_INSERTION_PROBE_CAP = 32  # tier-0 per-newcomer (strategy, block) probe cap
_MIN_PART_SLICE = 0.25    # tier 1 needs at least this much budget/partition
_MAX_PARTS = 48           # beyond this many partitions, stitch overhead wins
_DEFAULT_DEADLINE = 5.0   # only when a site passes neither deadline nor env


def partition_max() -> int:
    try:
        return max(2, int(os.environ.get(PARTITION_MAX_ENV, "10")))
    except ValueError:
        return 10


@dataclass
class AnytimeReport:
    """What the ladder did for one re-solve (attached to the returned plan
    as ``plan.anytime`` and emitted as the ``solver_tier`` metrics event)."""

    tier: int                 # tier that produced the adopted plan
    wall_s: float             # total front-end wall time
    deadline_s: float         # the budget this re-solve was given
    n_tasks: int
    n_loose: int              # delta size seen by tier 0 (0 = full warm)
    makespan: float
    lower_bound: float        # cheap/LP makespan lower bound (0 if unknown)
    quality: Optional[float]  # makespan / lower_bound (>= 1.0; None if no lb)
    tiers_tried: List[int] = field(default_factory=list)
    outcome: str = "fresh"    # "fresh" or "slid" (compare-and-swap kept old)
    # assignments of the adopted plan that rest on priors
    # (``Strategy.static_prior``) rather than trials
    n_static_prior: int = 0

    @property
    def tier_name(self) -> str:
        return TIER_NAMES.get(self.tier, str(self.tier))

    @property
    def deadline_missed(self) -> bool:
        """The ladder overran its budget (its contract is that it never
        does; the twin's campaigns count each one)."""
        return self.wall_s > self.deadline_s


# ---------------------------------------------------------------------------
# the frontier: O(block size) placement for large plans
# ---------------------------------------------------------------------------

def chain_dependencies(assignments: Dict[str, Assignment],
                       coschedule: Optional[List[List[str]]] = None,
                       fused: Optional[List[List[str]]] = None) -> Dict[str, List[str]]:
    """Sparse per-device chain edges: on every device, each occupant depends
    on the previous occupant (start order). Any two tasks whose blocks
    overlap share at least one device, so they are connected through that
    device's chain — the same race-freedom property the O(N²)
    ``Plan.compute_dependencies`` edge set guarantees, at O(total occupancy)
    size. Members of one co-schedule or one fusion group are exempt, as
    there."""
    group_of = {n: gi for gi, grp in enumerate(coschedule or []) for n in grp}
    fgroup_of = {n: gi for gi, grp in enumerate(fused or []) for n in grp}
    per_device: Dict[int, List[Tuple[float, str]]] = {}
    for name, a in assignments.items():
        for d in range(a.block.offset, a.block.end):
            per_device.setdefault(d, []).append((a.start, name))
    deps: Dict[str, set] = {name: set() for name in assignments}
    for occ in per_device.values():
        occ.sort()
        for (_, n1), (_, n2) in zip(occ, occ[1:]):
            g1, g2 = group_of.get(n1), group_of.get(n2)
            if g1 is not None and g1 == g2:
                continue
            f1, f2 = fgroup_of.get(n1), fgroup_of.get(n2)
            if f1 is not None and f1 == f2:
                continue
            deps[n2].add(n1)
    return {name: sorted(d) for name, d in deps.items()}


def _set_dependencies(plan: Plan) -> None:
    """Scale-appropriate dependencies: chains above ``_CHAIN_DEP_N`` tasks,
    every overlapping pair below."""
    if len(plan.assignments) > _CHAIN_DEP_N:
        plan.dependencies = chain_dependencies(plan.assignments, plan.coschedule,
                                               plan.fused)
    else:
        plan.compute_dependencies()


def _finish_plan(assignments: Dict[str, Assignment]) -> Plan:
    """Wrap assignments in a Plan with scale-appropriate dependencies."""
    makespan = max((a.start + a.runtime for a in assignments.values()), default=0.0)
    plan = Plan(assignments=assignments, makespan=makespan)
    _set_dependencies(plan)
    return plan


_BLOCK_CACHE: Dict[Tuple[int, int], List[Block]] = {}


def _blocks_cached(size: int, capacity: int) -> List[Block]:
    key = (size, capacity)
    blks = _BLOCK_CACHE.get(key)
    if blks is None:
        blks = [Block(off, size) for off in range(0, capacity, size)
                ] if 0 < size <= capacity else []
        _BLOCK_CACHE[key] = blks
    return blks


def _validate(task_list: Sequence, topology: SliceTopology) -> None:
    for t in task_list:
        feas = t.feasible_strategies()
        if not feas:
            raise ValueError(f"task {t.name} has no feasible strategy; run search first")
        if all(size > topology.capacity for size in feas):
            raise ValueError(
                f"task {t.name}: no strategy fits topology capacity {topology.capacity}")


def _lpt_key(t) -> float:
    """Longest-processing-time-first order: the longest fastest option first."""
    return -min(s.runtime for s in t.feasible_strategies().values())


def _order_key(weights: Optional[Dict[str, float]]):
    """Priority-then-LPT order (LPT alone without weights)."""
    w = weights or {}
    return lambda t: (-w.get(t.name, 0.0), _lpt_key(t))


def _min_finish(free: List[float], options, cap: int, probe_cap: Optional[int] = None):
    """(finish, start, size, block, runtime) of the earliest-finishing option
    on the frontier ``free`` (each device's next free time: no backfill,
    unlike ``milp.DeviceTimeline``, so a placement costs O(block size));
    ``options`` is ``[(size, runtime)]`` in sorted order, ``probe_cap`` as
    in ``milp.warm_schedule``."""
    best = None
    probes = 0
    for size, rt in options:
        for blk in _blocks_cached(size, cap):
            if probe_cap is not None and probes >= probe_cap and best is not None:
                return best
            probes += 1
            st = max(free[d] for d in range(blk.offset, blk.end))
            if best is None or st + rt < best[0]:
                best = (st + rt, st, size, blk, rt)
    return best


def _sized_options(t, cap: int) -> List[Tuple[int, float]]:
    return [(size, s.runtime) for size, s in sorted(t.feasible_strategies().items())
            if size <= cap]


def _occupy(free: List[float], blk: Block, end: float) -> None:
    for d in range(blk.offset, blk.end):
        free[d] = end


def cheap_lower_bound(task_list: Sequence, topology: SliceTopology) -> float:
    """O(N) valid makespan lower bound: longest single task's fastest
    option, and the work-area bound (best-case area / capacity). Loose by
    construction — 'quality vs bound' overstates the true gap."""
    cap = topology.capacity
    longest = 0.0
    area = 0.0
    for t in task_list:
        opts = _sized_options(t, cap)
        if not opts:
            continue
        longest = max(longest, min(rt for _, rt in opts))
        area += min(size * rt for size, rt in opts)
    return max(longest, area / max(cap, 1))


# ---------------------------------------------------------------------------
# tier 3 — greedy floor
# ---------------------------------------------------------------------------

def fast_greedy_plan(task_list: Sequence, topology: SliceTopology,
                     ordering_slack: float = 1.0,
                     weights: Optional[Dict[str, float]] = None) -> Plan:
    """Frontier list-scheduling floor: priority-then-LPT order, min-finish
    (size, block) choice. Same decision rule as ``milp.greedy_plan`` minus
    backfill — O(N · capacity) total."""
    cap = topology.capacity
    free = [0.0] * cap
    assignments: Dict[str, Assignment] = {}
    for t in sorted(task_list, key=_order_key(weights)):
        best = _min_finish(free, _sized_options(t, cap), cap)
        if best is None:
            raise ValueError(f"task {t.name}: no strategy fits topology capacity {cap}")
        fin, st, size, blk, rt = best
        _occupy(free, blk, fin + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    return _finish_plan(assignments)


def _greedy_floor(task_list, topology, ordering_slack, weights=None) -> Plan:
    if len(task_list) <= _CHAIN_DEP_N:
        return milp.greedy_plan(task_list, topology, ordering_slack, weights=weights)
    return fast_greedy_plan(task_list, topology, ordering_slack, weights)


# ---------------------------------------------------------------------------
# tier 0 — warm-started incremental delta re-placement
# ---------------------------------------------------------------------------

def split_delta(task_list: Sequence, topology: SliceTopology,
                previous: Optional[Plan]) -> Tuple[List, List]:
    """(pinned, loose): tasks whose previous (size, block) choice is still
    valid vs the delta the incremental tier must re-place."""
    if previous is None:
        return [], list(task_list)
    pinned, loose = [], []
    for t in task_list:
        a = previous.assignments.get(t.name)
        strat = t.feasible_strategies().get(a.apportionment) if a is not None else None
        if a is None or strat is None or a.block.end > topology.capacity:
            loose.append(t)
        else:
            pinned.append(t)
    return pinned, loose


def incremental_plan(task_list: Sequence, topology: SliceTopology,
                     previous: Plan, ordering_slack: float = 1.0,
                     weights: Optional[Dict[str, float]] = None,
                     probe_cap: int = _INSERTION_PROBE_CAP) -> Optional[Plan]:
    """Tier 0: survivors keep their previous (size, block) in previous start
    order; the delta is inserted at probe-capped min-finish slots. Below
    ``_INCR_BACKFILL_N`` this IS ``warm_schedule(insert_missing=True)``
    (backfill quality); above it, the frontier rule keeps the whole pass
    O(N · block size)."""
    if len(task_list) <= _INCR_BACKFILL_N:
        return milp.warm_schedule(task_list, topology, previous, ordering_slack,
                                  insert_missing=True, weights=weights,
                                  insertion_probe_cap=probe_cap)

    cap = topology.capacity
    pinned_t, loose = split_delta(task_list, topology, previous)
    pinned: List[Tuple[Any, int, Block, float]] = []
    for t in pinned_t:
        a = previous.assignments[t.name]
        pinned.append((t, a.apportionment, a.block,
                       t.feasible_strategies()[a.apportionment].runtime))
    pinned.sort(key=lambda p: previous.assignments[p[0].name].start)

    free = [0.0] * cap
    assignments: Dict[str, Assignment] = {}
    for t, size, blk, rt in pinned:
        st = max(free[d] for d in range(blk.offset, blk.end))
        _occupy(free, blk, st + rt + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    for t in sorted(loose, key=_order_key(weights)):
        best = _min_finish(free, _sized_options(t, cap), cap, probe_cap=probe_cap)
        if best is None:
            return None
        fin, st, size, blk, rt = best
        _occupy(free, blk, fin + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    return _finish_plan(assignments)


# ---------------------------------------------------------------------------
# tier 1 — hierarchical decomposition (partition / solve / stitch)
# ---------------------------------------------------------------------------

def _partitions(task_list: Sequence, previous: Optional[Plan],
                max_size: int) -> List[List]:
    """Group by (preferred size class, previous-block slice affinity), then
    chunk each group to ``max_size``. Tasks that shared a block region last
    interval land in one partition, so the per-partition MILP sees the
    ordering conflicts that actually matter."""
    groups: Dict[Tuple[int, int], List] = {}
    for t in task_list:
        feas = t.feasible_strategies()
        pref = min(feas.items(), key=lambda kv: kv[1].runtime)[0]
        a = previous.assignments.get(t.name) if previous is not None else None
        affinity = a.block.offset // max(a.block.size, 1) if a is not None else -1
        groups.setdefault((pref, affinity), []).append(t)
    parts: List[List] = []
    for key in sorted(groups):
        grp = groups[key]
        for i in range(0, len(grp), max_size):
            parts.append(grp[i:i + max_size])
    return parts


def partition_plan(task_list: Sequence, topology: SliceTopology,
                   budget: float, ordering_slack: float = 1.0,
                   weights: Optional[Dict[str, float]] = None,
                   previous: Optional[Plan] = None,
                   coschedule_exclude=None) -> Optional[Plan]:
    """Tier 1: solve each partition's MILP under its time slice, then stitch.

    The merge keeps each task's partition-chosen apportionment and its
    partition-internal start for ordering, then re-places every task on the
    frontier in global start order, choosing the min-finish block of the
    chosen size — always feasible, conflict-free by construction. A single
    partition returns the exact plan untouched, co-schedule groups included;
    a stitch of several is serial (its re-placement cannot keep a pair's
    shared slot), so their MILPs run without the co-location term."""
    t0 = time.perf_counter()
    parts = _partitions(task_list, previous, partition_max())
    if len(parts) == 1:
        return milp.solve(task_list, topology, time_limit=max(0.05, budget * 0.9),
                          ordering_slack=ordering_slack, weights=weights, warm=previous,
                          coschedule_exclude=coschedule_exclude)

    slice_budget = max(_MIN_PART_SLICE, (budget * 0.8) / len(parts))
    placed: List[Tuple[float, int, Any, int, float]] = []  # (start, pi, task, size, rt)
    for pi, part in enumerate(parts):
        remaining = budget - (time.perf_counter() - t0)
        if remaining > slice_budget * 0.5:
            sub = milp.solve(part, topology, time_limit=min(slice_budget, remaining),
                             ordering_slack=ordering_slack, weights=weights, warm=previous,
                             coschedule_min_gain=1e9)
        else:
            # budget exhausted mid-ladder: the leftovers get the greedy rule
            sub = milp.greedy_plan(part, topology, ordering_slack, weights=weights)
        for t in part:
            a = sub.assignments[t.name]
            placed.append((a.start, pi, t, a.apportionment, a.runtime))

    # Conflict-resolving merge: zipper all partitions by internal start.
    placed.sort(key=lambda p: (p[0], p[1]))
    cap = topology.capacity
    free = [0.0] * cap
    assignments: Dict[str, Assignment] = {}
    for _, _, t, size, rt in placed:
        best = _min_finish(free, [(size, rt)], cap)
        if best is None:
            return None
        fin, st, _, blk, _ = best
        _occupy(free, blk, fin + ordering_slack)
        assignments[t.name] = Assignment(size, blk, st, rt)
    return _finish_plan(assignments)


# ---------------------------------------------------------------------------
# tier 2 — LP relaxation + seeded randomized rounding
# ---------------------------------------------------------------------------

def lp_round_plan(task_list: Sequence, topology: SliceTopology,
                  ordering_slack: float = 1.0,
                  weights: Optional[Dict[str, float]] = None,
                  seed: int = 0, rounds: int = 3,
                  time_limit: float = 5.0) -> Tuple[Optional[Plan], float]:
    """Tier 2: apportionment LP, then rounding.

    Blocks of one size are symmetric, so the LP only chooses *sizes*:
    minimize mk s.t. per-task option mix sums to 1, mk >= each task's mixed
    runtime, mk >= selected work area / capacity. Built directly on scipy
    arrays. Rounding: round 0 is plain greedy (floor quality guaranteed);
    later rounds sample each task's size from its LP mix with a seeded RNG
    and list-schedule min-finish on the frontier. Returns ``(best plan, LP
    lower bound)`` — bound 0.0 when the LP failed to prove optimality (a
    time-limited primal is not a bound)."""
    import numpy as np
    from scipy import sparse
    from scipy.optimize import linprog

    cap = topology.capacity
    names: List[str] = []
    per_task: List[List[Tuple[int, float]]] = []
    for t in task_list:
        opts = _sized_options(t, cap)
        if not opts:
            return None, 0.0
        names.append(t.name)
        per_task.append(opts)

    n = len(per_task)
    offsets = [0] * n
    total = 0
    for i, opts in enumerate(per_task):
        offsets[i] = total
        total += len(opts)
    nvar = 1 + total  # [mk, x...]

    c = np.zeros(nvar)
    c[0] = 1.0
    eq_r, eq_c, eq_v = [], [], []
    ub_r, ub_c, ub_v = [], [], []
    for i, opts in enumerate(per_task):
        for k, (size, rt) in enumerate(opts):
            j = 1 + offsets[i] + k
            eq_r.append(i); eq_c.append(j); eq_v.append(1.0)
            ub_r.append(i); ub_c.append(j); ub_v.append(rt)       # mixed rt
            ub_r.append(n); ub_c.append(j); ub_v.append(size * rt / cap)
        ub_r.append(i); ub_c.append(0); ub_v.append(-1.0)         # ... <= mk
    ub_r.append(n); ub_c.append(0); ub_v.append(-1.0)
    A_eq = sparse.coo_matrix((eq_v, (eq_r, eq_c)), shape=(n, nvar)).tocsr()
    A_ub = sparse.coo_matrix((ub_v, (ub_r, ub_c)), shape=(n + 1, nvar)).tocsr()
    bounds = [(0.0, None)] + [(0.0, 1.0)] * total
    res = linprog(c, A_ub=A_ub, b_ub=np.zeros(n + 1), A_eq=A_eq,
                  b_eq=np.ones(n), bounds=bounds, method="highs",
                  options={"time_limit": max(0.05, time_limit)})
    lp_bound = 0.0
    frac: Optional[List[List[float]]] = None
    if res.status == 0 and res.x is not None:
        lp_bound = float(res.fun)
        frac = [[max(0.0, float(res.x[1 + offsets[i] + k]))
                 for k in range(len(per_task[i]))] for i in range(n)]

    # Rounding rounds; priority-then-LPT order, shared across rounds.
    w = weights or {}
    order = sorted(range(n), key=lambda i: (-w.get(names[i], 0.0),
                                            -min(rt for _, rt in per_task[i])))
    best_plan: Optional[Plan] = None
    for r in range(max(1, rounds)):
        rng = random.Random((seed << 8) ^ r) if r > 0 else None
        free = [0.0] * cap
        assignments: Dict[str, Assignment] = {}
        for i in order:
            opts = per_task[i]
            if rng is not None and frac is not None and len(opts) > 1:
                u, acc, pick = rng.random(), 0.0, len(opts) - 1
                for k, f in enumerate(frac[i]):
                    acc += f
                    if u <= acc:
                        pick = k
                        break
                cand = [opts[pick]]
            else:
                cand = opts  # round 0 (or no LP mix): greedy over all sizes
            best = _min_finish(free, cand, cap)
            if best is None:
                return None, lp_bound
            fin, st, size, blk, rt = best
            _occupy(free, blk, fin + ordering_slack)
            assignments[names[i]] = Assignment(size, blk, st, rt)
        plan = _finish_plan(assignments)
        if best_plan is None or plan.makespan < best_plan.makespan:
            best_plan = plan
    return best_plan, lp_bound


# ---------------------------------------------------------------------------
# the ladder front-end
# ---------------------------------------------------------------------------

def _est_floor(n: int) -> float:
    return 0.005 + 2e-5 * n


def _est_incremental(n: int, n_loose: int) -> float:
    return 0.01 + 1.5e-5 * n + 4e-6 * n_loose * _INSERTION_PROBE_CAP


def _est_lp(n: int) -> float:
    return 0.06 + 2.5e-4 * n


def anytime_solve(task_list: Sequence, topology: SliceTopology,
                  deadline: float, previous: Optional[Plan] = None,
                  ordering_slack: float = 1.0,
                  weights: Optional[Dict[str, float]] = None, seed: int = 0,
                  coschedule_exclude=None,
                  fusion: Optional[List[List[str]]] = None,
                  fusion_exclude=None, fusion_fits=None,
                  ) -> Tuple[Plan, AnytimeReport]:
    """Race down the tier ladder; always returns a plan within ~``deadline``.

    A tier only starts when its (conservative) estimate fits the remaining
    budget after reserving the greedy floor, so the floor can always still
    run. The best-makespan plan among the tiers that ran is adopted, and the
    report records which tier produced it. ``fusion`` groups (with
    ``fusion_exclude`` and ``fusion_fits``, ``milp.fusion_priced_groups``)
    are collapsed before the ladder and expanded in the adopted plan;
    ``weights`` reach every tier (a group weighs as its heaviest member)."""
    t0 = time.perf_counter()
    _validate(task_list, topology)
    winners: list = []
    if fusion:
        task_list, winners = milp.fusion_reduce(list(task_list), fusion, topology,
                                                fusion_exclude=fusion_exclude,
                                                fusion_fits=fusion_fits)
        weights = milp.fusion_weights(weights, winners)
    n = len(task_list)
    deadline = max(float(deadline), 1e-3)
    floor_est = _est_floor(n)

    def remaining() -> float:
        return deadline - (time.perf_counter() - t0)

    best: Optional[Plan] = None
    best_tier = 3
    tried: List[int] = []
    lp_bound = 0.0

    _, loose = split_delta(task_list, topology, previous)
    n_loose = len(loose)

    # tier 0 — incremental (needs a mostly-covering previous plan)
    if (previous is not None and n > 0
            and n_loose <= max(8, n // 4)
            and _est_incremental(n, n_loose) <= remaining() - floor_est):
        tried.append(0)
        p0 = incremental_plan(task_list, topology, previous, ordering_slack, weights,
                              probe_cap=_INSERTION_PROBE_CAP)
        if p0 is not None:
            best, best_tier = p0, 0

    # tier 1 — hierarchical decomposition (budget permitting)
    if n > 0:
        n_parts = max(1, -(-n // partition_max()))
        budget = remaining() - floor_est
        if n_parts <= _MAX_PARTS and budget >= n_parts * _MIN_PART_SLICE:
            tried.append(1)
            p1 = partition_plan(task_list, topology, budget, ordering_slack, weights,
                                previous=previous, coschedule_exclude=coschedule_exclude)
            if p1 is not None and (best is None or p1.makespan < best.makespan):
                best, best_tier = p1, 1
        elif best is None and remaining() - floor_est >= _est_lp(n):
            # tier 2 — LP + rounding (the mid-scale workhorse)
            tried.append(2)
            p2, lp_bound = lp_round_plan(
                task_list, topology, ordering_slack, weights, seed=seed,
                time_limit=max(0.05, (remaining() - floor_est) * 0.5),
            )
            if p2 is not None and (best is None or p2.makespan < best.makespan):
                best, best_tier = p2, 2

    # tier 3 — the never-fail floor
    if best is None:
        tried.append(3)
        best = _greedy_floor(task_list, topology, ordering_slack, weights)
        best_tier = 3

    lb = max(cheap_lower_bound(task_list, topology), lp_bound) if n else 0.0
    if winners:
        best = milp.fusion_expand(best, winners)
    by_name = {getattr(t, "name", None): t for t in task_list}
    n_static = sum(
        1 for name, a in best.assignments.items()
        if getattr(getattr(by_name.get(name), "strategies", {}).get(a.apportionment),
                   "static_prior", False))
    report = AnytimeReport(
        tier=best_tier, wall_s=time.perf_counter() - t0, deadline_s=deadline,
        n_tasks=n, n_loose=n_loose, makespan=best.makespan, lower_bound=lb,
        quality=(best.makespan / lb) if lb > 1e-9 else None,
        tiers_tried=tried, n_static_prior=n_static,
    )
    best.anytime = report
    return best, report


def resolve_deadline(deadline: Optional[float],
                     interval: Optional[float] = None) -> float:
    """The deadline of a solve: the environment override wins, then the
    caller's budget (the orchestrator's, ``interval / 2`` by default), then
    half the interval, then a conservative default."""
    env = os.environ.get(DEADLINE_ENV)
    if env:
        try:
            return max(1e-3, float(env))
        except ValueError:
            log.warning("ignoring unparsable %s=%r", DEADLINE_ENV, env)
    if deadline is not None:
        return max(1e-3, float(deadline))
    if interval is not None and interval > 0:
        return max(1e-3, interval / 2)
    return _DEFAULT_DEADLINE


def _emit_tier_event(report: AnytimeReport, source: str) -> None:
    metrics.event(
        "solver_tier",
        source=source,
        tier=report.tier,
        tier_name=report.tier_name,
        wall_s=round(report.wall_s, 6),
        deadline_s=round(report.deadline_s, 6),
        n_tasks=report.n_tasks,
        n_loose=report.n_loose,
        makespan_s=round(report.makespan, 6),
        quality=(round(report.quality, 4) if report.quality is not None else None),
        tiers_tried=list(report.tiers_tried),
        outcome=report.outcome,
        n_static_prior=report.n_static_prior,
    )


def slide(previous: Plan, names, interval: float) -> Plan:
    """``previous`` restricted to ``names`` with every start slid down by
    ``interval``: the plan compare-and-swap keeps, and the gate's fallback.
    A co-schedule or fusion group keeps the members that remain, while two
    do (a stack of one is no stack)."""
    names = set(names)
    slid = Plan(
        assignments={
            n: Assignment(a.apportionment, a.block, max(0.0, a.start - interval),
                          a.runtime)
            for n, a in previous.assignments.items() if n in names
        },
        makespan=max(0.0, previous.makespan - interval),
        coschedule=[kept for grp in previous.coschedule
                    if len(kept := [n for n in grp if n in names]) >= 2],
        fused=[kept for grp in previous.fused
               if len(kept := [n for n in grp if n in names]) >= 2],
    )
    _set_dependencies(slid)
    return slid


def anytime_resolve(task_list: Sequence, topology: SliceTopology,
                    previous: Optional[Plan], interval: float,
                    threshold: float = 0.0,
                    deadline: Optional[float] = None,
                    weights: Optional[Dict[str, float]] = None,
                    warm: Optional[Plan] = None,
                    ordering_slack: float = 1.0,
                    source: str = "resolve", seed: int = 0,
                    coschedule_exclude=None,
                    fusion: Optional[List[List[str]]] = None,
                    fusion_exclude=None, fusion_fits=None) -> Plan:
    """The deadline-bounded re-solve: a tier-ladder fresh solve and the
    introspective compare-and-swap (adopt the fresh plan if there was no
    previous one, the task set changed, or it beats the previous plan slid
    down by ``interval`` by more than ``threshold``), one ``solver_tier``
    metrics event per call.

    ``previous`` is both the warm seed and the compare-and-swap incumbent;
    pass ``warm`` alone (with ``previous=None``) to seed the ladder without
    the compare-and-swap. ``weights``, ``coschedule_exclude``, ``fusion``,
    ``fusion_exclude`` and ``fusion_fits`` go to :func:`anytime_solve`; a
    slid plan whose group holds an excluded name loses to the fresh one."""
    dl = resolve_deadline(deadline, interval)
    warm_seed = warm if warm is not None else previous
    fresh, report = anytime_solve(task_list, topology, dl, previous=warm_seed,
                                  ordering_slack=ordering_slack, weights=weights, seed=seed,
                                  coschedule_exclude=coschedule_exclude, fusion=fusion,
                                  fusion_exclude=fusion_exclude, fusion_fits=fusion_fits)
    if previous is None:
        _emit_tier_event(report, source)
        return fresh

    prev_names = set(previous.assignments)
    cur_names = {t.name for t in task_list}
    if cur_names - prev_names or len(cur_names) < len(prev_names):
        _emit_tier_event(report, source)
        return fresh
    slid = slide(previous, cur_names, interval)
    excluded = (set(coschedule_exclude or ()) & {n for g in slid.coschedule for n in g}
                or set(fusion_exclude or ()) & {n for g in slid.fused for n in g})
    if excluded or fresh.makespan < slid.makespan - threshold:
        _emit_tier_event(report, source)
        return fresh
    report.outcome = "slid"
    _emit_tier_event(report, source)
    slid.anytime = report
    return slid
