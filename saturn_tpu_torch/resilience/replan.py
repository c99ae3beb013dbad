"""Elastic replanning: shrink or grow the plan when the fleet changes shape.

Counterpart of ``saturn_tpu/resilience/replan.py``. On a
:class:`~saturn_tpu_torch.resilience.health.TopologyChange` the orchestrator
hands the surviving device set here. The replanner

1. builds the topology over the survivors (``SliceTopology.subset``),
2. makes every task schedulable on the new capacity: profiled strategies
   are kept; a size never profiled is synthesized from the Amdahl fit the
   trial runner's grid pruning uses (``trial_runner.evaluator
   ._fit_scaling_model``), flagged ``interpolated`` until it runs,
3. applies a recovery policy that decides who keeps running, and
4. solves again over the survivors through the anytime ladder.

Built-in policies:

``pause-resolve-resume``
    A full re-solve on the new topology; everything that fits resumes. The
    default: the best plans, for one solver run.
``degrade-in-place``
    No solver run: every task keeps its strategy size (clamped to the new
    capacity), list-scheduled in its previous start order. The cheapest
    recovery; a worse makespan.
``evict-lowest-priority``
    Like pause-resolve-resume, after evicting the lowest-priority tasks
    (``task.hints["priority"]``, default 0) until the projected makespan is
    within ``degrade_factor`` x the plan before the fault. A task that
    cannot run at all is evicted under every policy.

A custom policy registers through :func:`register_policy`: a callable
``(tasks, ctx) -> (keep, evict)``.

The JAX package vets each destination with memlens, its static liveness
analysis. The port vets it with the technique's static screen
(``SPMDTechnique._static_screen``: the fp32 parameters, gradients and
optimizer moments against the card's memory); where the screen cannot tell
(no card size, a technique without a screen) the destination passes, as
memlens lets it pass where it knows nothing.

:func:`plan_defrag_wave` plans the online service's defragmentation waves
(``resilience/grow.py`` executes them): running jobs whose live state pins
device memory move to other blocks so that a deferred gang fits. The
per-device need of a gang or a moved victim is memlens' compiled peak in
the JAX package; here it is :func:`static_need_bytes`, the trial's
measured peak (or the technique's fp32 state where no peak was measured),
and the task's pinned bytes where neither is known.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.solver import anytime, milp
from saturn_tpu_torch.utils import metrics

log = logging.getLogger("saturn_tpu_torch")

RECOVERY_POLICIES = (
    "pause-resolve-resume",
    "degrade-in-place",
    "evict-lowest-priority",
)


@dataclass
class ReplanContext:
    """What a recovery policy sees."""

    topology: SliceTopology            # the surviving devices
    previous_plan: Optional[milp.Plan]
    previous_makespan: float
    change_kind: str
    degrade_factor: float


@dataclass
class ReplanResult:
    topology: SliceTopology
    plan: milp.Plan
    evicted: List[str] = field(default_factory=list)
    synthesized: Dict[str, List[int]] = field(default_factory=dict)  # task -> sizes
    migrations: Dict[str, dict] = field(default_factory=dict)        # task -> diff


_POLICIES: Dict[str, Callable] = {}


def register_policy(name: str, fn: Callable) -> None:
    """Register a recovery policy ``(tasks, ctx) -> (keep, evict)``."""
    _POLICIES[name] = fn


def get_policy(name: str) -> Callable:
    """The recovery policy ``(tasks, ctx) -> (keep, evict)`` of that name;
    raises ``ValueError`` for an unknown one."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown recovery policy {name!r}; built-ins: {RECOVERY_POLICIES}, "
            f"registered: {sorted(_POLICIES)}"
        ) from None


def _priority(task) -> float:
    return float(getattr(task, "hints", {}).get("priority", 0.0))


def _runnable(task, capacity: int) -> bool:
    return any(g <= capacity for g in task.feasible_strategies())


def _policy_resolve(tasks, ctx: ReplanContext):
    return list(tasks), []


def _policy_evict_lowest(tasks, ctx: ReplanContext):
    """Drop low-priority work until the survivors' projected makespan is
    within degrade_factor of the plan before the fault (a greedy
    projection: cheap and pessimistic, so it errs toward keeping tasks)."""
    keep = sorted(tasks, key=_priority, reverse=True)
    evicted: List = []
    limit = ctx.degrade_factor * max(ctx.previous_makespan, 1e-9)
    while len(keep) > 1:
        proj = milp.greedy_plan(keep, ctx.topology).makespan
        if proj <= limit or ctx.previous_makespan <= 0.0:
            break
        evicted.append(keep.pop())  # the lowest priority is last after the sort
    return keep, evicted


_POLICIES["pause-resolve-resume"] = _policy_resolve
_POLICIES["degrade-in-place"] = _policy_resolve  # the same selection; no solver run
_POLICIES["evict-lowest-priority"] = _policy_evict_lowest


def _screen(task, topo: SliceTopology, size: int) -> Optional[bool]:
    """The static screen's verdict on the task's size-``size`` strategy on
    the first block of that size; None where it cannot tell."""
    strat = task.feasible_strategies().get(size)
    tech = getattr(strat, "executor", None)
    screen = getattr(tech, "_static_screen", None)
    if screen is None:
        return None
    devices = topo.block_devices(topo.blocks(size)[0])
    return bool(screen(task, devices, dict(strat.params or {})))


def _fits_mesh(task, topo: SliceTopology) -> bool:
    """Whether some strategy of the task that fits the capacity passes the
    static screen (a strategy it cannot judge passes)."""
    return any(_screen(task, topo, g) is not False
               for g in task.feasible_strategies() if g <= topo.capacity)


class ElasticReplanner:
    """Turns TopologyChange events into (new topology, new plan)."""

    def __init__(self, policy: str = "pause-resolve-resume", degrade_factor: float = 2.0):
        get_policy(policy)
        self.policy = policy
        self.degrade_factor = degrade_factor

    # ----------------------------------------------------------- strategies
    def _synthesize(self, task, capacity: int) -> List[int]:
        """Give ``task`` a schedulable strategy at a size <= capacity it was
        never profiled at, from the Amdahl fit over its measured points.
        Memory below the smallest measured size was never checked; a
        preemption forces the call anyway: the strategy is flagged
        ``interpolated``, and a failure lands in the ordinary retry path."""
        from saturn_tpu_torch.trial_runner.evaluator import _fit_scaling_model

        feas = task.feasible_strategies()
        pts = [(g, s.per_batch_time) for g, s in feas.items() if s.per_batch_time > 0]
        if not pts:
            return []
        if len(pts) >= 2:
            model = _fit_scaling_model(pts)
        else:
            g0, t0 = pts[0]
            model = lambda g: t0 * g0 / float(g)  # pure-parallel: pessimistic on a shrink
        if capacity in feas:
            return []  # a profiled size fits: nothing to synthesize
        anchor = feas[min(pts, key=lambda p: p[0])[0]]
        # a fit over priors alone is a prior too
        all_static = all(getattr(feas[g], "static_prior", False) for g, _ in pts)
        # one synthesized size: the capacity, the largest that fits
        pbt = max(float(model(capacity)), 1e-9)
        task.strategies[capacity] = Strategy(
            executor=anchor.executor, apportionment=capacity,
            params=dict(anchor.params or {}),
            runtime=pbt * max(task.total_batches, 0), per_batch_time=pbt,
            interpolated=True, static_prior=all_static,
            bubble_fraction=anchor.bubble_fraction,
        )
        return [capacity]

    # --------------------------------------------------------------- replan
    def replan(
        self,
        task_list: Sequence,
        base_topology: SliceTopology,
        alive_indices: Sequence[int],
        change,
        previous_plan: Optional[milp.Plan] = None,
        time_limit: Optional[float] = None,
    ) -> ReplanResult:
        """The topology and plan of the surviving fleet.

        ``alive_indices`` index ``base_topology.devices`` (the monitor's
        view). A task that cannot run even after synthesis is evicted under
        every policy, and so is one whose every fitting strategy the static
        screen refuses. Emits a ``replan`` metrics event; the caller emits
        ``topology_change``."""
        topo = base_topology.subset(alive_indices)
        cap = topo.capacity
        synthesized: Dict[str, List[int]] = {}
        keep: List = []
        evicted: List[str] = []
        for t in task_list:
            if not _runnable(t, cap):
                added = self._synthesize(t, cap)
                if added:
                    synthesized[t.name] = added
            if not _runnable(t, cap):
                evicted.append(t.name)
                log.warning("replan: task %s cannot run on a %d-device mesh — evicting",
                            t.name, cap)
            elif not _fits_mesh(t, topo):
                evicted.append(t.name)
                log.warning("replan: the static screen refuses task %s at every fitting "
                            "size on the %d-device mesh — evicting", t.name, cap)
            else:
                keep.append(t)

        ctx = ReplanContext(
            topology=topo, previous_plan=previous_plan,
            previous_makespan=previous_plan.makespan if previous_plan else 0.0,
            change_kind=getattr(change, "kind", "shrink"), degrade_factor=self.degrade_factor,
        )
        keep, policy_evicted = _POLICIES[self.policy](keep, ctx)
        evicted.extend(t.name for t in policy_evicted)

        if not keep:
            plan = milp.Plan(assignments={}, makespan=0.0)
        elif self.policy == "degrade-in-place":
            plan = self._degrade_in_place(keep, topo, previous_plan)
        else:
            # the old plan may name dead devices: it seeds the ladder
            # (``warm``) but is never kept by the compare-and-swap
            dl = anytime.resolve_deadline(time_limit)
            plan = anytime.anytime_resolve(keep, topo, None, dl * 2.0, deadline=dl,
                                           warm=previous_plan, source="replan")

        migrations = plan.migrations_from(previous_plan) if previous_plan is not None else {}
        # the destination of each planned move through the static screen; a
        # refusal here means the chosen size itself drifted (the eviction
        # above catches the tasks refused at every size)
        blocked: List[str] = []
        by_name = {t.name: t for t in task_list}
        for name, d in migrations.items():
            t, a = by_name.get(name), plan.assignments.get(name)
            if not d.get("moved") or t is None or a is None:
                continue
            fits = _screen(t, topo, a.apportionment)
            if fits is None:
                continue
            d["static_screen"] = {"fits": fits}
            if not fits:
                blocked.append(name)
                log.warning("replan: the static screen refuses %s on %d device(s)",
                            name, a.apportionment)
        metrics.event(
            "replan", policy=self.policy, capacity=cap, n_tasks=len(keep),
            evicted=sorted(evicted), synthesized=dict(synthesized),
            makespan_s=plan.makespan,
            migrated=sorted(n for n, d in migrations.items() if d["moved"]),
            # the JAX package's key, so one reader reads both; here it holds
            # the static screen's refusals
            memlens_blocked=sorted(blocked),
        )
        return ReplanResult(topology=topo, plan=plan, evicted=evicted,
                            synthesized=synthesized, migrations=migrations)

    @staticmethod
    def _degrade_in_place(task_list, topo: SliceTopology,
                          previous: Optional[milp.Plan]) -> milp.Plan:
        """No solver: clamp each task's previous size to the new capacity
        (the largest feasible size <= min(previous, capacity)) and
        list-schedule in the previous start order on a ``DeviceTimeline``.
        A task without a previous assignment takes the largest size that
        fits."""
        timeline = milp.DeviceTimeline(topo.capacity)

        def prev_start(t):
            a = previous.assignments.get(t.name) if previous else None
            return a.start if a is not None else float("inf")

        assignments: Dict[str, milp.Assignment] = {}
        for t in sorted(task_list, key=prev_start):
            prev_a = previous.assignments.get(t.name) if previous else None
            want = min(prev_a.apportionment, topo.capacity) if prev_a else topo.capacity
            sizes = ([g for g in t.feasible_strategies() if g <= want]
                     or [g for g in t.feasible_strategies() if g <= topo.capacity])
            size = max(sizes)
            strat = t.feasible_strategies()[size]
            best = None  # (start, block)
            for blk in topo.blocks(size):
                st = timeline.earliest_free(blk, strat.runtime + 1.0)
                if best is None or st < best[0]:
                    best = (st, blk)
            st, blk = best
            timeline.occupy(blk, st, st + strat.runtime + 1.0)
            assignments[t.name] = milp.Assignment(size, blk, st, strat.runtime)
        makespan = max((a.start + a.runtime for a in assignments.values()), default=0.0)
        plan = milp.Plan(assignments=assignments, makespan=makespan)
        plan.compute_dependencies()
        return plan


# ----------------------------------------------------------------- defrag
#: The JAX package's override of the per-device memory a capacity check
#: assumes (memlens' ``ENV_CAPACITY``): a CPU host can model a card.
ENV_CAPACITY = "SATURN_TPU_HBM_BYTES"
#: The share of the card a destination may fill (the static screen's).
_DEFRAG_HEADROOM = 0.92


def capacity_bytes(topology: SliceTopology) -> int:
    """Per-device memory: ``SATURN_TPU_HBM_BYTES`` first, then the first
    device's (``utils.timing.device_memory_bytes``); 0 when neither knows,
    and every capacity check then stands down."""
    env = os.environ.get(ENV_CAPACITY)
    if env:
        try:
            return max(int(float(env)), 0)
        except ValueError:
            log.warning("bad %s=%r ignored", ENV_CAPACITY, env)
    from saturn_tpu_torch.utils import timing

    try:
        return max(int(timing.device_memory_bytes(topology.devices[0])), 0)
    except (AttributeError, IndexError, RuntimeError, TypeError):
        return 0


def static_need(task, topology: SliceTopology, size: int,
                cap_bytes: int) -> Optional[dict]:
    """The static estimate of the per-device memory the task needs at a
    size-``size`` block (the port's stand-in for memlens'
    ``migration_fits``): the measured peak of the trial behind the
    strategy, else its technique's fp32 params, grads and moments per
    device at that size (``state_bytes``: fsdp's shard plus its gathered
    parameters and gradients). None (no verdict) without a capacity, a strategy at
    that size, or a technique that can count its state."""
    if cap_bytes <= 0:
        return None
    strat = task.feasible_strategies().get(size)
    tech = getattr(strat, "executor", None)
    if strat is None or not hasattr(tech, "state_bytes"):
        return None
    peak = getattr(strat, "peak_bytes", None)
    config = dict(strat.params or {})
    if peak is not None:
        need = float(peak)
    elif getattr(tech, "shards_state", False):
        need = float(tech.state_bytes(task, config, size))
    else:
        need = float(tech.state_bytes(task, config))
    return {"fits": need <= _DEFRAG_HEADROOM * cap_bytes, "peak_bytes": int(need),
            "capacity_bytes": int(cap_bytes)}


@dataclass(frozen=True)
class DefragMove:
    """One planned victim relocation: release the task's device-resident
    live state (its checkpoint is current at every interval boundary) and
    restore it on ``to_block`` instead of ``from_block`` next time."""

    task: str
    from_block: Tuple[int, int]  # (offset, size)
    to_block: Tuple[int, int]
    pinned_bytes: int            # per-device memory the move frees on the source
    memlens: Optional[dict] = None  # the destination's static estimate (JAX's key)

    def to_fields(self) -> dict:
        d = {"task": self.task, "from": list(self.from_block), "to": list(self.to_block),
             "pinned_bytes": self.pinned_bytes}
        if self.memlens is not None:
            d["memlens"] = self.memlens
        return d


@dataclass
class DefragWave:
    """A planned compaction wave: the moves, and the gangs that fit after."""

    moves: List[DefragMove] = field(default_factory=list)
    admitted: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    still_blocked: List[str] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.moves and not self.admitted


def plan_defrag_wave(blocked_tasks: Sequence, live_tasks: Sequence, topology: SliceTopology,
                     previous_plan: Optional[milp.Plan], resident_bytes: Callable,
                     cap_bytes: Optional[int] = None) -> DefragWave:
    """Plan a defragmentation wave: move running jobs to other blocks so
    that a deferred gang's per-device need fits somewhere.

    Between intervals a task's train state stays on its devices
    (``task._live_state``); that pinned memory is what blocks a large
    deferred gang when the schedule has room. Per destination block the
    pinned live tasks overlapping it are the victims; each needs a
    relocation block with headroom (its own size first, then halved
    feasible sizes), and the gang is admitted when every victim relocates
    and the gang's need fits the freed block. ``resident_bytes(task)`` is
    the per-device bytes a task's live state pins (0 or unknown: not
    counted). Deterministic: every candidate order is sorted. The caller
    executes the moves (journaled in two phases) and drains again."""
    if cap_bytes is None:
        cap_bytes = capacity_bytes(topology)
    wave = DefragWave()
    if cap_bytes <= 0:
        # no capacity model: occupancy never blocked anyone
        wave.still_blocked = sorted(t.name for t in blocked_tasks)
        return wave

    def _pinned(t) -> int:
        try:
            return max(0, int(resident_bytes(t) or 0))
        except (TypeError, ValueError):
            return 0

    # current placements of pinned live tasks: name -> (Block, task, bytes)
    placements: Dict[str, Tuple[Block, object, int]] = {}
    for t in live_tasks:
        a = previous_plan.assignments.get(t.name) if previous_plan else None
        b = _pinned(t)
        if a is not None and b > 0:
            placements[t.name] = (a.block, t, b)

    occ: Dict[int, int] = {}  # device index -> pinned bytes
    for blk, _t, b in placements.values():
        for i in range(blk.offset, blk.end):
            occ[i] = occ.get(i, 0) + b

    def _headroom(blk: Block, extra_occupied: Dict[int, int]) -> int:
        used = max(occ.get(i, 0) + extra_occupied.get(i, 0) for i in range(blk.offset, blk.end))
        return cap_bytes - used

    moved: Dict[str, Tuple[Block, Block, int, Optional[dict]]] = {}
    reserved: Dict[int, int] = {}  # this wave's placements (gangs and victims)

    def _per_device_need(task, size: int) -> int:
        fit = static_need(task, topology, size, cap_bytes)
        return int(fit["peak_bytes"]) if fit is not None else _pinned(task)

    def _relocate(victim_name: str, forbidden: List[Block],
                  extra: Dict[int, int]) -> Optional[Tuple[Block, int]]:
        """A block the victim's live state can pin again after its restore."""
        blk, vt, vb = placements[victim_name]
        sizes: List[int] = []
        g = blk.size
        feas = set(vt.feasible_strategies())
        while g >= 1:
            if g in feas:
                sizes.append(g)
            g >>= 1
        for size in sizes:
            for cand in topology.blocks(size):
                if cand.overlaps(blk) or any(cand.overlaps(f) for f in forbidden):
                    continue
                if _headroom(cand, extra) >= vb:
                    return cand, size
        return None

    for bt in sorted(blocked_tasks, key=lambda t: t.name):
        feas = sorted((g for g in bt.feasible_strategies() if g <= topology.capacity),
                      reverse=True)
        placed = False
        for size in feas:
            need = _per_device_need(bt, size)
            for dest in topology.blocks(size):
                victims = sorted(n for n, (blk, _t, _b) in placements.items()
                                 if n not in moved and blk.overlaps(dest))
                # the destination's occupancy once every victim vacates
                merged = dict(reserved)
                for n in victims:
                    blk, _t, b = placements[n]
                    for i in range(blk.offset, blk.end):
                        merged[i] = merged.get(i, 0) - b
                if _headroom(dest, merged) < need:
                    continue
                # every victim needs a home outside the destination
                relocs: List[Tuple[str, Block, Block, int]] = []
                trial_extra = dict(merged)
                ok = True
                for n in victims:
                    r = _relocate(n, [dest], trial_extra)
                    if r is None:
                        ok = False
                        break
                    cand, _sz = r
                    blk, _t, vb = placements[n]
                    for i in range(cand.offset, cand.end):
                        trial_extra[i] = trial_extra.get(i, 0) + vb
                    relocs.append((n, blk, cand, vb))
                if not ok:
                    continue
                for n, blk, cand, vb in relocs:
                    vt = placements[n][1]
                    moved[n] = (blk, cand, vb, static_need(vt, topology, cand.size, cap_bytes))
                    for i in range(blk.offset, blk.end):
                        occ[i] = occ.get(i, 0) - vb
                    for i in range(cand.offset, cand.end):
                        reserved[i] = reserved.get(i, 0) + vb
                for i in range(dest.offset, dest.end):
                    reserved[i] = reserved.get(i, 0) + need
                wave.admitted[bt.name] = (dest.offset, dest.size)
                placed = True
                break
            if placed:
                break
        if not placed:
            wave.still_blocked.append(bt.name)

    wave.moves = [
        DefragMove(task=n, from_block=(f.offset, f.size), to_block=(t.offset, t.size),
                   pinned_bytes=b, memlens=fit)
        for n, (f, t, b, fit) in sorted(moved.items())
    ]
    return wave
