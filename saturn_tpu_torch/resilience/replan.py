"""Elastic replanning: shrink or grow the plan when the fleet changes shape.

Counterpart of ``saturn_tpu/resilience/replan.py`` (its batch half; the
defragmentation waves go with the service). On a
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
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from saturn_tpu_torch.core.mesh import SliceTopology
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
        # one synthesized size: the capacity, the largest that fits
        pbt = max(float(model(capacity)), 1e-9)
        task.strategies[capacity] = Strategy(
            executor=anchor.executor, apportionment=capacity,
            params=dict(anchor.params or {}),
            runtime=pbt * max(task.total_batches, 0), per_batch_time=pbt,
            interpolated=True, bubble_fraction=anchor.bubble_fraction,
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
