"""Elastic scale-up: the recovery half of the elastic path (grow and defrag).

Counterpart of ``saturn_tpu/resilience/grow.py``. On every ``grow``
:class:`~saturn_tpu_torch.resilience.health.TopologyChange` (and on a
periodic poll) the :class:`GrowCoordinator` of the online service

1. journals a durable ``grow_event`` record,
2. ends every health guardian backoff (``unbench_all``; the fault streaks
   stay) so that parked work runs this interval,
3. journals a ``backlog_drain`` record when deferred jobs admit, and
4. when a deferred gang still cannot fit because other tasks' live state
   pins the devices' memory, plans a **defragmentation wave**
   (:func:`~saturn_tpu_torch.resilience.replan.plan_defrag_wave`) and runs
   it move by move.

Every move is journaled in two phases: a durable ``migration_intent``
before any state changes, a ``migration_done`` after the victim's
checkpoint is known durable and its live state released. A kill in a wave
resolves exactly once on replay: an intent and a later ``ckpt_published``
resume, an intent alone rolls back. The crash harness's kill points
``defrag.pre-publish``, ``defrag.pre-commit`` and ``defrag.post-commit``
lie between the phases.

The JAX package prices a gang's need and reads the card's capacity with
memlens; the port reads the capacity from ``SATURN_TPU_HBM_BYTES`` or the
card and the need from the static estimate of
``replan.static_need`` (``ROADMAP.md``, queue 3). A task pins nothing
unless it declares ``resident_bytes`` (an attribute or a hint), as in the
JAX package, so on the port's real tasks the occupancy gate stays open.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from saturn_tpu_torch.resilience.replan import (DefragWave, capacity_bytes, plan_defrag_wave,
                                                static_need)
from saturn_tpu_torch.utils import metrics

log = logging.getLogger("saturn_tpu_torch")

#: Run the opportunistic defrag poll every N intervals without a grow (0: never).
ENV_GROW_POLL = "SATURN_TPU_GROW_POLL"
DEFAULT_GROW_POLL = 8


def default_resident_bytes(task: Any) -> int:
    """Per-device bytes a task's live state pins between intervals: its
    ``resident_bytes`` attribute or hint, 0 when unknown (the occupancy
    gate then stays open) or when it holds no live state."""
    if getattr(task, "_live_state", "absent") is None:
        return 0
    v = getattr(task, "resident_bytes", None)
    if v is None:
        hints = getattr(task, "hints", None)
        if isinstance(hints, dict):
            v = hints.get("resident_bytes")
    try:
        return max(0, int(v or 0))
    except (TypeError, ValueError):
        return 0


class GrowCoordinator:
    """Drives grow-event recovery for one control loop. Single-threaded:
    only the owning loop calls it."""

    def __init__(self, journal: Any = None, poll_every: Optional[int] = None,
                 resident_bytes: Callable[[Any], int] = default_resident_bytes,
                 cap_bytes: Optional[int] = None):
        self.journal = journal
        if poll_every is None:
            poll_every = int(os.environ.get(ENV_GROW_POLL, DEFAULT_GROW_POLL))
        self.poll_every = max(0, poll_every)
        self.resident_bytes = resident_bytes
        self._cap_bytes = cap_bytes
        self._wave_seq = 0

    def seed_wave_seq(self, past: int) -> None:
        """Move the wave sequence past a recovered journal's highest
        (``ServiceRecovery.defrag_waves``): the interval half of a wave id
        restarts from zero with each incarnation."""
        self._wave_seq = max(self._wave_seq, int(past))

    def _capacity_bytes(self, topology) -> int:
        if self._cap_bytes is not None:
            return self._cap_bytes
        return capacity_bytes(topology)

    # ----------------------------------------------------------- grow event
    def note_grow(self, change, interval_index: int, *, guardian=None, n_deferred: int = 0,
                  n_parked: int = 0, capacity: int = 0) -> List[str]:
        """Record a grow and end every guardian backoff. Returns the names
        released from backoff."""
        released: List[str] = []
        if guardian is not None and hasattr(guardian, "unbench_all"):
            released = list(guardian.unbench_all(cause="grow"))
        n_parked = max(n_parked, len(released))
        gained = list(getattr(change, "gained", ()) or ())
        if self.journal is not None:
            self.journal.log("grow_event", interval=interval_index, gained=gained,
                             cause=getattr(change, "cause", ""), capacity=capacity,
                             n_deferred=n_deferred, n_parked=n_parked, unbenched=released)
        metrics.event("grow_event", interval=interval_index, gained=gained,
                      n_deferred=n_deferred, n_parked=n_parked, unbenched=released)
        return released

    def note_drained(self, jobs: Sequence[str], interval_index: int,
                     trigger: str = "grow") -> None:
        """Journal (durably: the jobs are admitted already) that deferred
        jobs admitted this interval."""
        if not jobs:
            return
        if self.journal is not None:
            self.journal.log("backlog_drain", interval=interval_index, jobs=sorted(jobs),
                             trigger=trigger)
        metrics.event("backlog_drain", interval=interval_index, jobs=sorted(jobs),
                      trigger=trigger)

    def defrag_due(self, interval_index: int, grew: bool) -> bool:
        """A defrag wave is tried on every grow, and every ``poll_every``
        intervals (a completion may have freed memory)."""
        if grew:
            return True
        return self.poll_every > 0 and interval_index > 0 and (
            interval_index % self.poll_every == 0)

    # ------------------------------------------------------- occupancy gate
    def occupancy_gate(self, live_tasks: Callable[[], Sequence],
                       current_plan: Callable[[], Any]) -> Callable:
        """The admission controller's occupancy gate: whether an arrival's
        per-device need fits around the pinned live state of running tasks
        on some block. ``None`` (no verdict) wherever information is
        missing."""

        def gate(task, topology) -> Optional[dict]:
            cap = self._capacity_bytes(topology)
            if cap <= 0:
                return None
            plan = current_plan()
            if plan is None:
                return None
            occ: Dict[int, int] = {}
            for t in live_tasks():
                if t.name == getattr(task, "name", None):
                    continue
                b = self.resident_bytes(t)
                a = plan.assignments.get(t.name)
                if b <= 0 or a is None:
                    continue
                for i in range(a.block.offset, a.block.end):
                    occ[i] = occ.get(i, 0) + b
            if not occ:
                return None  # nothing pinned
            # the need is priced per size: a smaller gang needs more per device
            best = None  # (free, need) of the nearest miss
            for g in sorted((g for g in task.feasible_strategies() if g <= topology.capacity),
                            reverse=True):
                need = self._need_bytes(task, topology, cap, size=g)
                if need <= 0:
                    return None  # no estimate at this size
                for blk in topology.blocks(g):
                    free = cap - max(occ.get(i, 0) for i in range(blk.offset, blk.end))
                    if free >= need:
                        return {"fits": True, "free_bytes": free, "need_bytes": need}
                    if best is None or need - free < best[1] - best[0]:
                        best = (free, need)
            if best is None:
                return None
            return {"fits": False, "free_bytes": best[0], "need_bytes": best[1]}

        return gate

    def _need_bytes(self, task, topology, cap: int, size: int) -> int:
        """Per-device bytes the task needs at gang size ``size``: the static
        estimate, else the task's own resident bytes."""
        fit = static_need(task, topology, size, cap)
        return int(fit["peak_bytes"]) if fit is not None else self.resident_bytes(task)

    # ---------------------------------------------------------- defrag wave
    def plan_wave(self, blocked_tasks: Sequence, live_tasks: Sequence, topology,
                  previous_plan) -> DefragWave:
        return plan_defrag_wave(blocked_tasks, live_tasks, topology, previous_plan,
                                self.resident_bytes, cap_bytes=self._capacity_bytes(topology))

    def execute_wave(self, wave: DefragWave, tasks_by_name: Dict[str, Any], interval_index: int,
                     publish_fn: Optional[Callable[[Any], bool]] = None) -> Optional[str]:
        """Run a planned wave move by move, journaled in two phases.

        Per move: a durable ``migration_intent``, the ``defrag.pre-publish``
        barrier, ``publish_fn(task)`` (the victim's checkpoint is durable,
        journaling ``ckpt_published``; False rolls the move back untouched),
        the victim's live state released, ``defrag.pre-commit``, a
        committed ``migration_done``, ``defrag.post-commit``. Returns the
        wave id (None for an empty wave)."""
        if wave.empty:
            return None
        self._wave_seq += 1
        wave_id = f"wave-{interval_index}-{self._wave_seq}"
        jnl = self.journal
        moved: List[str] = []
        rolled_back: List[str] = []
        for move in wave.moves:
            task = tasks_by_name.get(move.task)
            if task is None:
                continue
            if jnl is not None:
                jnl.log("migration_intent", wave=wave_id, interval=interval_index,
                        **move.to_fields())
                jnl.barrier("defrag.pre-publish", wave=wave_id, task=move.task)
            ok = True
            if publish_fn is not None:
                try:
                    ok = bool(publish_fn(task))
                except Exception as e:
                    log.warning("defrag: publish failed for %s: %r", move.task, e)
                    ok = False
            if not ok:
                rolled_back.append(move.task)
                if jnl is not None:
                    jnl.log("migration_rollback", wave=wave_id, task=move.task,
                            cause="publish-failed")
                continue
            release = getattr(task, "release_live_state", None)
            if callable(release):
                release()
            if jnl is not None:
                jnl.barrier("defrag.pre-commit", wave=wave_id, task=move.task)
                jnl.append("migration_done", wave=wave_id, task=move.task,
                           interval=interval_index)
                jnl.commit()
                jnl.barrier("defrag.post-commit", wave=wave_id, task=move.task)
            moved.append(move.task)
        if jnl is not None:
            jnl.log("defrag_wave", wave=wave_id, interval=interval_index, moves=moved,
                    rolled_back=rolled_back,
                    admitted={k: list(v) for k, v in sorted(wave.admitted.items())},
                    still_blocked=sorted(wave.still_blocked))
        metrics.event("defrag_wave", wave=wave_id, interval=interval_index, moves=moved,
                      rolled_back=rolled_back, admitted=sorted(wave.admitted),
                      still_blocked=sorted(wave.still_blocked))
        log.info("defrag: wave %s moved %d task(s), unblocked %d gang(s)%s", wave_id,
                 len(moved), len(wave.admitted),
                 f", {len(wave.still_blocked)} still blocked" if wave.still_blocked else "")
        return wave_id
