"""Recovery policy for training-health faults, the hung-dispatch error type
and the watchdog's deadline rule.

Counterpart of ``saturn_tpu/health/guardian.py``. The sentinel and the
engine's watchdog detect; the orchestrator rolls the task back to its last
checkpoint; this class decides what happens next — retry with exponential
backoff, quarantine the offending batches, or evict. Its budgets are a
ledger of their own, apart from ``max_task_retries`` (ordinary failures):
a job that NaNs twice and then trains clean neither burns its failure
budget nor hides its faults.

Policy, per (task, cause) with CONSECUTIVE counting (a clean interval
resets the streak via :meth:`TrainingGuardian.note_success`):

1. every fault: the task was rolled back; park it for
   ``backoff_base * 2^(k-1)`` intervals (capped);
2. a repeated data-cause fault (the ``quarantine_after``-th in a row) also
   quarantines the faulting interval's dataset indices — the cursor rolled
   back, so a deterministic bad batch faults again at the same indices and
   the skip-list is exactly the fix;
3. a task in a co-schedule or fusion group, at ``detach_after``
   consecutive faults of any cause, is detached: it leaves its co-schedule
   group, or gets the ``_fused_detach`` flag (a running stack unfuses it at
   its next unit boundary, ``parallel/fused.py``), and every later solve
   keeps it out of both (``detached_names``);
4. past ``retry_budget`` (``hung_budget`` for hung dispatches) the task is
   evicted through the caller's failure path.

Every transition is a ``health`` metrics event with the JAX package's
stable ``SAT-H*`` codes and, given a durability journal, a journal record
with the JAX package's fields: ``health_fault`` and ``health_backoff`` ride
the next group commit, ``health_quarantine`` commits at once (a kill
during the rollback that follows must replay it, or the restart faults on
the same batch again). :meth:`TrainingGuardian.restore` re-applies the
replayed skip-lists to the rebuilt tasks. Only training faults are the
guardian's (:meth:`TrainingGuardian.owns`): a kernel that does not build or
launch is an ordinary failure and reaches the caller.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Tuple

from saturn_tpu_torch.health.sentinel import NumericFaultError
from saturn_tpu_torch.utils import metrics

logger = logging.getLogger("saturn_tpu_torch")

#: Stable operator-facing event codes (``metrics`` events + runbook).
HEALTH_EVENT_CODES = {
    "numeric_fault": "SAT-H001",
    "hung_dispatch": "SAT-H002",
    "backoff": "SAT-H003",
    "quarantine": "SAT-H010",
    "detach": "SAT-H020",
    "evict": "SAT-H030",
}


class HungDispatchError(RuntimeError):
    """A task's interval dispatch exceeded its watchdog deadline.

    Raised *on the task's behalf* by the engine's join-side watchdog (the
    launcher thread itself is wedged: a CUDA launch cannot be cancelled);
    the attempt is abandoned, the last checkpoint stays ground truth, and
    the guardian escalates timeout -> rollback -> evict.
    """

    def __init__(self, job: str, deadline_s: float, elapsed_s: float):
        self.job = job
        self.deadline_s = float(deadline_s)
        self.elapsed_s = float(elapsed_s)
        super().__init__(
            f"hung dispatch: job {job} exceeded its watchdog deadline "
            f"({elapsed_s:.1f}s elapsed > {deadline_s:.1f}s allowed)"
        )


CAUSE_HUNG = "hung_dispatch"


@dataclass(frozen=True)
class GuardianConfig:
    """Recovery-policy knobs.

    ``watchdog_floor_s`` is generous by default because the FIRST interval
    of a task pays its bundle's build and graph captures — the deadline is
    ``floor + factor x profiled window time``, so the profiled term only
    dominates once windows are long enough for compile noise not to matter.
    """

    retry_budget: int = 3        # consecutive numeric faults before evict
    hung_budget: int = 2         # consecutive hung dispatches before evict
    quarantine_after: int = 2    # consecutive data faults before quarantine
    detach_after: int = 2        # consecutive faults before group detach
    backoff_base: int = 1        # cooldown intervals after the 1st fault
    backoff_cap: int = 8         # cooldown ceiling (intervals)
    watchdog: bool = True
    watchdog_factor: float = 8.0   # k in  k x profiled window time
    watchdog_floor_s: float = 60.0

    @classmethod
    def from_env(cls) -> "GuardianConfig":
        def _f(name: str, default: float) -> float:
            return float(os.environ.get(name, "") or default)

        return cls(
            retry_budget=int(_f("SATURN_TPU_HEALTH_RETRIES", cls.retry_budget)),
            hung_budget=int(_f("SATURN_TPU_HUNG_RETRIES", cls.hung_budget)),
            backoff_cap=int(_f("SATURN_TPU_HEALTH_BACKOFF_CAP", cls.backoff_cap)),
            watchdog=os.environ.get("SATURN_TPU_WATCHDOG", "1").strip().lower()
            not in ("0", "off", "false", "no"),
            watchdog_factor=_f("SATURN_TPU_WATCHDOG_FACTOR", cls.watchdog_factor),
            watchdog_floor_s=_f("SATURN_TPU_WATCHDOG_FLOOR_S", cls.watchdog_floor_s),
        )


@dataclass(frozen=True)
class FaultDecision:
    """What the guardian decided for one fault."""

    action: str                       # "retry" | "evict"
    cause: str
    attempt: int                      # consecutive fault count for this cause
    cooldown: int = 0                 # backoff, in intervals (retry only)
    quarantined: Tuple[int, ...] = () # dataset indices quarantined just now
    detached: bool = False            # detached from its group just now


class TrainingGuardian:
    """Per-run health policy state.

    Decisions are made from the orchestrator's loop after the engine's
    interval barrier; the ledgers are guarded by a leaf lock because read
    paths (``benched``) may be reached from other threads."""

    def __init__(self, config: Optional[GuardianConfig] = None, journal=None):
        self.config = config if config is not None else GuardianConfig.from_env()
        # a durability.Journal; the orchestrator sets it for a run with resume_dir
        self.journal = journal
        self._mu = threading.Lock()
        # (task, cause) -> consecutive faults; cleared by note_success.
        self._streak: Dict[Tuple[str, str], int] = {}
        # task -> consecutive faults of any cause (drives group detach).
        self._total: Dict[str, int] = {}
        self._detached: set = set()
        # task -> first interval index it may run again (backoff parking).
        self._benched: Dict[str, int] = {}

    # ------------------------------------------------------- classification
    @staticmethod
    def owns(err: BaseException) -> bool:
        """Is this a training fault the guardian manages (a non-finite loss,
        a hung launch)? Anything else — a kernel that does not build or
        launch included — is an ordinary task failure for the caller."""
        return isinstance(err, (NumericFaultError, HungDispatchError))

    @staticmethod
    def cause_of(err: BaseException) -> str:
        if isinstance(err, NumericFaultError):
            return err.cause
        return CAUSE_HUNG

    @property
    def watchdog_enabled(self) -> bool:
        return self.config.watchdog

    # ------------------------------------------------------------ watchdog
    def window_deadline_s(self, expected_s: float) -> float:
        """Deadline for an interval expected to take ``expected_s`` of
        profiled window time: ``floor + factor x expected``."""
        return self.config.watchdog_floor_s + self.config.watchdog_factor * max(
            float(expected_s), 0.0
        )

    # -------------------------------------------------------------- policy
    def on_fault(self, task: Any, err: BaseException, interval_index: int,
                 in_group: bool = False) -> FaultDecision:
        """Classify one health fault and decide retry/evict. The caller has
        already rolled the task back (``release_live_state`` +
        ``rollback_forecast``); this only changes policy state, the task's
        quarantine skip-list and, for a task of a co-schedule or fusion
        group (``in_group``), its detach."""
        cause = self.cause_of(err)
        key = (task.name, cause)
        with self._mu:
            streak = self._streak[key] = self._streak.get(key, 0) + 1
            total = self._total[task.name] = self._total.get(task.name, 0) + 1
        code = HEALTH_EVENT_CODES.get(
            "hung_dispatch" if cause == CAUSE_HUNG else "numeric_fault"
        )
        metrics.event(
            "health", code=code, task=task.name, cause=cause,
            attempt=streak, interval=interval_index,
        )
        self._journal("health_fault", task=task.name, cause=cause, attempt=streak,
                      interval=interval_index, error=repr(err))

        quarantined: Tuple[int, ...] = ()
        if (
            isinstance(err, NumericFaultError)
            and err.batch_indices
            and streak >= self.config.quarantine_after
        ):
            quarantined = self.quarantine(task, err.batch_indices)

        detached = False
        if in_group and task.name not in self._detached and total >= self.config.detach_after:
            self.detach(task)
            detached = True

        budget = (
            self.config.hung_budget if cause == CAUSE_HUNG
            else self.config.retry_budget
        )
        if streak > budget:
            metrics.event(
                "health", code=HEALTH_EVENT_CODES["evict"], task=task.name,
                cause=cause, attempt=streak,
            )
            logger.error(
                "guardian: evicting %s after %d consecutive %s fault(s)",
                task.name, streak, cause,
            )
            return FaultDecision("evict", cause=cause, attempt=streak,
                                 quarantined=quarantined, detached=detached)

        cooldown = min(
            self.config.backoff_cap,
            max(1, self.config.backoff_base) * (2 ** (streak - 1)),
        )
        resume_at = interval_index + 1 + cooldown
        with self._mu:
            self._benched[task.name] = resume_at
        metrics.event(
            "health", code=HEALTH_EVENT_CODES["backoff"], task=task.name,
            cause=cause, attempt=streak, cooldown_intervals=cooldown,
        )
        self._journal("health_backoff", task=task.name, cause=cause, attempt=streak,
                      cooldown_intervals=cooldown, resume_interval=resume_at)
        logger.warning(
            "guardian: %s fault #%d on %s — rolled back, retrying after "
            "%d-interval backoff%s%s", cause, streak, task.name, cooldown,
            f", quarantined batches {list(quarantined)}" if quarantined else "",
            ", detached from its group" if detached else "",
        )
        return FaultDecision("retry", cause=cause, attempt=streak, cooldown=cooldown,
                             quarantined=quarantined, detached=detached)

    def note_success(self, name: str) -> None:
        """A clean interval resets the consecutive-fault ledgers (the
        quarantine and the detach persist — corrections, not penalties)."""
        with self._mu:
            self._total.pop(name, None)
            for key in [k for k in self._streak if k[0] == name]:
                del self._streak[key]

    # --------------------------------------------------------------- detach
    def detach(self, task: Any) -> None:
        """Keep the task out of co-schedule and fusion groups at every later
        solve, and flag it (``_fused_detach``) so that a stack running it
        unfuses it at its next unit boundary. Journaled with an immediate
        commit (``health_detach``). ``task`` is a task or its name."""
        name = getattr(task, "name", task)
        if not isinstance(task, str):
            task._fused_detach = True
        with self._mu:
            self._detached.add(name)
        metrics.event("health", code=HEALTH_EVENT_CODES["detach"], task=name)
        self._journal("health_detach", durable=True, task=name)

    def detached_names(self) -> FrozenSet[str]:
        with self._mu:
            return frozenset(self._detached)

    # ---------------------------------------------------------- quarantine
    def quarantine(self, task: Any, indices: Iterable[int]) -> Tuple[int, ...]:
        """Add dataset indices to the task's skip-list; journaled with an
        immediate commit."""
        idx = tuple(sorted({int(i) for i in indices}))
        if not idx:
            return ()
        try:
            task.quarantine_batches(idx)
        except ValueError as e:
            # The task refused (skip-listing these would empty the dataset).
            # Don't crash the recovery path: keep retrying under the budget
            # and let eviction handle a job whose every batch faults.
            logger.warning("guardian: quarantine refused for %s: %s",
                           task.name, e)
            return ()
        metrics.event(
            "health", code=HEALTH_EVENT_CODES["quarantine"], task=task.name,
            batches=list(idx),
        )
        self._journal("health_quarantine", durable=True, task=task.name,
                      indices=list(idx))
        return idx

    # -------------------------------------------------------------- parking
    def benched(self, name: str, interval_index: int) -> bool:
        """Is the task still inside its backoff window? Clears the bench
        entry once the resume interval is reached."""
        with self._mu:
            resume = self._benched.get(name)
            if resume is None:
                return False
            if interval_index >= resume:
                del self._benched[name]
                return False
            return True

    def resume_interval(self, name: str) -> Optional[int]:
        with self._mu:
            return self._benched.get(name)

    def unbench_all(self, cause: str = "grow") -> Tuple[str, ...]:
        """End every backoff window now (a grow event: returned capacity runs
        parked work at once). The streaks stay, so a flaky task's next fault
        still backs off harder, as if its bench had expired."""
        with self._mu:
            released = tuple(sorted(self._benched))
            self._benched.clear()
        for name in released:
            metrics.event("health", code=HEALTH_EVENT_CODES["backoff"], task=name,
                          cause=cause, unbenched=True)
        if released:
            self._journal("health_unbench", tasks=list(released), cause=cause)
        return released

    # ------------------------------------------------------------- recovery
    def restore(self, quarantined: Dict[str, List[int]], detached: Iterable[str],
                tasks: Iterable[Any] = ()) -> None:
        """Re-apply journaled health state after a crash: the quarantine
        skip-lists onto the rebuilt tasks, the detach set onto the guardian
        (and the ``_fused_detach`` flag onto its tasks). Streaks and
        backoffs start over, as in the JAX package: an incarnation boundary
        is a clean slate for counting faults."""
        by_name = {t.name: t for t in tasks}
        for name, idx in (quarantined or {}).items():
            t = by_name.get(name)
            if t is not None and idx:
                t.quarantine_batches(idx)
                logger.info("recovery: re-applied the quarantine of %d batch(es) to %s",
                            len(idx), name)
        with self._mu:
            self._detached.update(detached or ())
        for name in detached or ():
            if name in by_name:
                by_name[name]._fused_detach = True

    def _journal(self, kind: str, durable: bool = False, **data) -> None:
        if self.journal is None:
            return
        if durable:
            self.journal.log(kind, **data)
        else:
            self.journal.append(kind, **data)
