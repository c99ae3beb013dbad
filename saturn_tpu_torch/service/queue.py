"""Submission queue and the job lifecycle state machine of the online service.

Counterpart of ``saturn_tpu/service/queue.py``. One queue is the registry
of every job the service has seen: arrivals wait here, the service loop
drains them at interval boundaries, a preempted job is requeued through
the same queue (it re-admits warm, its strategies already profiled), and
clients block on the queue's condition in ``wait()``.

State machine (enforced: an illegal transition raises)::

    QUEUED ──► PROFILING ──► SCHEDULED ──► RUNNING ──► DONE
      ▲            │             │            │
      │            ├─► FAILED    │            ├─► FAILED
      │            │             │            │
      └────────────┴◄────────────┴────────────┘   (defer / preemption
                   └─► EVICTED (any non-terminal)  requeue)

``DONE``, ``FAILED`` and ``EVICTED`` are terminal; a cancelled job is
EVICTED with the error ``"cancelled"``. The JAX queue's ``sched_point``
and ``tsan`` hooks belong to its concurrency sanitizer, which has no
counterpart here (``ROADMAP.md``, queue 3): the locks are plain
``threading`` ones.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from saturn_tpu_torch.tenancy.model import DEFAULT_TENANT
from saturn_tpu_torch.utils import metrics


class JobState(str, enum.Enum):
    QUEUED = "QUEUED"          # submitted, waiting for the admission drain
    PROFILING = "PROFILING"    # admission profiling it or reading the cache
    SCHEDULED = "SCHEDULED"    # in the live plan, waiting for its start
    RUNNING = "RUNNING"        # launched at least once
    DONE = "DONE"              # every batch ran
    FAILED = "FAILED"          # rejected, or failed past its retries
    EVICTED = "EVICTED"        # cancelled, or shed by a replan or pressure


TERMINAL_STATES = frozenset({JobState.DONE, JobState.FAILED, JobState.EVICTED})

#: The states in which a job holds (or is about to hold) devices: what a
#: tenant's ``max_live_jobs`` gate counts. Queued arrivals are left out, or
#: a burst's own queued siblings would defer the whole burst for ever.
_ADMITTED_STATES = frozenset({JobState.SCHEDULED, JobState.RUNNING})

#: Legal transitions. QUEUED is entered again from PROFILING (a defer),
#: SCHEDULED (a replan dropped the slot) and RUNNING (a preemption);
#: EVICTED from every non-terminal state.
_TRANSITIONS: Dict[JobState, frozenset] = {
    JobState.QUEUED: frozenset({JobState.PROFILING, JobState.EVICTED}),
    JobState.PROFILING: frozenset(
        {JobState.SCHEDULED, JobState.QUEUED, JobState.FAILED, JobState.EVICTED}),
    JobState.SCHEDULED: frozenset(
        {JobState.RUNNING, JobState.QUEUED, JobState.FAILED, JobState.EVICTED}),
    JobState.RUNNING: frozenset(
        {JobState.DONE, JobState.FAILED, JobState.QUEUED, JobState.EVICTED}),
    JobState.DONE: frozenset(),
    JobState.FAILED: frozenset(),
    JobState.EVICTED: frozenset(),
}


@dataclass
class JobRequest:
    """What a client submits: a profiled or profilable task and its policy."""

    task: object                        # a Task (or a duck-typed one)
    priority: float = 0.0               # higher is more urgent (solver weight,
    #                                     eviction order)
    deadline_s: Optional[float] = None  # seconds from submission; the pressure
    #                                     shedder protects it
    max_retries: int = 1                # extra attempts after a task failure
    #                                     (preemptions use none)
    spec: Optional[dict] = None         # JSON-able rebuild payload, journaled
    #                                     with the submission and handed to
    #                                     ``task_provider`` after a crash
    dedup_key: Optional[str] = None     # idempotency key, journaled with the
    #                                     submission
    tenant: Optional[str] = None        # billing / fairness principal (None:
    #                                     the default tenant)


@dataclass
class JobRecord:
    """The queue's view of one job over its lifetime."""

    job_id: str
    request: JobRequest
    state: JobState = JobState.QUEUED
    submitted_at: float = 0.0             # time.monotonic() stamps
    admitted_at: Optional[float] = None
    scheduled_at: Optional[float] = None
    started_at: Optional[float] = None    # the first RUNNING only
    finished_at: Optional[float] = None
    deadline_at: Optional[float] = None   # submitted_at + deadline_s
    attempts: int = 0                     # failed attempts so far
    requeues: int = 0                     # preemption / defer round trips
    trials_run: int = 0                   # trials admission ran for it
    weight: float = 0.0                   # solver objective weight
    error: Optional[str] = None
    cancel_requested: bool = False

    @property
    def task(self):
        return self.request.task

    @property
    def name(self) -> str:
        return self.request.task.name

    @property
    def tenant(self) -> str:
        return self.request.tenant or DEFAULT_TENANT

    def snapshot(self) -> dict:
        """The client's view: plain data."""
        return {
            "job_id": self.job_id,
            "task": self.name,
            "tenant": self.tenant,
            "state": self.state.value,
            "priority": self.request.priority,
            "deadline_s": self.request.deadline_s,
            "submitted_at": self.submitted_at,
            "admitted_at": self.admitted_at,
            "scheduled_at": self.scheduled_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "attempts": self.attempts,
            "requeues": self.requeues,
            "trials_run": self.trials_run,
            "weight": self.weight,
            "error": self.error,
        }


class SubmissionQueue:
    """Thread-safe arrival queue and job registry. Every transition goes
    through :meth:`mark`, whichever thread drives it (a client, the service
    loop, or an engine launcher's ``on_task_start``)."""

    def __init__(self, observer=None):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._jobs: Dict[str, JobRecord] = {}
        self._arrivals: List[str] = []     # job ids waiting for the next drain
        self._live_names: Dict[str, str] = {}      # name -> job id, non-terminal jobs
        self._tenant_live: Dict[str, int] = {}     # tenant -> non-terminal jobs
        self._tenant_admitted: Dict[str, int] = {}  # tenant -> SCHEDULED or RUNNING jobs
        self._seq = 0
        #: ``observer(event, rec)`` called under the queue lock after each
        #: registry change ("submitted", "state", "recovered",
        #: "cancel_requested"): the write-ahead journal's hook. Lock order:
        #: queue, then journal.
        self.observer = observer

    def _notify_observer(self, event: str, rec: JobRecord) -> None:
        if self.observer is not None:
            self.observer(event, rec)

    # ------------------------------------------------------------ submission
    def submit(self, request: JobRequest) -> JobRecord:
        """Register a job and put it on the arrival queue. Task names must
        be unique among live jobs (plans, engine events and checkpoints key
        on the name); a finished job's name may be submitted again."""
        name = getattr(request.task, "name", None)
        if not name:
            raise ValueError("JobRequest.task must have a non-empty .name")
        with self._lock:
            live_id = self._live_names.get(name)
            if live_id is not None:
                rec = self._jobs[live_id]
                raise ValueError(
                    f"task name {name!r} is already live as {rec.job_id} "
                    f"({rec.state.value}) — task names must be unique among active jobs")
            self._seq += 1
            now = time.monotonic()
            rec = JobRecord(
                job_id=f"j{self._seq:04d}-{name}", request=request, submitted_at=now,
                deadline_at=now + request.deadline_s if request.deadline_s is not None else None,
            )
            self._jobs[rec.job_id] = rec
            self._live_names[name] = rec.job_id
            self._tenant_live[rec.tenant] = self._tenant_live.get(rec.tenant, 0) + 1
            self._arrivals.append(rec.job_id)
            self._notify_observer("submitted", rec)
            self._cond.notify_all()
        metrics.event("job_submitted", job=rec.job_id, task=name, tenant=rec.tenant,
                      priority=request.priority, deadline_s=request.deadline_s)
        return rec

    def restore(self, rec: JobRecord) -> JobRecord:
        """Register a job rebuilt from the journal under its original id
        (crash recovery only). A terminal job stays an inert registry entry
        so ``status`` / ``wait`` answer for it; a live one goes back on the
        arrival queue and re-admits. ``_seq`` moves past every recovered id."""
        name = rec.name
        with self._lock:
            if rec.job_id in self._jobs:
                raise ValueError(f"job id {rec.job_id!r} already registered")
            if rec.state not in TERMINAL_STATES:
                live_id = self._live_names.get(name)
                if live_id is not None:
                    other = self._jobs[live_id]
                    raise ValueError(
                        f"task name {name!r} is already live as {other.job_id} "
                        f"({other.state.value}) — cannot restore {rec.job_id}")
            try:  # job_id format: j{seq:04d}-{name}
                recovered_seq = int(rec.job_id[1:].split("-", 1)[0])
            except (ValueError, IndexError):
                recovered_seq = 0
            self._seq = max(self._seq, recovered_seq)
            self._jobs[rec.job_id] = rec
            if rec.state not in TERMINAL_STATES:
                self._live_names[name] = rec.job_id
                self._tenant_live[rec.tenant] = self._tenant_live.get(rec.tenant, 0) + 1
                if rec.state in _ADMITTED_STATES:
                    self._tenant_admitted[rec.tenant] = (
                        self._tenant_admitted.get(rec.tenant, 0) + 1)
                if rec.job_id not in self._arrivals:
                    self._arrivals.append(rec.job_id)
                self._notify_observer("recovered", rec)
            self._cond.notify_all()
        if rec.state not in TERMINAL_STATES:
            metrics.event("job_recovered", job=rec.job_id, task=name, requeues=rec.requeues,
                          attempts=rec.attempts,
                          remaining_batches=getattr(rec.task, "total_batches", None))
        return rec

    def requeue(self, rec: JobRecord) -> None:
        """Put a job back on the arrival queue (a defer, a dropped slot, a
        preemption); it re-admits warm."""
        with self._lock:
            if rec.state is not JobState.QUEUED:
                self.mark(rec, JobState.QUEUED)
            rec.requeues += 1
            if rec.job_id not in self._arrivals:
                self._arrivals.append(rec.job_id)
            self._cond.notify_all()

    def drain(self) -> List[JobRecord]:
        """Take every waiting arrival, first in first out."""
        with self._lock:
            ids, self._arrivals = self._arrivals, []
            return [self._jobs[i] for i in ids]

    def wait_for_arrival(self, timeout: Optional[float] = None) -> bool:
        """Block until an arrival waits, or ``timeout``; returns whether one
        does (one timed wait: the caller's loop asks again)."""
        with self._lock:
            if not self._arrivals:
                self._cond.wait(timeout)
            return bool(self._arrivals)

    # ------------------------------------------------------------ lifecycle
    def mark(self, rec: JobRecord, state: JobState, *, error: Optional[str] = None) -> None:
        """Move a job to ``state``, stamping its times. An illegal
        transition raises: it is a bug of the service."""
        with self._lock:
            if state not in _TRANSITIONS[rec.state]:
                raise RuntimeError(
                    f"illegal job transition {rec.state.value} -> {state.value} for "
                    f"{rec.job_id}")
            was_admitted = rec.state in _ADMITTED_STATES
            rec.state = state
            if state in _ADMITTED_STATES and not was_admitted:
                self._tenant_admitted[rec.tenant] = self._tenant_admitted.get(rec.tenant, 0) + 1
            elif was_admitted and state not in _ADMITTED_STATES:
                n = self._tenant_admitted.get(rec.tenant, 0) - 1
                if n > 0:
                    self._tenant_admitted[rec.tenant] = n
                else:
                    self._tenant_admitted.pop(rec.tenant, None)
            if state in TERMINAL_STATES and self._live_names.get(rec.name) == rec.job_id:
                del self._live_names[rec.name]
                n = self._tenant_live.get(rec.tenant, 0) - 1
                if n > 0:
                    self._tenant_live[rec.tenant] = n
                else:
                    self._tenant_live.pop(rec.tenant, None)
            now = time.monotonic()
            if state is JobState.SCHEDULED:
                if rec.admitted_at is None:  # the first admission
                    rec.admitted_at = now
                rec.scheduled_at = now
            elif state is JobState.RUNNING and rec.started_at is None:
                rec.started_at = now
            elif state in TERMINAL_STATES:
                rec.finished_at = now
            if error is not None:
                rec.error = error
            self._notify_observer("state", rec)
            self._cond.notify_all()

    # -------------------------------------------------------------- queries
    def get(self, job_id: str) -> JobRecord:
        with self._lock:
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"unknown job id {job_id!r}") from None

    def jobs(self) -> List[JobRecord]:
        with self._lock:
            return list(self._jobs.values())

    def depth(self) -> int:
        """Jobs waiting for admission (QUEUED or PROFILING)."""
        with self._lock:
            return sum(1 for r in self._jobs.values()
                       if r.state in (JobState.QUEUED, JobState.PROFILING))

    def live(self) -> int:
        """Jobs in any non-terminal state."""
        with self._lock:
            return len(self._live_names)

    def live_tenant(self, tenant: Optional[str]) -> int:
        """The tenant's non-terminal jobs (None: the default tenant)."""
        with self._lock:
            return self._tenant_live.get(tenant or DEFAULT_TENANT, 0)

    def admitted_tenant(self, tenant: Optional[str]) -> int:
        """The tenant's SCHEDULED or RUNNING jobs: what ``max_live_jobs``
        counts."""
        with self._lock:
            return self._tenant_admitted.get(tenant or DEFAULT_TENANT, 0)

    def live_by_tenant(self) -> Dict[str, int]:
        """tenant -> live job count (a copy)."""
        with self._lock:
            return dict(self._tenant_live)

    def compact(self) -> int:
        """Drop terminal jobs from the registry; returns how many. Their
        ids stop answering ``status`` / ``wait``."""
        with self._lock:
            dead = [jid for jid, r in self._jobs.items() if r.state in TERMINAL_STATES]
            for jid in dead:
                del self._jobs[jid]
            return len(dead)

    def wait(self, job_id: str, timeout: Optional[float] = None) -> JobRecord:
        """Block until the job is terminal; ``TimeoutError`` after
        ``timeout``."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            rec = self.get(job_id)
            while rec.state not in TERMINAL_STATES:
                remaining = deadline - time.monotonic() if deadline is not None else None
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"job {job_id} still {rec.state.value} after {timeout}s")
                self._cond.wait(remaining)
            return rec

    def cancel(self, job_id: str) -> bool:
        """Ask for cancellation. A QUEUED job is evicted at once; an
        admitted one is flagged and evicted at the next interval boundary,
        and the observer hears of the request at once ("cancel_requested":
        the journal commits it, so a kill before the boundary does not bring
        the job back). False if the job is terminal already."""
        with self._lock:
            rec = self.get(job_id)
            if rec.state in TERMINAL_STATES:
                return False
            first = not rec.cancel_requested
            rec.cancel_requested = True
            if rec.state is JobState.QUEUED:
                self._arrivals = [i for i in self._arrivals if i != job_id]
                self.mark(rec, JobState.EVICTED, error="cancelled")
                metrics.event("job_evicted", job=rec.job_id, task=rec.name, reason="cancelled")
            elif first:
                self._notify_observer("cancel_requested", rec)
            return True
