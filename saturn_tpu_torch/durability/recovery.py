"""Journal replay into recovery state, and the reconciliation of journaled
checkpoints against the disk.

Counterpart of ``saturn_tpu/durability/recovery.py``. Two callers replay
the same write-ahead journal:

- the online service (``SaturnService(durability_dir=...)``) rebuilds its
  job registry: every job submitted, its last durable state, its retries
  and requeues, its realized iterations and the last committed plan
  (``replay_service_state``, ``build_restore_records``);
- the batch orchestrator (``orchestrate(resume_dir=...)``) rebuilds each
  task's progress (``replay_batch_state``).

Only committed records count (the journal's ``recover`` has already rolled
torn tails back), so work that ran and was not committed runs again:
running work twice is safe, counting it twice is not.

A resumed job's budget follows its checkpoint, as the batch path's does
(``ROADMAP.md``, queue 3): the JAX package hands ``task_provider`` the
journal's remaining batches while the technique restores the checkpoint's
step, and a checkpoint saved ahead of the journal's last commit then
trains those batches twice over the budget. :func:`follow_checkpoints`
takes a live job's realized count from its verified checkpoint and
journals the difference as ``task_progress``, so the journal counts every
batch of the checkpoint once. The port's ``job_admission`` record also
names the job's checkpoint path (``ckpt_path``, a field the JAX package
does not write and ignores on replay), so a checkpoint whose
``ckpt_published`` record died uncommitted is found all the same.

A cancel of an admitted job is journaled when it is asked for: a
``job_state`` record of the job's current state, attempts and requeues
with ``cancel_requested`` set. The JAX fold reads only the state, counts
and error, so it leaves the job as it was; this fold keeps the flag, and
:func:`build_restore_records` evicts such a live job as "cancelled"
without rebuilding it (JAX has no such record and resurrects the job:
``ROADMAP.md``, queue 3).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from saturn_tpu_torch.durability import journal as jmod

logger = logging.getLogger("saturn_tpu_torch")


#: Lifecycle states that need no resurrection on restart.
_TERMINAL = frozenset({"DONE", "FAILED", "EVICTED"})


@dataclass
class JobReplay:
    """One job's durable state, rebuilt from the journal."""

    job_id: str
    task: str
    priority: float = 0.0
    deadline_s: Optional[float] = None
    max_retries: int = 1
    total_batches: int = 0         # as submitted (the original budget)
    realized: int = 0              # journaled completed iterations
    state: str = "QUEUED"
    attempts: int = 0
    requeues: int = 0
    error: Optional[str] = None
    spec: Optional[dict] = None    # the caller's rebuild payload
    dedup_key: Optional[str] = None
    tenant: Optional[str] = None
    ckpt_path: Optional[str] = None  # from the port's job_admission records
    cancel_requested: bool = False   # a journaled cancel of the admitted job

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    @property
    def remaining(self) -> int:
        return max(0, self.total_batches - self.realized)


@dataclass
class ServiceRecovery:
    """What the service needs to resume from the durable cut."""

    jobs: Dict[str, JobReplay] = field(default_factory=dict)
    plan: Optional[dict] = None          # the last committed plan (to_json form)
    checkpoints: Dict[str, List[str]] = field(default_factory=dict)
    last_seq: int = 0
    n_records: int = 0
    incarnations: int = 0
    # the health guardian's state, by task name
    quarantined: Dict[str, List[int]] = field(default_factory=dict)
    detached: List[str] = field(default_factory=list)
    #: dedup_key -> job_id, from ``job_submitted`` records
    dedup: Dict[str, str] = field(default_factory=dict)
    #: the highest journaled ``gateway_lease`` epoch and its owner, and every
    #: acquisition [(epoch, owner, prev_owner)]: the service seeds the
    #: gateway's dedup table and a restarted replica set's lease from them
    lease_epoch: int = 0
    lease_owner: Optional[str] = None
    lease_history: List[Any] = field(default_factory=list)
    #: tenant -> chip-seconds burned, from ``tenant_charge`` records
    tenant_charges: Dict[str, float] = field(default_factory=dict)
    #: compile_ahead status -> count, kept for the compile-ahead pool
    compile_ahead: Dict[str, int] = field(default_factory=dict)
    #: (wave, task) -> intent record of every ``migration_intent`` with no
    #: ``migration_done`` / ``migration_rollback``
    pending_migrations: Dict[Any, dict] = field(default_factory=dict)
    migrations_done: int = 0
    migrations_rolled_back: int = 0
    grow_events: int = 0
    backlog_drained: int = 0
    #: the highest wave sequence number of any wave record
    defrag_waves: int = 0
    #: job_id -> its latest ``job_deferred`` record
    deferred: Dict[str, dict] = field(default_factory=dict)
    #: task -> seq of its newest ``ckpt_published`` record
    last_ckpt_seq: Dict[str, int] = field(default_factory=dict)

    def live_jobs(self) -> List[JobReplay]:
        return [j for j in self.jobs.values() if not j.terminal]

    def resolve_pending_migrations(self):
        """Split the open migration intents into (resume, rollback): a move
        whose victim's checkpoint was published after its intent closes as
        done, every other one rolls back. The caller journals one record
        each, so an intent closes exactly once."""
        resume, rollback = [], []
        for (_wave, task), rec in sorted(self.pending_migrations.items()):
            if self.last_ckpt_seq.get(task, -1) > rec["seq"]:
                resume.append(rec)
            else:
                rollback.append(rec)
        return resume, rollback


@dataclass
class BatchRecovery:
    """Per-task durable progress for ``orchestrate(resume_dir=...)``."""

    progress: Dict[str, int] = field(default_factory=dict)
    completed: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)
    plan: Optional[dict] = None
    checkpoints: Dict[str, List[str]] = field(default_factory=dict)
    last_seq: int = 0
    n_records: int = 0
    quarantined: Dict[str, List[int]] = field(default_factory=dict)
    detached: List[str] = field(default_factory=list)


def fold_health_record(kind: str, d: Dict[str, Any], quarantined: Dict[str, List[int]],
                       detached: List[str]) -> bool:
    """Fold one ``health_*`` record into recovery state: ``health_quarantine``
    adds dataset indices to the task's sorted skip-list,
    ``health_unquarantine`` removes them (all of them with ``indices=None``),
    ``health_detach`` marks the task out of co-schedule groups. Returns
    whether the record was a health record."""
    task = d.get("task", "")
    if kind == "health_quarantine":
        cur = set(quarantined.get(task, ()))
        cur.update(int(i) for i in d.get("indices", ()))
        quarantined[task] = sorted(cur)
    elif kind == "health_unquarantine":
        indices = d.get("indices")
        if indices is None:
            quarantined.pop(task, None)
        else:
            cur = set(quarantined.get(task, ())) - {int(i) for i in indices}
            if cur:
                quarantined[task] = sorted(cur)
            else:
                quarantined.pop(task, None)
    elif kind == "health_detach":
        if task not in detached:
            detached.append(task)
    else:
        return False
    return True


def _wave_seq(wave_id: str) -> int:
    """The trailing sequence number of a ``wave-<interval>-<seq>`` id (0 when
    it does not parse)."""
    try:
        return int(str(wave_id).rsplit("-", 1)[-1])
    except (TypeError, ValueError):
        return 0


def replay_service_state(root: str) -> ServiceRecovery:
    """Fold the durable journal into the service's recovery state, over
    every incarnation (a job submitted in one, recovered in the next and
    finished in a third is one :class:`JobReplay`). A pure read, with the
    JAX package's fold of every record kind."""
    state = ServiceRecovery()
    for rec in jmod.replay(root):
        kind, d = rec["kind"], rec.get("data", {})
        state.n_records += 1
        state.last_seq = rec["seq"]
        if kind == "segment_open":
            continue
        if kind == "recovery":
            state.incarnations += 1
        elif kind == "job_submitted":
            state.jobs[d["job"]] = JobReplay(
                job_id=d["job"], task=d["task"], priority=float(d.get("priority", 0.0)),
                deadline_s=d.get("deadline_s"), max_retries=int(d.get("max_retries", 1)),
                total_batches=int(d.get("total_batches") or 0), spec=d.get("spec"),
                dedup_key=d.get("dedup_key"), tenant=d.get("tenant"))
            if d.get("dedup_key") is not None:
                state.dedup[d["dedup_key"]] = d["job"]
        elif kind == "job_recovered":
            j = state.jobs.get(d["job"])
            if j is not None:
                j.state = "QUEUED"
                j.requeues = int(d.get("requeues", j.requeues))
        elif kind == "job_state":
            j = state.jobs.get(d["job"])
            if j is not None:
                j.state = d["state"]
                j.attempts = int(d.get("attempts", j.attempts))
                j.requeues = int(d.get("requeues", j.requeues))
                if d.get("error") is not None:
                    j.error = d["error"]
                if d.get("cancel_requested"):
                    j.cancel_requested = True
        elif kind == "job_admission":
            j = state.jobs.get(d.get("job", ""))
            if j is not None and d.get("ckpt_path"):
                j.ckpt_path = d["ckpt_path"]
        elif kind == "task_progress":
            j = state.jobs.get(d.get("job", ""))
            if j is not None:
                j.realized += int(d.get("batches", 0))
        elif kind == "plan_commit":
            if d.get("plan") is not None:
                state.plan = d["plan"]
        elif kind == "ckpt_published":
            task = d.get("task") or d.get("path", "")
            state.checkpoints.setdefault(task, []).append(d.get("path", ""))
            state.last_ckpt_seq[task] = rec["seq"]
        elif kind == "migration_intent":
            state.pending_migrations[(d.get("wave", ""), d.get("task", ""))] = dict(
                d, seq=rec["seq"])
            state.defrag_waves = max(state.defrag_waves, _wave_seq(d.get("wave", "")))
        elif kind == "migration_done":
            state.pending_migrations.pop((d.get("wave", ""), d.get("task", "")), None)
            state.migrations_done += 1
        elif kind == "migration_rollback":
            state.pending_migrations.pop((d.get("wave", ""), d.get("task", "")), None)
            state.migrations_rolled_back += 1
        elif kind == "grow_event":
            state.grow_events += 1
        elif kind == "backlog_drain":
            state.backlog_drained += len(d.get("jobs", ()))
        elif kind == "job_deferred":
            state.deferred[d.get("job", "")] = dict(d)
        elif kind == "defrag_wave":
            state.defrag_waves = max(state.defrag_waves, _wave_seq(d.get("wave", "")))
        elif kind == "gateway_lease":
            epoch = int(d.get("epoch", 0))
            owner = d.get("owner")
            state.lease_history.append((epoch, owner, d.get("prev_owner")))
            if epoch > state.lease_epoch:  # the highest, not the last
                state.lease_epoch = epoch
                state.lease_owner = owner
        elif kind == "tenant_charge":
            t = d.get("tenant") or "default"
            state.tenant_charges[t] = state.tenant_charges.get(t, 0.0) + float(
                d.get("chip_s", 0.0))
        elif kind == "compile_ahead":
            st = d.get("status", "unknown")
            state.compile_ahead[st] = state.compile_ahead.get(st, 0) + 1
        else:
            fold_health_record(kind, d, state.quarantined, state.detached)
    return state


def replay_batch_state(root: str) -> BatchRecovery:
    """Fold the journal's durable records into per-task progress (the sum
    of ``task_progress`` batches), completions, failures, the last
    ``plan_commit``, the ``ckpt_published`` paths and the health state."""
    state = BatchRecovery()
    for rec in jmod.replay(root):
        kind, d = rec["kind"], rec.get("data", {})
        state.n_records += 1
        state.last_seq = rec["seq"]
        if kind == "task_progress":
            name = d.get("task", "")
            state.progress[name] = state.progress.get(name, 0) + int(d.get("batches", 0))
        elif kind == "task_completed":
            if d["task"] not in state.completed:
                state.completed.append(d["task"])
        elif kind == "task_failed":
            state.failed[d["task"]] = d.get("error", "journaled failure")
        elif kind == "plan_commit":
            if d.get("plan") is not None:
                state.plan = d["plan"]
        elif kind == "ckpt_published":
            task = d.get("task") or d.get("path", "")
            state.checkpoints.setdefault(task, []).append(d.get("path", ""))
        else:
            fold_health_record(kind, d, state.quarantined, state.detached)
    return state


def reconcile_checkpoints(checkpoints: Dict[str, List[str]]) -> Dict[str, Optional[str]]:
    """Check journaled checkpoint publications against the disk.

    For each task, newest publication first: a missing file is skipped, one
    that fails ``checkpoint.verify`` is quarantined to a ``.corrupt``
    sidecar, and the newest sound one wins. Returns ``{task: path or
    None}``. The port writes each task's checkpoint to one path, so a
    quarantined newest file leaves the task with no checkpoint."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    out: Dict[str, Optional[str]] = {}
    for task, paths in checkpoints.items():
        out[task] = None
        for path in reversed(paths):
            if not os.path.exists(path):
                continue
            if ckpt.verify(path):
                out[task] = path
                break
            sidecar = ckpt.quarantine(path)
            logger.warning("recovery: checkpoint %s of %s failed verification; "
                           "quarantined to %s", path, task, sidecar)
    return out


def follow_checkpoints(state: ServiceRecovery, sound: Dict[str, Optional[str]],
                       journal=None) -> Dict[str, tuple]:
    """Take each live job's realized count from its checkpoint.

    A live job's checkpoint is its newest sound journaled publication
    (``sound``, :func:`reconcile_checkpoints`' answer) or the file its
    ``job_admission`` named, verified here (one that fails goes to a
    sidecar and counts as none). Where one exists, its step is what the
    job realized: ``realized`` is set to it and, with a ``journal``, the
    difference from the journal's count is appended as a ``task_progress``
    record (negative where the checkpoint is behind). A job without a
    checkpoint keeps the journal's count. Returns ``{job_id: (journaled,
    step)}`` of the jobs whose count changed."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    changed: Dict[str, tuple] = {}
    for j in state.live_jobs():
        if j.cancel_requested:
            continue  # evicted on restore: its progress counts for nothing
        path = sound.get(j.task)
        if path is None and j.ckpt_path and ckpt.exists(j.ckpt_path):
            if ckpt.verify(j.ckpt_path):
                path = j.ckpt_path
            else:
                sidecar = ckpt.quarantine(j.ckpt_path)
                logger.warning("recovery: checkpoint %s of %s failed verification; "
                               "quarantined to %s", j.ckpt_path, j.job_id, sidecar)
        if path is None:
            continue
        step = ckpt.saved_step(path)
        if step == j.realized:
            continue
        changed[j.job_id] = (j.realized, step)
        if journal is not None:
            journal.append("task_progress", task=j.task, job=j.job_id,
                           batches=step - j.realized)
        logger.info("recovery: %s's checkpoint is at step %d, the journal at %d", j.job_id,
                    step, j.realized)
        j.realized = step
    return changed


class RecoveredTaskStub:
    """The task of a journaled job that needs no execution (it is terminal):
    the queue's duck-typed contract (``name``, ``total_batches``) without a
    model."""

    def __init__(self, name: str, total_batches: int = 0):
        self.name = name
        self.total_batches = total_batches
        self.strategies: Dict[int, Any] = {}

    def feasible_strategies(self) -> Dict[int, Any]:
        return {}


def build_restore_records(state: ServiceRecovery,
                          task_provider: Optional[Callable[[dict], Any]]) -> List:
    """Turn replayed jobs into queue-restorable ``JobRecord``s.

    A live job is rebuilt through ``task_provider``, which receives its
    spec (``remaining_batches``: the original budget less what it
    realized) and returns a fresh task; the record re-enters the queue
    QUEUED and re-admits warm through the profile cache. A terminal job is
    restored as an inert entry so ``status`` / ``wait`` keep answering; so
    is a live job with a journaled cancel, EVICTED ("cancelled"), with no
    provider call. Raises when live jobs exist and no provider does:
    dropping admitted work silently is what this module exists to
    prevent."""
    from saturn_tpu_torch.service.queue import JobRecord, JobRequest, JobState

    live = [j for j in state.live_jobs() if not j.cancel_requested]
    if live and task_provider is None:
        raise RuntimeError(
            f"journal holds {len(live)} live job(s) ({', '.join(j.job_id for j in live)}) but "
            "no task_provider was given — pass SaturnService(task_provider=...) so recovery "
            "can rebuild their task objects")
    out: List = []
    now = time.monotonic()
    for j in state.jobs.values():
        # every iteration of a live job realized: only its verdict was lost
        finished = not j.terminal and j.total_batches > 0 and j.realized >= j.total_batches
        cancelled = not j.terminal and not finished and j.cancel_requested
        if j.terminal or finished or cancelled:
            req = JobRequest(task=RecoveredTaskStub(j.task, j.total_batches),
                             priority=j.priority, deadline_s=j.deadline_s,
                             max_retries=j.max_retries, spec=j.spec, dedup_key=j.dedup_key,
                             tenant=j.tenant)
            verdict = (JobState.DONE if finished else JobState.EVICTED if cancelled
                       else JobState(j.state))
            out.append(JobRecord(
                job_id=j.job_id, request=req, state=verdict, submitted_at=now, finished_at=now,
                attempts=j.attempts, requeues=j.requeues,
                error="cancelled" if cancelled else j.error, cancel_requested=j.cancel_requested))
            continue
        task = task_provider({
            "job_id": j.job_id,
            "task": j.task,
            "total_batches": j.total_batches,
            "remaining_batches": j.remaining,
            "priority": j.priority,
            "deadline_s": j.deadline_s,
            "max_retries": j.max_retries,
            "spec": j.spec,
            "tenant": j.tenant,
        })
        if getattr(task, "name", None) != j.task:
            raise ValueError(
                f"task_provider returned task named {getattr(task, 'name', None)!r} for "
                f"journaled job {j.job_id} ({j.task!r}) — names must match")
        task.total_batches = j.remaining  # realized iterations never run again
        req = JobRequest(task=task, priority=j.priority, deadline_s=j.deadline_s,
                         max_retries=j.max_retries, spec=j.spec, dedup_key=j.dedup_key,
                         tenant=j.tenant)
        out.append(JobRecord(
            job_id=j.job_id, request=req, state=JobState.QUEUED, submitted_at=now,
            deadline_at=now + j.deadline_s if j.deadline_s is not None else None,
            attempts=j.attempts,
            requeues=j.requeues + (1 if j.state in ("RUNNING", "SCHEDULED") else 0)))
    return out


def audit_plan_commits(root: str, topology: Any = None, tasks: Optional[List] = None):
    """The static verifier's audit of every ``plan_commit`` of the journal
    (``analysis.plan_verifier.audit_journal``); returns its report."""
    from saturn_tpu_torch.analysis import plan_verifier

    return plan_verifier.audit_journal(root, topology=topology, tasks=tasks)
