"""The service loop: an always-on incremental SPASE scheduler.

Counterpart of ``saturn_tpu/service/server.py``. It reuses the batch
orchestrator's machinery (``engine.forecast`` / ``engine.execute`` for the
interval, ``anytime.anytime_resolve`` for the re-solve,
``fold_realized_feedback`` for the estimates, the ``ElasticReplanner`` for
topology changes) but runs until stopped, folding the queue's arrivals
into the live plan at every interval boundary:

    loop:  health poll -> drain arrivals (admission) -> defrag wave ->
           cancel sweep -> pressure shed -> weighted re-solve (verified) ->
           forecast -> execute -> feedback fold -> preemption and health
           requeues -> retries -> retirements -> interval-end group commit

The re-solve is incremental: the anytime ladder's tier 0 keeps the live
plan and inserts the arrivals into free (block, time) slots, heaviest
first, and the priority / deadline weights bias every tier. The JAX
service proposes no fusion groups and runs only the co-schedule groups its
plans hold; so does this one.

Single host by construction: the port has no multi-host module
(``ROADMAP.md``, queue 1 item 9), where the JAX service refuses a
multi-host run. What the network gateway (``service/gateway``) reads is
kept as in the JAX service: the replayed dedup table and lease epoch and
owner, and the time of the last pressure shed. With a compile-ahead pool
(``compile_ahead``, ``tenancy/compile_ahead.py``) an admitted job's builds
start at once: a task exposing ``compile_ahead(topology)`` hands the pool
its ``(key, thunk)`` pairs.

A cancel of an admitted job is journaled when it is asked for (a
``job_state`` record of the job's current state with ``cancel_requested``
set, which the JAX fold reads as the state it already had), and a restart
evicts such a job as "cancelled" without rebuilding it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import timeit
from typing import Any, Dict, List, Optional

from saturn_tpu_torch import analysis
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.executor.orchestrator import _handle_topology_change, fold_realized_feedback
from saturn_tpu_torch.service.admission import (ADMIT, DEFER, REVISIT_DEFRAG,
                                                AdmissionController, compute_weight)
from saturn_tpu_torch.service.queue import TERMINAL_STATES, JobRecord, JobState, SubmissionQueue
from saturn_tpu_torch.solver import anytime, milp
from saturn_tpu_torch.utils import checkpoint as ckpt_mod
from saturn_tpu_torch.utils import metrics

logger = logging.getLogger("saturn_tpu_torch")


def _estimate_chip_seconds(task, batches: int) -> float:
    """Chip-seconds for ``batches`` realized iterations at the task's
    cheapest feasible point, ``per_batch_time * size``: a billing floor of
    the job's own, from the per-batch time (stable over the run; the
    remaining ``runtime`` decays to zero at completion)."""
    feas = task.feasible_strategies()
    if not feas or batches <= 0:
        return 0.0
    rates = [s.per_batch_time * g for g, s in feas.items() if (s.per_batch_time or 0.0) > 0.0]
    if not rates:
        return 0.0
    return batches * min(rates)


class SaturnService:
    """Long-running scheduler over one slice topology.

    ``start()`` runs the loop on a daemon thread; submit through a
    :class:`~saturn_tpu_torch.service.client.ServiceClient` (or ``queue``);
    ``stop()`` drains the live work and exits (``stop(abort=True)`` evicts
    it). ``topology=None`` takes every card (``SliceTopology()``, which
    raises without CUDA); a CPU ``SliceTopology`` runs on the CPU.

    With ``durability_dir`` every submission, lifecycle edge, admission,
    plan and realized batch is journaled there; a service built again on
    the same directory with a ``task_provider`` (``spec -> task``) replays
    it and resumes every live job. ``crash_barrier`` (a
    ``CrashInjector.barrier``, for tests) threads the kill points into the
    journal and the loop. ``compile_ahead`` (a ``CompileAheadPool``) takes
    an admitted job's builds; the service journals into it where it has no
    journal of its own, and closes it at ``stop()``."""

    def __init__(
        self,
        topology: Optional[SliceTopology] = None,
        interval: float = 1.0,
        threshold: float = 0.0,
        solver_time_limit: Optional[float] = None,
        metrics_path: Optional[str] = None,
        technique_names: Optional[List[str]] = None,
        profile_cache: Any = None,
        prune: bool = True,
        parallel_trials: Optional[int] = None,
        health_monitor=None,
        fault_injector=None,
        recovery_policy: str = "pause-resolve-resume",
        replan_degrade_factor: float = 2.0,
        pressure_policy: str = "evict-lowest-priority",
        durability_dir: Optional[str] = None,
        task_provider=None,
        crash_barrier=None,
        health_guardian=None,
        tenancy=None,
        compile_ahead=None,
        poll_s: float = 0.05,
        log: bool = False,
    ):
        if log:
            logging.basicConfig(level=logging.INFO)
        self.topology = topology if topology is not None else SliceTopology()
        self._base_topo = self.topology
        self.interval = interval
        self.threshold = threshold
        self.solver_time_limit = (solver_time_limit if solver_time_limit is not None
                                  else interval / 2)
        self.metrics_path = metrics_path
        self.poll_s = poll_s
        self.pressure_policy = pressure_policy

        self.queue = SubmissionQueue()
        self.admission = AdmissionController(
            self.topology, self.queue, technique_names=technique_names,
            profile_cache=profile_cache, prune=prune, parallel_trials=parallel_trials)

        if fault_injector is None:
            from saturn_tpu_torch.resilience.faults import FaultInjector

            fault_injector = FaultInjector.from_env()
        if fault_injector is not None and health_monitor is None:
            from saturn_tpu_torch.resilience.health import FleetHealthMonitor

            health_monitor = FleetHealthMonitor.for_topology(self.topology)
        self.health = health_monitor
        self.faults = fault_injector
        self.replanner = None
        if self.health is not None:
            from saturn_tpu_torch.resilience.replan import ElasticReplanner

            self.replanner = ElasticReplanner(policy=recovery_policy,
                                              degrade_factor=replan_degrade_factor)

        self._stop = threading.Event()
        self._abort = threading.Event()
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

        # Durability: open (and recover) the journal, replay it into the
        # queue, warm-start the first re-solve from the last committed plan.
        # ``killed`` is set only by the crash harness's simulated kill.
        self.journal = None
        self.task_provider = task_provider
        self.killed = False
        self._recovered_plan: Optional[milp.Plan] = None
        self._recovered_health: Optional[tuple] = None
        #: dedup_key -> job_id from the journal: the gateway's idempotency
        #: table starts from it, so a retry across a restart maps to the
        #: original admission
        self.recovered_dedup: Dict[str, str] = {}
        #: the highest journaled ``gateway_lease`` epoch and its owner: a
        #: restarted replica set seeds its ``ReplicaLease`` from them, so a
        #: fenced epoch is never issued again
        self.recovered_lease_epoch = 0
        self.recovered_lease_owner: Optional[str] = None
        #: ``time.monotonic()`` of the last admission-pressure eviction: the
        #: gateway shrinks its inflight window while it is recent
        self.last_pressure_shed: Optional[float] = None
        #: the TenantLedger shared by admission and the shedder, wired before
        #: recovery so that replayed ``tenant_charge`` records re-seat it
        self.tenancy = tenancy
        self.admission.tenancy = tenancy
        #: the CompileAheadPool fed at ADMIT, or None
        self.compile_ahead = compile_ahead
        # grow events, backlog drains and defrag waves; built before recovery
        # (which seeds its wave sequence), the journal attached after
        from saturn_tpu_torch.resilience.grow import GrowCoordinator

        self.grow = GrowCoordinator(journal=None)
        #: task name -> last published checkpoint path (the publish hook of
        #: ``_run``, seeded from the journal on recovery)
        self._last_ckpt: Dict[str, str] = {}
        if durability_dir is not None:
            self._recover_from(durability_dir, crash_barrier)
        elif crash_barrier is not None:
            raise ValueError("crash_barrier requires durability_dir")
        self.grow.journal = self.journal
        #: the committed plan, mirrored from the loop for the occupancy gate
        self._plan: Optional[milp.Plan] = None

        # the training-health guardian: on by default, off with False, or a
        # caller's configured TrainingGuardian
        self.guardian = None
        if health_guardian is not False:
            from saturn_tpu_torch.health import TrainingGuardian

            g = health_guardian
            if g is None:
                g = TrainingGuardian(journal=self.journal)
            elif g.journal is None and self.journal is not None:
                g.journal = self.journal
            self.guardian = g
            if self._recovered_health is not None:
                quarantined, detached, live_tasks = self._recovered_health
                g.restore(quarantined, detached, live_tasks)
        self._recovered_health = None

    def _recover_from(self, durability_dir: str, crash_barrier) -> None:
        """Open the journal (its torn tail rolled back to the durable cut),
        rebuild the job registry from the committed records and reconcile
        the journaled checkpoints with the disk. A live job's realized count
        follows its verified checkpoint (``recovery.follow_checkpoints``)."""
        from saturn_tpu_torch.durability import journal as jmod
        from saturn_tpu_torch.durability import recovery as rmod

        self.journal = jmod.Journal(durability_dir, barrier=crash_barrier)
        self.queue.observer = self._observe_job
        self.admission.journal = self.journal
        if self.tenancy is not None and self.tenancy.journal is None:
            self.tenancy.journal = self.journal
        if self.compile_ahead is not None and getattr(self.compile_ahead, "journal",
                                                      None) is None:
            self.compile_ahead.journal = self.journal
        state = rmod.replay_service_state(durability_dir)
        self.recovered_dedup = dict(state.dedup)
        self.recovered_lease_epoch = state.lease_epoch
        self.recovered_lease_owner = state.lease_owner
        if self.tenancy is not None and state.tenant_charges:
            self.tenancy.restore(state.tenant_charges)  # replaces, never adds
        sound: Dict[str, Optional[str]] = {}
        if state.checkpoints:
            sound = rmod.reconcile_checkpoints(state.checkpoints)
            for name, path in sound.items():
                if path is not None:
                    self._last_ckpt[name] = path
        # wave ids embed (interval, seq) and the interval restarts from zero
        self.grow.seed_wave_seq(state.defrag_waves)
        resume, rollback = state.resolve_pending_migrations()
        for rec in resume:
            self.journal.log("migration_done", wave=rec.get("wave", ""),
                             task=rec.get("task", ""), recovered=True)
            logger.info("recovery: defrag move %s/%s resumed (checkpoint published after "
                        "intent)", rec.get("wave"), rec.get("task"))
        for rec in rollback:
            self.journal.log("migration_rollback", wave=rec.get("wave", ""),
                             task=rec.get("task", ""), cause="recovery", recovered=True)
            logger.info("recovery: defrag move %s/%s rolled back (no published checkpoint "
                        "after intent)", rec.get("wave"), rec.get("task"))
        if state.jobs:
            rmod.follow_checkpoints(state, sound, self.journal)
            restored = rmod.build_restore_records(state, self.task_provider)
            for rec in restored:
                self.queue.restore(rec)
                j = state.jobs.get(rec.job_id)
                if j is not None and not j.terminal and rec.state in TERMINAL_STATES:
                    # every iteration realized, the DONE verdict lost; or a
                    # journaled cancel that no boundary swept
                    self._observe_job("state", rec)
            if state.quarantined or state.detached:
                self._recovered_health = (state.quarantined, state.detached,
                                          [r.task for r in restored
                                           if r.state is JobState.QUEUED])
            logger.info("recovery: restored %d job(s) from %s (%d live)", len(restored),
                        durability_dir, len(state.live_jobs()))
        if state.plan is not None:
            try:
                self._recovered_plan = milp.Plan.from_json(state.plan)
            except (KeyError, TypeError, ValueError):
                logger.exception("recovery: last committed plan unusable — first re-solve "
                                 "starts cold")
            else:
                # a replayed plan the verifier rejects never warm-starts
                report = analysis.verify_plan(self._recovered_plan, subject="journal-replay")
                if not report.ok:
                    codes = sorted({d.code for d in report.errors})
                    self._recovered_plan = None
                    logger.warning("recovery: replayed plan fails static verification (%s) — "
                                   "quarantined; first re-solve starts cold", codes)
                    self.journal.log("plan_quarantine", source="journal-replay", codes=codes)
        self.journal.log("recovery", incarnation=state.incarnations + 1,
                         replayed_seq=state.last_seq, replayed_records=state.n_records,
                         live_jobs=len(state.live_jobs()))

    def _observe_job(self, event: str, rec: JobRecord) -> None:
        """The queue's observer, into the journal (under the queue lock).
        A submission and a cancel request commit at once (``submit()`` or
        ``cancel()`` returning is the durable ack); lifecycle edges ride the
        next group commit, except terminal states, which commit."""
        jnl = self.journal
        if jnl is None:
            return
        if event == "submitted":
            jnl.log("job_submitted", job=rec.job_id, task=rec.name,
                    priority=rec.request.priority, deadline_s=rec.request.deadline_s,
                    max_retries=rec.request.max_retries,
                    total_batches=getattr(rec.task, "total_batches", None),
                    spec=rec.request.spec, dedup_key=rec.request.dedup_key,
                    tenant=rec.request.tenant)
        elif event == "recovered":
            jnl.append("job_recovered", job=rec.job_id, task=rec.name, requeues=rec.requeues)
        elif event == "cancel_requested":
            # the job's state unchanged (the JAX fold reads nothing new), the
            # request durable before cancel() returns
            jnl.log("job_state", job=rec.job_id, state=rec.state.value, attempts=rec.attempts,
                    requeues=rec.requeues, error=rec.error, cancel_requested=True)
        elif event == "state":
            jnl.append("job_state", job=rec.job_id, state=rec.state.value,
                       attempts=rec.attempts, requeues=rec.requeues, error=rec.error)
            if rec.state in TERMINAL_STATES:
                jnl.commit()

    # -------------------------------------------------------------- control
    def start(self) -> "SaturnService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._run_guarded, name="saturn-service",
                                        daemon=True)
        self._thread.start()
        # the loop sets its metrics scope first: a submit ahead of it would
        # lose its job_submitted event
        self._ready.wait(timeout=10.0)
        if self._error is not None:
            raise RuntimeError("service failed to start") from self._error
        return self

    def stop(self, abort: bool = False, timeout: Optional[float] = None) -> None:
        """Stop the loop: live jobs (and what is queued) run to completion
        first; ``abort=True`` evicts them at the next interval boundary.
        An exception of the loop is raised here (a simulated kill is not)."""
        if abort:
            self._abort.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self.compile_ahead is not None and not self.killed:
            self.compile_ahead.close()
        if self._error is not None and not self.killed:
            raise RuntimeError("service loop crashed") from self._error

    def _run_guarded(self) -> None:
        from saturn_tpu_torch.resilience.crash import SimulatedKill

        try:
            self._run()
        except SimulatedKill as e:
            # a SIGKILL runs no handler: no job is failed, nothing is
            # flushed or closed; the next incarnation recovers
            self.killed = True
            self._error = e
            self._ready.set()
            logger.warning("service loop killed by crash harness: %s", e)
        except BaseException as e:  # raised again by stop()
            self._error = e
            self._ready.set()
            logger.exception("service loop crashed")
            for rec in self.queue.jobs():  # unblock every client wait()
                if rec.state not in TERMINAL_STATES:
                    try:
                        self.queue.mark(rec, JobState.FAILED, error=f"service crashed: {e!r}")
                    except RuntimeError:
                        pass

    # ----------------------------------------------------------------- loop
    def _run(self) -> None:
        plan: Optional[milp.Plan] = self._recovered_plan
        self._recovered_plan = None
        jobs: Dict[str, JobRecord] = {}  # task name -> live admitted record
        jnl = self.journal
        hook = None
        if jnl is not None:
            def hook(task_name, path):  # every publication, from the writer's thread
                jnl.append("ckpt_published", task=task_name, path=path)
                self._last_ckpt[task_name] = path

            ckpt_mod.add_publish_hook(hook)
        try:
            self._run_loop(self.topology, self.solver_time_limit, plan, jobs, 0)
        finally:
            if hook is not None:
                ckpt_mod.remove_publish_hook(hook)

    def _run_loop(self, topo, tlimit, plan, jobs, interval_index) -> None:
        jnl = self.journal
        guardian = self.guardian
        self._plan = plan
        # an arrival whose memory cannot fit around running tasks' pinned
        # live state DEFERs (revisit "defrag") instead of admitting into an OOM
        self.admission.occupancy_gate = self.grow.occupancy_gate(
            lambda: [r.task for r in jobs.values()], lambda: self._plan)

        with metrics.scoped(self.metrics_path):
            self._ready.set()
            while True:
                if self._stop.is_set():
                    if self._abort.is_set():
                        for rec in list(jobs.values()):
                            self._evict(jobs, rec, "service aborted")
                        for rec in self.queue.drain():
                            self.admission.deferred.pop(rec.job_id, None)
                            self.queue.mark(rec, JobState.EVICTED, error="service aborted")
                            metrics.event("job_evicted", job=rec.job_id, task=rec.name,
                                          reason="service aborted")
                    if not jobs and self.queue.depth() == 0:
                        break
                elif not jobs and self.queue.depth() == 0:
                    self.queue.wait_for_arrival(timeout=self.poll_s)  # idle
                    continue

                # 1. health poll / topology change
                grew = False
                if self.health is not None:
                    if self.faults is not None:
                        self.faults.apply_due(interval_index, self.health)
                    change = self.health.poll()
                    if change is not None and change.kind in ("shrink", "grow"):
                        evicted_names: dict = {}
                        tasks = [r.task for r in jobs.values()]
                        tasks, topo, plan = _handle_topology_change(
                            tasks, self._base_topo, self.health, self.replanner, change, plan,
                            tlimit, evicted_names)
                        self._plan = plan
                        for name in evicted_names:
                            rec = jobs.pop(name, None)
                            if rec is not None:
                                self.queue.mark(rec, JobState.EVICTED, error=evicted_names[name])
                                metrics.event("job_evicted", job=rec.job_id, task=name,
                                              reason="topology-change")
                        if jnl is not None:
                            jnl.append("topology_change", **change.to_fields())
                        if change.kind == "grow":
                            # end the guardian's backoffs so parked work
                            # re-admits this interval
                            grew = True
                            self.grow.note_grow(change, interval_index, guardian=guardian,
                                                n_deferred=len(self.admission.deferred),
                                                capacity=topo.capacity)
                    elif change is not None:  # degrade: advisory
                        metrics.event("topology_change", **change.to_fields())

                # 2. drain arrivals through admission
                deferred_before = set(self.admission.deferred)
                newly_admitted = self._drain_arrivals(jobs, topo, interval_index, guardian)

                # 2b. a defrag wave for work deferred on pinned memory
                if self.grow.defrag_due(interval_index, grew):
                    wave_id = self._maybe_defrag_wave(jobs, topo, plan, interval_index)
                    if wave_id is not None:
                        newly_admitted.extend(
                            self._drain_arrivals(jobs, topo, interval_index, guardian))
                drained = sorted(deferred_before & {r.job_id for r in newly_admitted})
                if drained:
                    self.grow.note_drained(drained, interval_index,
                                           trigger="grow" if grew else "interval")

                # 3. cancel sweep over admitted jobs
                for rec in list(jobs.values()):
                    if rec.cancel_requested:
                        self._evict(jobs, rec, "cancelled")

                # 4. admission pressure: shed low-priority work when the
                #    greedy projection blows the tightest deadline
                self._shed_pressure(jobs, topo, plan)

                if not jobs:
                    plan = None
                    self._plan = None
                    metrics.event("queue_depth", depth=self.queue.depth(),
                                  live=self.queue.live(), active=0)
                    interval_index += 1
                    if self.queue.depth():
                        time.sleep(self.poll_s)  # only deferred work: no spinning
                    continue

                # 5. incremental re-solve from the live plan, weighted by
                #    priority and deadline urgency (recomputed every cycle)
                tasks = [r.task for r in jobs.values()]
                weights = {r.name: self._weight(r) for r in jobs.values()}
                t_solve = timeit.default_timer()
                candidate = anytime.anytime_resolve(
                    tasks, topo, plan, self.interval, self.threshold, deadline=tlimit,
                    weights=weights,
                    coschedule_exclude=(guardian.detached_names()
                                        if guardian is not None else None),
                    source="service")
                # the adoption gate: a rejected candidate is quarantined and
                # the last verified plan (the journal's warm start) runs on
                try:
                    analysis.verify_or_raise(candidate, topology=topo, tasks=tasks,
                                             source="service-re-solve")
                except analysis.PlanVerificationError as e:
                    codes = sorted({d.code for d in e.report.errors})
                    logger.error("re-solve plan quarantined (%s): %s", codes, e)
                    metrics.event("plan_quarantine", source="service-re-solve", codes=codes)
                    if jnl is not None:
                        jnl.log("plan_quarantine", interval=interval_index,
                                source="service-re-solve", codes=codes)
                    if plan is None:
                        raise  # no verified plan to fall back on
                else:
                    plan = candidate
                self._plan = plan
                metrics.event("solve", makespan_s=plan.makespan, n_tasks=len(tasks),
                              solve_s=round(timeit.default_timer() - t_solve, 6))
                if jnl is not None:
                    # the recovery warm start: a kill mid-interval restarts here
                    jnl.append("plan_commit", interval=interval_index, makespan=plan.makespan,
                               plan=plan.to_json())
                    jnl.commit()
                for rec in newly_admitted:
                    if rec.name not in jobs:
                        continue  # evicted by the cancel sweep or the shedder
                    a = plan.assignments.get(rec.name)
                    self.queue.mark(rec, JobState.SCHEDULED)
                    metrics.event("job_scheduled", job=rec.job_id, task=rec.name,
                                  start_s=a.start if a else None,
                                  size=a.apportionment if a else None,
                                  weight=round(rec.weight, 6))

                # 6. forecast and run one interval
                run_tasks, batches, completed = engine.forecast(tasks, self.interval, plan)
                errors: dict = {}
                if run_tasks:
                    errors = engine.execute(
                        run_tasks, batches, self.interval, plan, topo, failure_policy="drop",
                        guardian=guardian, on_task_done=self._make_on_done(jobs),
                        health=self.health, faults=self.faults, interval_index=interval_index,
                        on_task_start=self._make_on_start(jobs))
                    if guardian is not None:
                        for t in run_tasks:
                            if t.name not in errors:
                                guardian.note_success(t.name)
                    if jnl is not None:
                        # work ran, its task_progress not yet durable
                        jnl.barrier("mid-interval", interval=interval_index)
                else:
                    # every start lies past this interval: the re-solve slides it
                    time.sleep(min(self.poll_s, self.interval))

                # 7. estimate feedback (EWMA fold, profile-cache write-back)
                for name, (old, new) in sorted(fold_realized_feedback(run_tasks).items()):
                    metrics.event("estimate_update", task=name, profiled_s=round(old, 6),
                                  updated_s=round(new, 6))

                from saturn_tpu_torch.resilience.faults import PreemptedError

                preempted = {n: e for n, e in errors.items() if isinstance(e, PreemptedError)}
                failed = {n: e for n, e in errors.items() if n not in preempted}

                # 8. preemptions requeue through the queue (no retry used;
                #    re-admission is warm)
                for name, err in sorted(preempted.items()):
                    rec = jobs.pop(name)
                    self._release(rec.task, compiled=False)
                    engine.rollback_forecast(rec.task, batches.get(name, 0))
                    metrics.event("task_preempted", task=name, error=repr(err))
                    self.queue.requeue(rec)
                completed = [t for t in completed if t.name not in preempted]

                # 8b. health faults: the guardian's budget, not max_retries
                health_errs: Dict[str, BaseException] = {}
                if guardian is not None:
                    health_errs = {n: e for n, e in failed.items() if guardian.owns(e)}
                    failed = {n: e for n, e in failed.items() if n not in health_errs}
                group_of = plan.coschedule_group_of() if health_errs else {}
                for name, err in sorted(health_errs.items()):
                    rec = jobs.pop(name)
                    self._release(rec.task, compiled=False)
                    engine.rollback_forecast(rec.task, batches.get(name, 0))
                    decision = guardian.on_fault(rec.task, err, interval_index,
                                                 in_group=name in group_of)
                    if jnl is not None:
                        jnl.barrier("post-rollback", task=name, interval=interval_index)
                    if decision.action == "retry":
                        metrics.event("task_health_retry", task=name, cause=decision.cause,
                                      attempt=decision.attempt,
                                      cooldown_intervals=decision.cooldown)
                        self.queue.requeue(rec)
                    else:
                        self._release(rec.task, compiled=True)
                        self.queue.mark(rec, JobState.FAILED, error=repr(err))
                        metrics.event("task_failed", task=name, error=repr(err))
                        metrics.event("job_failed", job=rec.job_id, task=name, error=repr(err))
                completed = [t for t in completed if t.name not in health_errs]

                # 9. other failures: retry within the job's budget, else FAILED
                for name, err in sorted(failed.items()):
                    rec = jobs[name]
                    rec.attempts += 1
                    self._release(rec.task, compiled=False)
                    if rec.attempts <= rec.request.max_retries:
                        engine.rollback_forecast(rec.task, batches.get(name, 0))
                        metrics.event("task_retry", task=name, attempt=rec.attempts,
                                      error=repr(err))
                    else:
                        jobs.pop(name)
                        self._release(rec.task, compiled=True)
                        self.queue.mark(rec, JobState.FAILED, error=repr(err))
                        metrics.event("task_failed", task=name, error=repr(err))
                        metrics.event("job_failed", job=rec.job_id, task=name, error=repr(err))
                completed = [t for t in completed if t.name not in failed]

                # 10. retire completions
                for t in completed:
                    rec = jobs.pop(t.name)
                    self._release(rec.task, compiled=True)
                    self.queue.mark(rec, JobState.DONE)
                    metrics.event("task_completed", task=t.name)
                    metrics.event("job_completed", job=rec.job_id, task=t.name,
                                  wait_s=round((rec.started_at or rec.finished_at)
                                               - rec.submitted_at, 6),
                                  attempts=rec.attempts, requeues=rec.requeues)

                metrics.event("queue_depth", depth=self.queue.depth(), live=self.queue.live(),
                              active=len(jobs))
                if jnl is not None:
                    # one fsync makes the interval's progress, edges and
                    # publications durable together
                    jnl.commit()
                    jnl.barrier("post-checkpoint", interval=interval_index)
                metrics.flush()
                interval_index += 1

        # a clean shutdown only (a simulated kill unwinds past it): the
        # checkpoint writes in flight land, and publish, before the close
        ckpt_mod.flush()
        if jnl is not None:
            jnl.close()
        logger.info("service loop exited (%d jobs seen)", len(self.queue.jobs()))

    # --------------------------------------------------------------- helpers
    def _drain_arrivals(self, jobs: Dict[str, JobRecord], topo, interval_index: int,
                        guardian) -> List[JobRecord]:
        """One admission pass over the queue (step 2; again after a defrag
        wave, so that an unblocked gang admits in the same interval)."""
        newly_admitted: List[JobRecord] = []
        # a deferred job that left the queue terminally gets no later verdict
        for job_id in list(self.admission.deferred):
            try:
                if self.queue.get(job_id).state in TERMINAL_STATES:
                    self.admission.deferred.pop(job_id, None)
            except KeyError:
                self.admission.deferred.pop(job_id, None)
        self.admission.begin_pass()
        for rec in self.queue.drain():
            if rec.cancel_requested:
                self.admission.deferred.pop(rec.job_id, None)
                self.queue.mark(rec, JobState.EVICTED, error="cancelled")
                metrics.event("job_evicted", job=rec.job_id, task=rec.name, reason="cancelled")
                continue
            if guardian is not None and guardian.benched(rec.name, interval_index):
                self.queue.requeue(rec)  # still cooling down after a fault
                continue
            dec = self.admission.admit(rec, topo)
            if dec.action == ADMIT:
                jobs[rec.name] = rec
                newly_admitted.append(rec)
                self._prewarm_admitted(rec, topo)
            elif dec.action == DEFER:
                self.queue.requeue(rec)
            else:  # REJECT
                self.queue.mark(rec, JobState.FAILED, error=dec.reason)
        return newly_admitted

    def _prewarm_admitted(self, rec: JobRecord, topo) -> None:
        """Compile-ahead: once admission has picked the job's strategies,
        hand its builds to the background pool, so that its first dispatch
        finds them loaded. Duck-typed: a task exposing
        ``compile_ahead(topology)`` yields ``(key, thunk)`` pairs; a task
        without the hook, or a hook that raises, costs nothing."""
        pool = self.compile_ahead
        if pool is None:
            return
        hook = getattr(rec.task, "compile_ahead", None)
        if hook is None:
            return
        try:
            pairs = hook(topo) or ()
        except Exception as e:
            logger.debug("compile-ahead hook failed for %s: %r", rec.job_id, e)
            return
        for key, thunk in pairs:
            pool.prewarm(key, thunk, job=rec.job_id, tenant=rec.tenant)

    def _maybe_defrag_wave(self, jobs: Dict[str, JobRecord], topo, plan,
                           interval_index: int) -> Optional[str]:
        """Plan and run one defrag wave over the DEFER backlog blocked on
        pinned memory; the wave id, or None when nothing was blocked or no
        compaction helps."""
        blocked_ids = sorted(job_id for job_id, e in self.admission.deferred.items()
                             if e.get("revisit_on") == REVISIT_DEFRAG)
        if not blocked_ids or plan is None:
            return None
        blocked_tasks = []
        for job_id in blocked_ids:
            try:
                blocked_tasks.append(self.queue.get(job_id).task)
            except KeyError:
                continue
        if not blocked_tasks:
            return None
        live_tasks = [r.task for r in jobs.values()]
        wave = self.grow.plan_wave(blocked_tasks, live_tasks, topo, plan)
        if wave.empty:
            return None
        jnl = self.journal

        def publish(task) -> bool:
            # the victim's checkpoint is current at every interval boundary:
            # journal its publication again, durably, after the move's intent
            path = self._last_ckpt.get(task.name)
            if path is None or not os.path.exists(path):
                return False  # nothing durable to resume from: roll back
            if jnl is not None:
                jnl.log("ckpt_published", task=task.name, path=path, wave_republish=True)
            return True

        return self.grow.execute_wave(wave, {t.name: t for t in live_tasks}, interval_index,
                                      publish_fn=publish)

    def _weight(self, rec: JobRecord) -> float:
        slack = rec.deadline_at - time.monotonic() if rec.deadline_at is not None else None
        feas = rec.task.feasible_strategies()
        est = min((s.runtime for s in feas.values()), default=0.0)
        rec.weight = compute_weight(rec.request.priority, slack, est)
        return rec.weight

    def _make_on_start(self, jobs: Dict[str, JobRecord]):
        def on_start(name: str) -> None:
            rec = jobs.get(name)
            if rec is not None and rec.state is JobState.SCHEDULED:
                self.queue.mark(rec, JobState.RUNNING)

        return on_start

    def _make_on_done(self, jobs: Dict[str, JobRecord]):
        """A launcher's completion hook: a buffered ``task_progress`` record
        (durable at the interval-end commit; recovery subtracts it from the
        budget, so a batch is journaled only once it ran), and the tenant's
        chip-seconds where a ledger is wired."""
        jnl = self.journal
        tenancy = self.tenancy
        if jnl is None and tenancy is None:
            return None
        recs = dict(jobs)

        def on_done(name: str, batches: int) -> None:
            if batches <= 0:
                return
            rec = recs.get(name)
            if jnl is not None:
                jnl.append("task_progress", task=name,
                           job=rec.job_id if rec is not None else None, batches=int(batches))
            if tenancy is not None and rec is not None:
                chip_s = _estimate_chip_seconds(rec.task, batches)
                if chip_s > 0.0:
                    tenancy.charge(rec.tenant, chip_s, job=rec.job_id)

        return on_done

    def _evict(self, jobs: Dict[str, JobRecord], rec: JobRecord, reason: str) -> None:
        jobs.pop(rec.name, None)
        self._release(rec.task, compiled=True)
        self.admission.deferred.pop(rec.job_id, None)
        self.queue.mark(rec, JobState.EVICTED, error=reason)
        metrics.event("job_evicted", job=rec.job_id, task=rec.name, reason=reason)

    @staticmethod
    def _release(task, compiled: bool) -> None:
        """Give back a task's live device state, and with ``compiled`` its
        bundles, CUDA graphs and graph pools."""
        release = getattr(task, "release_live_state", None)
        if release is not None:
            release()
        if compiled:
            release_c = getattr(task, "release_compiled", None)
            if release_c is not None:
                release_c()

    def _shed_pressure(self, jobs: Dict[str, JobRecord], topo,
                       plan: Optional[milp.Plan]) -> None:
        shed, proj, limit = project_pressure_shed(jobs, topo, plan, self.pressure_policy,
                                                  tenancy=self.tenancy)
        if shed:
            # the gateway's backpressure follows: it shrinks its window
            self.last_pressure_shed = time.monotonic()
        for rec in shed:
            logger.warning("admission pressure: evicting %s (projection %.2fs > slack %.2fs)",
                           rec.job_id, proj, limit)
            if self.tenancy is not None:
                self.tenancy.note_shed(rec.tenant)
            self._evict(jobs, rec, "admission-pressure")


def project_pressure_shed(jobs: Dict[str, JobRecord], topo, plan: Optional[milp.Plan],
                          pressure_policy: str, tenancy=None):
    """Deadline-protecting load shed: when the greedy (pessimistic)
    projection of the live jobs' makespan overshoots the tightest remaining
    deadline, the replanner's ``pressure_policy`` picks the casualties
    (the lowest ``hints['priority']`` first). With a ``TenantLedger`` the
    candidates are the jobs of over-fair-share tenants first. Returns
    ``(records to evict, projected makespan, slack limit)``; the caller
    evicts."""
    with_deadline = [r for r in jobs.values() if r.deadline_at is not None]
    if not with_deadline or len(jobs) <= 1:
        return [], 0.0, 0.0
    limit = max(min(r.deadline_at for r in with_deadline) - time.monotonic(), 1e-3)
    tasks = [r.task for r in jobs.values()]
    if len(tasks) > 300:
        proj = anytime.fast_greedy_plan(tasks, topo).makespan
    else:
        proj = milp.greedy_plan(tasks, topo).makespan
    if proj <= limit:
        return [], proj, limit
    from saturn_tpu_torch.resilience.replan import ReplanContext, get_policy

    ctx = ReplanContext(topology=topo, previous_plan=plan, previous_makespan=limit,
                        change_kind="admission-pressure", degrade_factor=1.0)
    candidates = tasks
    if tenancy is not None:
        live: Dict[str, int] = {}
        for r in jobs.values():
            live[r.tenant] = live.get(r.tenant, 0) + 1
        over = tenancy.over_share_tenants(live)
        over_tasks = [r.task for r in jobs.values() if r.tenant in over]
        if over_tasks and len(over_tasks) < len(tasks):
            candidates = over_tasks
    _keep, shed = get_policy(pressure_policy)(candidates, ctx)
    by_name = {r.name: r for r in jobs.values()}
    return [by_name[t.name] for t in shed if t.name in by_name], proj, limit
