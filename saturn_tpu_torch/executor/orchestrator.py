"""Orchestrator: solve, run an interval, handle what failed, re-solve.

Counterpart of ``saturn_tpu/executor/orchestrator.py``. The first plan and
every re-solve come from the anytime tier ladder (``solver/anytime.py``)
under a deadline of ``solver_time_limit`` (default ``interval / 2``), and
pass the static plan verifier before they are adopted: a re-solved plan
that fails it is quarantined and the previous plan, slid down by one
interval, runs in its place. Each round: forecast the interval from the
plan, run it (``engine.execute``), fold each task's realized per-batch time
into its strategies and its profile-cache entry, hand training faults to
the health guardian (on by default) and other failures to
``failure_policy``, release finished tasks, and re-solve; until no batches
remain. A task that completes gives back its live train state, bundles and
CUDA graphs, and the run ends once every checkpoint write has reached the
disk.

With ``resume_dir`` the run is journaled there (``durability/``): every
adopted plan, each task's batches after an interval that ran to its end,
completions, failures, checkpoint publications and the guardian's
transitions, group-committed at the end of each interval. A later
``orchestrate`` on the same directory replays the journal and runs only
what is left (``_fold_batch_recovery``).

Every solve gets the fusion groups of ``parallel.fused.fusion_candidates``
and a residency gate from the static screen (``_static_fusion_gate``); the
plan's fusion groups run as stacked programs and its co-schedule groups
interleaved (``engine.execute``). A task the guardian detaches stays out of
both at later solves.

With a health monitor (``health_monitor``, or one built for a
``fault_injector``, or for the injector that ``SATURN_TPU_FAULTS`` gives
when none is passed) the loop is elastic: each interval starts with a
health poll, and a shrink or grow re-plans over the surviving devices
(``resilience.ElasticReplanner`` under ``recovery_policy``); a task
preempted during an interval is requeued without using a retry.

Unlike the JAX package, the re-solve runs after the interval, not beside
it, with the interval's feedback and failures already folded in.
"""

from __future__ import annotations

import logging
import os
import timeit
from typing import Dict, List, Optional

from saturn_tpu_torch import analysis
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.durability import journal as jmod
from saturn_tpu_torch.durability import recovery as rmod
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.health.guardian import TrainingGuardian
from saturn_tpu_torch.resilience.crash import SimulatedKill
from saturn_tpu_torch.resilience.faults import FaultInjector, PreemptedError
from saturn_tpu_torch.resilience.health import FleetHealthMonitor
from saturn_tpu_torch.resilience.replan import ElasticReplanner, get_policy
from saturn_tpu_torch.solver import anytime, milp
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics, trace
from saturn_tpu_torch.utils import profile_cache as pcache

logger = logging.getLogger("saturn_tpu_torch")


def _gate_resolved_plan(candidate, previous, topo, tasks, interval: float, journal,
                        interval_index: int):
    """The verifier's gate on a re-solved plan. A candidate that fails
    ``verify_or_raise`` is quarantined (a ``plan_quarantine`` event and
    journal record) and the previous plan slid down by ``interval`` runs
    instead; only when that plan cannot cover the tasks (a task it never
    placed) does the failure propagate."""
    try:
        analysis.verify_or_raise(candidate, topology=topo, tasks=tasks, source="re-solve")
        return candidate
    except analysis.PlanVerificationError as e:
        codes = sorted({d.code for d in e.report.errors})
        logger.error("re-solve plan quarantined (%s): %s", codes, e)
        metrics.event("plan_quarantine", source="re-solve", codes=codes)
        if journal is not None:
            journal.append("plan_quarantine", interval=interval_index + 1,
                           source="re-solve", codes=codes)
        names = {t.name for t in tasks}
        if previous is None or names - set(previous.assignments):
            raise
        return anytime.slide(previous, names, interval)


def _fusion_proposals(tasks) -> Optional[List[List[str]]]:
    """Candidate fusion groups for a solve (same-fingerprint task names,
    ``parallel.fused.fusion_candidates``). Proposing is free: only a group
    whose members all carry a measured ``fused_per_batch_time`` can win the
    pricing (``milp.fusion_priced_groups``)."""
    from saturn_tpu_torch.parallel import fused

    return fused.fusion_candidates(tasks) or None


def _static_fusion_gate(topo):
    """The solver's ``fusion_fits(member_tasks, size, n_members)`` from the
    port's static screen (the JAX package asks memlens): a stack of N keeps
    N x the fp32 parameters, gradients and optimizer moments
    (``SPMDTechnique.state_bytes``) plus N x the activations of the solo
    trial (its measured peak less its state) on the device; over
    ``MEMORY_HEADROOM`` of the card is False (a veto, before any build).
    None where it cannot tell (no card size, a strategy without a measured
    peak whose state alone fits), never a veto. A member whose strategy
    keeps its state in host memory (offload) never fuses: False."""
    from saturn_tpu_torch.parallel.spmd_base import MEMORY_HEADROOM
    from saturn_tpu_torch.utils import timing

    def fits(member_tasks, size, n_members):
        rep = member_tasks[0]
        strat = rep.feasible_strategies().get(size)
        tech = getattr(strat, "executor", None)
        if tech is None or not hasattr(tech, "state_bytes"):
            return None
        if getattr(tech, "host_state", False):
            return False
        blocks = topo.blocks(size)
        limit = timing.device_memory_bytes(topo.block_devices(blocks[0])[0]) if blocks else 0
        if limit <= 0:
            return None
        state = tech.state_bytes(rep, dict(strat.params or {}))
        if n_members * state > MEMORY_HEADROOM * limit:
            return False
        if strat.peak_bytes is None:
            return None
        act = max(float(strat.peak_bytes) - state, 0.0)
        return n_members * (state + act) <= MEMORY_HEADROOM * limit

    return fits


def _handle_topology_change(task_list, base_topo, health, replanner, change, plan,
                            tlimit, failed):
    """The elastic hook before an interval: re-plan over the monitor's
    surviving devices, evict what cannot run there, verify the new plan
    against the new topology (``migration-replan``: there is no covering
    plan to fall back on, so a failure propagates) before any task moves,
    then release each moved task's live state so that its next interval
    restores its checkpoint on its new block. Returns the tasks, the
    topology and the plan to go on with."""
    t_detect = timeit.default_timer()
    metrics.event("topology_change", **change.to_fields())
    logger.warning("topology change (%s): lost=%s gained=%s stragglers=%s — replanning",
                   change.kind, change.lost, change.gained, change.stragglers)
    result = replanner.replan(task_list, base_topo, health.alive_indices(), change,
                              previous_plan=plan, time_limit=tlimit)
    evicted = set(result.evicted)
    kept = [t for t in task_list if t.name not in evicted]
    analysis.verify_or_raise(result.plan, topology=result.topology, tasks=kept,
                             source="migration-replan")
    for t in task_list:
        if t.name in evicted:
            failed[t.name] = f"evicted on topology change ({change.kind})"
            metrics.event("task_failed", task=t.name, error=failed[t.name])
            _finish(t)
    by_name = {t.name: t for t in kept}
    for name, d in sorted(result.migrations.items()):
        if d["moved"] and name in by_name:
            # restores its checkpoint on the new block; a duck-typed task
            # (the twin's) holds no live state
            release = getattr(by_name[name], "release_live_state", None)
            if release is not None:
                release()
            metrics.event("migration", task=name, moved_from=d["from"], moved_to=d["to"])
    metrics.event("recovery", policy=replanner.policy,
                  replan_latency_s=timeit.default_timer() - t_detect,
                  capacity=result.topology.capacity, n_tasks=len(kept))
    return kept, result.topology, result.plan


def _in_group(plan, name: str) -> bool:
    return any(name in g for g in (plan.coschedule or []) + (plan.fused or []))


def _persist_realized(task) -> None:
    """Write the task's freshly measured per-batch time to the profile-cache
    entry its strategy came from, so the next sweep starts from realized
    numbers (the JAX package writes to the default cache). An interpolated
    strategy is written only once its time was realized
    (``Task.apply_realized_feedback`` clears the flag)."""
    strat = getattr(task, "last_feedback_strategy", None)
    if (strat is None or not strat.cache_key or not strat.feasible
            or strat.interpolated):
        return
    wrote = pcache.ProfileCache(strat.cache_dir).note_realized(
        strat.cache_key, strat.per_batch_time, strat.params,
        technique=getattr(strat.executor, "name", "unknown"), size=strat.apportionment,
    )
    if wrote:
        metrics.event("profile_cache", op="realized_writeback", task=task.name,
                      size=strat.apportionment, per_batch_s=strat.per_batch_time)


def fold_realized_feedback(run_tasks) -> Dict[str, tuple]:
    """Fold each executed task's realized per-batch time into its strategy
    (EWMA, ``Task.apply_realized_feedback``) and its profile-cache entry.
    Returns ``{name: (old, new)}`` for the tasks that produced an update.
    Shared by the interval loop and the online service; a duck-typed task
    without the method has nothing to fold, as in the JAX package."""
    updates = {}
    for t in run_tasks:
        apply_fb = getattr(t, "apply_realized_feedback", None)
        upd = apply_fb() if apply_fb is not None else None
        if upd is not None:
            updates[t.name] = upd
            _persist_realized(t)
    return updates


def _finish(t) -> None:
    """Give back a task's device state, bundles and CUDA graphs (a
    duck-typed task without them has nothing to give back)."""
    for name in ("release_live_state", "release_compiled"):
        release = getattr(t, name, None)
        if release is not None:
            release()


def _audit_replayed_plan(journal, plan_json: dict) -> None:
    """The journal-replay audit: the run re-solves on resume all the same,
    but a committed plan the static verifier rejects means the dead
    incarnation launched, or was about to launch, a broken schedule: put a
    ``plan_quarantine`` record on the journal."""
    try:
        report = analysis.verify_plan(milp.Plan.from_json(plan_json),
                                      subject="journal-replay")
    except (KeyError, TypeError, ValueError) as e:
        logger.warning("replayed plan_commit undecodable: %s", e)
        return
    if not report.ok:
        codes = sorted({d.code for d in report.errors})
        logger.warning("the journal's committed plan fails static verification (%s): "
                       "quarantined; resuming from a fresh solve", codes)
        journal.log("plan_quarantine", source="journal-replay", codes=codes)


def _checkpoint_step(task, sound: set) -> Optional[int]:
    """The step of the task's checkpoint once its in-flight write landed, or
    None without one. A file that recovery has not verified yet (its
    ``ckpt_published`` record was lost) is verified here; one that fails
    goes to a sidecar and counts as none."""
    path = task.ckpt_path
    if not ckpt.exists(path):
        return None
    if os.path.abspath(path) not in sound and not ckpt.verify(path):
        sidecar = ckpt.quarantine(path)
        logger.warning("resume: checkpoint %s of %s failed verification; quarantined to "
                       "%s", path, task.name, sidecar)
        return None
    return ckpt.saved_step(path)


def _fold_batch_recovery(task_list, state, completed, failed, sound, journal) -> List:
    """Apply the replayed journal to a fresh task list: journaled-terminal
    tasks never run again, and what each other task realized comes off its
    budget (strategy runtimes re-derived from per-batch times).

    What a task realized is its checkpoint's step where it has a sound
    checkpoint, since that step also decides where its data cursor resumes
    (``parallel/spmd_base.py``); the journal's progress otherwise. A
    checkpoint can run ahead of the journal: each interval ends with its
    checkpoint write, and a kill between that write and the interval's
    commit loses the interval's ``task_progress``. The JAX package takes the
    journal's count for the budget and the checkpoint's step for the
    cursor, so such a task trains the lost interval's batches twice over
    its total (``ROADMAP.md``, queue 3). Here the difference is journaled as
    one more ``task_progress`` record, so that the journal counts every
    batch of the checkpoint exactly once; it is negative where the
    checkpoint is behind (a process killed before its last write landed),
    since those batches run again."""
    out = []
    for t in task_list:
        if t.name in state.completed:
            completed.append(t.name)
            logger.info("resume: %s already completed durably; skipping", t.name)
            continue
        if t.name in state.failed:
            failed[t.name] = state.failed[t.name]
            logger.info("resume: %s failed durably; not retrying", t.name)
            continue
        realized = journaled = state.progress.get(t.name, 0)
        step = _checkpoint_step(t, sound)
        if step is not None:
            realized = step
            if step != journaled:
                journal.append("task_progress", task=t.name, batches=step - journaled)
                logger.info("resume: %s's checkpoint is at step %d, the journal at %d",
                            t.name, step, journaled)
        if realized > 0:
            t.total_batches = max(0, t.total_batches - realized)
            for s in t.strategies.values():
                if s.feasible:
                    s.runtime = s.per_batch_time * t.total_batches
            logger.info("resume: %s realized %d batch(es); %d remain", t.name, realized,
                        t.total_batches)
            if t.total_batches <= 0:
                completed.append(t.name)
                continue
        out.append(t)
    return out


def _recover(journal, task_list, completed, failed):
    """Replay the journal just opened on ``journal.root`` (its torn tail
    already quarantined): audit the committed plan, verify the checkpoints
    of the tasks still to run, fold the state into ``task_list`` and
    journal a ``recovery`` record. Returns the tasks to run and the
    replayed state."""
    state = rmod.replay_batch_state(journal.root)
    if state.plan:
        _audit_replayed_plan(journal, state.plan)
    live = {t.name for t in task_list} - set(state.completed) - set(state.failed)
    sound = set(rmod.reconcile_checkpoints(
        {n: p for n, p in state.checkpoints.items() if n in live}).values()) - {None}
    task_list = _fold_batch_recovery(task_list, state, completed, failed, sound, journal)
    journal.log("recovery", replayed_seq=state.last_seq, replayed_records=state.n_records,
                completed=len(completed), remaining=len(task_list))
    return task_list, state


def _shutdown(journal, hook, unwinding: bool) -> None:
    """Every exit but a simulated kill: wait for the checkpoint writes in
    flight (their ``ckpt_published`` records still reach the journal), then
    unhook and close the journal, which commits what is buffered. On an
    error unwind a failed write is logged, not raised over the error."""
    try:
        ckpt.flush()
    except Exception:
        if not unwinding:
            raise
        logger.exception("a checkpoint write failed during the error unwind")
    finally:
        if hook is not None:
            ckpt.remove_publish_hook(hook)
        if journal is not None:
            journal.close()


def orchestrate(
    task_list: List,
    log: bool = False,
    interval: float = 1000.0,
    topology: Optional[SliceTopology] = None,
    threshold: float = 0.0,
    solver_time_limit: Optional[float] = None,
    failure_policy: str = "raise",
    max_task_retries: int = 1,
    metrics_path: Optional[str] = None,
    trace_dir: Optional[str] = None,
    fault_injector=None,
    health_monitor=None,
    recovery_policy: str = "pause-resolve-resume",
    replan_degrade_factor: float = 2.0,
    resume_dir: Optional[str] = None,
    health_guardian=None,
    crash_barrier=None,
    fusion: bool = True,
) -> dict:
    """Run every task to completion, minimizing batch makespan.

    ``interval``: seconds of execution per scheduling round. ``threshold``:
    makespan improvement needed to adopt a re-solved plan. The solver gets
    ``solver_time_limit`` (default ``interval / 2``). ``failure_policy``:
    ``"raise"`` ends the run after the interval's barrier, ``"drop"`` evicts
    the failed task and keeps the rest running, ``"retry"`` gives it
    ``max_task_retries`` more intervals, each resuming from its last
    checkpoint, then evicts it. ``metrics_path`` appends JSONL events
    (``utils/metrics.py``); ``trace_dir`` records the run in a
    torch.profiler trace there (``utils/trace.py``).

    ``resume_dir`` is a write-ahead journal directory (``durability/``).
    Each interval's realized batches, the adopted plans, completions,
    failures, checkpoint publications and the guardian's transitions are
    group-committed there. Running ``orchestrate(resume_dir=...)`` again
    after a crash replays it (a torn tail is quarantined and the journal
    rolled back to its last durable cut): tasks the journal records as
    completed or failed do not run, and every other task runs only what it
    has not realized (its checkpoint's step, or without a checkpoint the
    journal's count). ``crash_barrier`` (a ``CrashInjector.barrier``, for
    tests) threads kill points into the journal and the loop; it needs
    ``resume_dir``.

    A ``TrainingGuardian`` runs by default (``health_guardian=False``
    disables it; a caller's guardian is used as it is): the sentinel
    screens every interval's losses, the engine's watchdog deadlines every
    launcher, and a training fault rolls the task back to its last
    checkpoint and retries it after a backoff (quarantining batches that
    fault again, evicting past the guardian's budget), apart from
    ``max_task_retries``. Its transitions are journaled under
    ``resume_dir``, and a resumed run re-applies the journaled quarantine
    skip-lists.

    Elasticity (``resilience/``): ``health_monitor`` (a
    ``FleetHealthMonitor``), or a ``fault_injector`` (a ``FaultInjector``;
    without one, ``SATURN_TPU_FAULTS`` gives it, as in the JAX package),
    turns the loop elastic. Each interval starts with a health poll; on a
    shrink or grow the ``ElasticReplanner`` builds the topology and plan of
    the surviving devices under ``recovery_policy`` (one of
    ``resilience.RECOVERY_POLICIES`` or a registered one; an unknown name
    raises, with or without a monitor) and ``replan_degrade_factor``. A
    device lost during an interval aborts the work not yet started and
    discards the runs on its block (``PreemptedError``); those tasks are
    requeued without using ``max_task_retries`` and resume from their
    checkpoints. A grow re-admits the tasks the guardian parked
    (``grow_event`` and ``backlog_drain`` journal records).

    ``fusion=False`` proposes no fusion groups to the solver (the JAX
    package always does).

    Returns ``{"completed": [names], "failed": {name: error string}}``.
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    if failure_policy not in ("raise", "drop", "retry"):
        raise ValueError(
            f"failure_policy must be 'raise', 'drop' or 'retry', got {failure_policy!r}"
        )
    get_policy(recovery_policy)
    if crash_barrier is not None and resume_dir is None:
        raise ValueError("crash_barrier requires resume_dir (it instruments the "
                         "durability journal)")
    topo = topology if topology is not None else SliceTopology()
    if fault_injector is None:
        fault_injector = FaultInjector.from_env()
    if fault_injector is not None and health_monitor is None:
        health_monitor = FleetHealthMonitor.for_topology(topo)
    replanner = None
    if health_monitor is not None:
        replanner = ElasticReplanner(policy=recovery_policy,
                                     degrade_factor=replan_degrade_factor)
    names = [t.name for t in task_list]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate task names {dupes}: give tasks unique names")
    for t in task_list:
        if not t.feasible_strategies():
            raise ValueError(
                f"task {t.name} has no profiled strategies — run search first"
            )
    tlimit = solver_time_limit if solver_time_limit is not None else interval / 2
    task_list = list(task_list)
    completed: List[str] = []
    failed: Dict[str, str] = {}
    journal = hook = None
    try:
        with metrics.scoped(metrics_path), trace.profile_trace(trace_dir):
            recovered = None
            if resume_dir is not None:
                journal = jmod.Journal(resume_dir, barrier=crash_barrier)
                task_list, recovered = _recover(journal, task_list, completed, failed)

                def hook(task_name, path):  # from the writer thread: the next commit
                    journal.append("ckpt_published", task=task_name, path=path)

                ckpt.add_publish_hook(hook)
            guardian = None
            if health_guardian is not False:
                guardian = (health_guardian if health_guardian is not None
                            else TrainingGuardian(journal=journal))
                if guardian.journal is None:
                    guardian.journal = journal
                if recovered is not None:
                    guardian.restore(recovered.quarantined, recovered.detached, task_list)
            out = _orchestrate_loop(task_list, topo, interval, threshold, tlimit,
                                    failure_policy, max_task_retries, guardian, journal,
                                    completed, failed, fusion, health_monitor,
                                    fault_injector, replanner)
    except SimulatedKill:
        # a SIGKILL runs no handler: no checkpoint flush, no journal commit
        # or close; what was buffered dies, and the next incarnation recovers
        if hook is not None:
            ckpt.remove_publish_hook(hook)
        raise
    except BaseException:
        _shutdown(journal, hook, unwinding=True)
        raise
    # every other exit waits for the checkpoint writes in flight, so a
    # caller (or a caller that catches a failure) finds them landed
    _shutdown(journal, hook, unwinding=False)
    return out


def _orchestrate_loop(task_list, topo, interval, threshold, tlimit, failure_policy,
                      max_task_retries, guardian, journal, completed_names, failed,
                      fusion=True, health=None, faults=None, replanner=None) -> dict:
    from saturn_tpu_torch.parallel import fused

    retries: Dict[str, int] = {}

    def group_args(tasks) -> dict:
        excluded = guardian.detached_names() if guardian is not None else None
        return {"coschedule_exclude": excluded,
                "fusion": _fusion_proposals(tasks) if fusion else None,
                "fusion_exclude": excluded, "fusion_fits": _static_fusion_gate(topo)}

    if not task_list:  # a resumed run whose journal holds every task terminal
        logger.info("orchestration complete (%d completed, %d failed)",
                    len(completed_names), len(failed))
        return {"completed": completed_names, "failed": failed}
    plan = anytime.anytime_resolve(task_list, topo, None, interval, deadline=tlimit,
                                   source="orchestrator-initial", **group_args(task_list))
    analysis.verify_or_raise(plan, topology=topo, tasks=task_list, source="fresh-solve")
    logger.info("initial plan: makespan %.1fs, %d tasks", plan.makespan, len(task_list))
    metrics.event("solve", makespan_s=plan.makespan, n_tasks=len(task_list))
    on_done = None
    if journal is not None:
        journal.append("plan_commit", interval=0, makespan=plan.makespan,
                       plan=plan.to_json())

        def on_done(name, n):  # from a launcher thread; durable at the interval's end
            if n > 0:
                journal.append("task_progress", task=name, batches=int(n))

    base_topo = topo  # the health monitor's indices are the starting topology's
    interval_index = 0
    # tasks the guardian parked for a backoff: out of the forecast and the
    # re-solve until their resume interval
    parked: List = []
    while task_list or parked:
        back = [t for t in parked if not guardian.benched(t.name, interval_index)]
        if back:
            parked = [t for t in parked if t not in back]
            task_list.extend(back)
            logger.info("guardian: backoff expired for %s — re-admitted",
                        sorted(t.name for t in back))
        if not task_list:
            interval_index += 1  # everyone is parked: let the backoff clock run
            continue
        if health is not None:
            # the elastic hook: this interval's scheduled faults, then at
            # most one aggregated change
            if faults is not None:
                faults.apply_due(interval_index, health)
            change = health.poll()
            if change is not None and change.kind in ("shrink", "grow"):
                if change.kind == "grow" and journal is not None:
                    journal.log("grow_event", interval=interval_index,
                                gained=list(change.gained), cause=change.cause,
                                n_parked=len(parked), capacity=base_topo.capacity)
                if change.kind == "grow" and parked:
                    # returned capacity runs parked work now: end the backoffs
                    # (streaks stay) and re-plan the parked tasks too
                    if guardian is not None:
                        guardian.unbench_all(cause="grow")
                    names_back = sorted(t.name for t in parked)
                    task_list.extend(parked)
                    parked = []
                    if journal is not None:
                        journal.log("backlog_drain", interval=interval_index,
                                    jobs=names_back, trigger="grow")
                    metrics.event("backlog_drain", interval=interval_index,
                                  jobs=names_back, trigger="grow")
                    logger.info("grow: re-admitted parked %s ahead of backoff", names_back)
                task_list, topo, plan = _handle_topology_change(
                    task_list, base_topo, health, replanner, change, plan, tlimit, failed)
                if not task_list:
                    break
            elif change is not None:  # degrade: advisory, no re-plan
                metrics.event("topology_change", **change.to_fields())
                logger.warning("degraded fleet: stragglers %s (policy %s keeps running)",
                               change.stragglers, replanner.policy)
        run_tasks, batches, completed = engine.forecast(task_list, interval, plan)
        remaining = [t for t in task_list if t not in completed]
        errors: Dict[str, BaseException] = {}
        if run_tasks:
            errors = engine.execute(
                run_tasks, batches, interval, plan, topo,
                failure_policy="raise" if failure_policy == "raise" else "drop",
                guardian=guardian, on_task_done=on_done, health=health, faults=faults,
                interval_index=interval_index,
            )
            if guardian is not None:
                for t in run_tasks:
                    if t.name not in errors:
                        guardian.note_success(t.name)
            if journal is not None:
                journal.barrier("mid-interval", interval=interval_index)
        else:
            logger.info("idle interval: no task starts within %.1fs", interval)

        for name, (old, new) in sorted(fold_realized_feedback(run_tasks).items()):
            metrics.event("estimate_update", task=name, profiled_s=round(old, 6),
                          updated_s=round(new, 6))
            if abs(new - old) > 0.25 * max(old, 1e-9):
                logger.info("estimate correction for %s: %.4fs -> %.4fs per batch",
                            name, old, new)

        by_name = {t.name: t for t in run_tasks}
        for name, err in sorted(errors.items()):
            t = by_name[name]
            t.release_live_state()  # the next attempt restores the checkpoint
            engine.rollback_forecast(t, batches.get(name, 0))
            remaining = [r for r in remaining if r is not t]
            completed = [c for c in completed if c is not t]
            if isinstance(err, PreemptedError):
                # the fleet's fault, not the task's: requeued without a
                # retry; the next poll re-plans and it resumes from its
                # checkpoint (its discarded run wrote none)
                remaining.append(t)
                metrics.event("task_preempted", task=name, error=repr(err))
                logger.warning("task %s preempted — requeued for replan: %r", name, err)
                continue
            if guardian is not None and guardian.owns(err):
                decision = guardian.on_fault(t, err, interval_index,
                                             in_group=_in_group(plan, name))
                if journal is not None:
                    # the quarantine record is durable already: a kill here
                    # must find it on replay
                    journal.barrier("post-rollback", task=name, interval=interval_index)
                if decision.action == "retry":
                    parked.append(t)
                    logger.warning("task %s health fault (%s, attempt %d) — rolled "
                                   "back, parked for %d interval(s)", name,
                                   decision.cause, decision.attempt, decision.cooldown)
                    continue
            else:
                retries[name] = retries.get(name, 0) + 1
                if failure_policy == "retry" and retries[name] <= max_task_retries:
                    remaining.append(t)
                    metrics.event("task_retry", task=name, attempt=retries[name],
                                  error=repr(err))
                    logger.warning("task %s failed (attempt %d/%d) — retrying next "
                                   "interval from its last checkpoint: %r", name,
                                   retries[name], max_task_retries + 1, err)
                    continue
            failed[name] = repr(err)
            if journal is not None:
                journal.append("task_failed", task=name, error=repr(err))
            metrics.event("task_failed", task=name, error=repr(err))
            logger.error("evicting task %s: %r", name, err)
            _finish(t)

        task_list = remaining
        if task_list:
            plan = _gate_resolved_plan(
                anytime.anytime_resolve(task_list, topo, plan, interval, threshold,
                                        deadline=tlimit, source="orchestrator",
                                        **group_args(task_list)),
                plan, topo, task_list, interval, journal, interval_index,
            )
            logger.info("re-solve: makespan %.1fs", plan.makespan)
            metrics.event("solve", makespan_s=plan.makespan, n_tasks=len(task_list))
            if journal is not None:
                journal.append("plan_commit", interval=interval_index + 1,
                               makespan=plan.makespan, plan=plan.to_json())
        for t in completed:
            completed_names.append(t.name)
            if journal is not None:
                journal.append("task_completed", task=t.name)
            metrics.event("task_completed", task=t.name)
            _finish(t)
        if journal is not None:
            # one group commit for the interval's progress, plan and verdicts
            journal.append("interval_commit", interval=interval_index)
            journal.commit()
        metrics.flush()
        interval_index += 1
    # the stacked programs' CUDA graphs and pools (their states are gone)
    fused.release_programs()
    logger.info("orchestration complete (%d completed, %d failed)",
                len(completed_names), len(failed))
    return {"completed": completed_names, "failed": failed}
