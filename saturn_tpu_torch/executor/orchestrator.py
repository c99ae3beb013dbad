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

Unlike the JAX package, the re-solve runs after the interval, not beside
it, with the interval's feedback and failures already folded in. The JAX
package's fault injection, elastic recovery, durable journal and traces
are later items; those arguments raise when set, and so does
``SATURN_TPU_FAULTS``, from which the JAX package builds a fault injector
when none is passed.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

from saturn_tpu_torch import analysis
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.health.guardian import TrainingGuardian
from saturn_tpu_torch.solver import anytime
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics
from saturn_tpu_torch.utils import profile_cache as pcache

logger = logging.getLogger("saturn_tpu_torch")


def _refuse(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"orchestrate({name}=...): not carried by the PyTorch port yet "
                "(see ROADMAP.md)"
            )


def _gate_resolved_plan(candidate, previous, topo, tasks, interval: float):
    """The verifier's gate on a re-solved plan. A candidate that fails
    ``verify_or_raise`` is quarantined (a ``plan_quarantine`` event) and the
    previous plan slid down by ``interval`` runs instead; only when that
    plan cannot cover the tasks (a task it never placed) does the failure
    propagate."""
    try:
        analysis.verify_or_raise(candidate, topology=topo, tasks=tasks, source="re-solve")
        return candidate
    except analysis.PlanVerificationError as e:
        codes = sorted({d.code for d in e.report.errors})
        logger.error("re-solve plan quarantined (%s): %s", codes, e)
        metrics.event("plan_quarantine", source="re-solve", codes=codes)
        names = {t.name for t in tasks}
        if previous is None or names - set(previous.assignments):
            raise
        return anytime.slide(previous, names, interval)


def _persist_realized(task) -> None:
    """Write the task's freshly measured per-batch time to the profile-cache
    entry its strategy came from, so the next sweep starts from realized
    numbers (the JAX package writes to the default cache)."""
    strat = task.last_feedback_strategy
    if strat is None or not strat.cache_key or not strat.feasible:
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
    Returns ``{name: (old, new)}`` for the tasks that produced an update."""
    updates = {}
    for t in run_tasks:
        upd = t.apply_realized_feedback()
        if upd is not None:
            updates[t.name] = upd
            _persist_realized(t)
    return updates


def _finish(t) -> None:
    """Give back a task's device state, bundles and CUDA graphs."""
    t.release_live_state()
    t.release_compiled()


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
) -> dict:
    """Run every task to completion, minimizing batch makespan.

    ``interval``: seconds of execution per scheduling round. ``threshold``:
    makespan improvement needed to adopt a re-solved plan. The solver gets
    ``solver_time_limit`` (default ``interval / 2``). ``failure_policy``:
    ``"raise"`` ends the run after the interval's barrier, ``"drop"`` evicts
    the failed task and keeps the rest running, ``"retry"`` gives it
    ``max_task_retries`` more intervals, each resuming from its last
    checkpoint, then evicts it. ``metrics_path`` appends JSONL events
    (``utils/metrics.py``).

    A ``TrainingGuardian`` runs by default (``health_guardian=False``
    disables it; a caller's guardian is used as it is): the sentinel
    screens every interval's losses, the engine's watchdog deadlines every
    launcher, and a training fault rolls the task back to its last
    checkpoint and retries it after a backoff (quarantining batches that
    fault again, evicting past the guardian's budget), apart from
    ``max_task_retries``. ``recovery_policy`` and ``replan_degrade_factor``
    only act under the health monitor, a later item, as in the JAX package.

    Returns ``{"completed": [names], "failed": {name: error string}}``.
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    if failure_policy not in ("raise", "drop", "retry"):
        raise ValueError(
            f"failure_policy must be 'raise', 'drop' or 'retry', got {failure_policy!r}"
        )
    _refuse(trace_dir=trace_dir, fault_injector=fault_injector,
            health_monitor=health_monitor, resume_dir=resume_dir,
            crash_barrier=crash_barrier)
    # where no injector is given, the JAX package builds one from this variable
    if os.environ.get("SATURN_TPU_FAULTS", "").strip():
        raise NotImplementedError(
            "orchestrate: SATURN_TPU_FAULTS is set, and fault injection is not "
            "carried by the PyTorch port yet (see ROADMAP.md, queue 1 item 5)"
        )
    topo = topology if topology is not None else SliceTopology()
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
    guardian = None
    if health_guardian is not False:
        guardian = health_guardian if health_guardian is not None else TrainingGuardian()
    try:
        with metrics.scoped(metrics_path):
            return _orchestrate_loop(list(task_list), topo, interval, threshold, tlimit,
                                     failure_policy, max_task_retries, guardian)
    finally:
        # every exit path waits for the checkpoint writes in flight, so a
        # caller that catches a failure still finds the landed checkpoints
        ckpt.flush()


def _orchestrate_loop(task_list, topo, interval, threshold, tlimit, failure_policy,
                      max_task_retries, guardian) -> dict:
    completed_names: List[str] = []
    failed: Dict[str, str] = {}
    retries: Dict[str, int] = {}
    plan = anytime.anytime_resolve(task_list, topo, None, interval, deadline=tlimit,
                                   source="orchestrator-initial")
    analysis.verify_or_raise(plan, topology=topo, tasks=task_list, source="fresh-solve")
    logger.info("initial plan: makespan %.1fs, %d tasks", plan.makespan, len(task_list))
    metrics.event("solve", makespan_s=plan.makespan, n_tasks=len(task_list))

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
        run_tasks, batches, completed = engine.forecast(task_list, interval, plan)
        remaining = [t for t in task_list if t not in completed]
        errors: Dict[str, BaseException] = {}
        if run_tasks:
            errors = engine.execute(
                run_tasks, batches, interval, plan, topo,
                failure_policy="raise" if failure_policy == "raise" else "drop",
                guardian=guardian,
            )
            if guardian is not None:
                for t in run_tasks:
                    if t.name not in errors:
                        guardian.note_success(t.name)
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
            if guardian is not None and guardian.owns(err):
                decision = guardian.on_fault(t, err, interval_index)
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
            metrics.event("task_failed", task=name, error=repr(err))
            logger.error("evicting task %s: %r", name, err)
            _finish(t)

        for t in completed:
            completed_names.append(t.name)
            metrics.event("task_completed", task=t.name)
            _finish(t)
        task_list = remaining
        if task_list:
            plan = _gate_resolved_plan(
                anytime.anytime_resolve(task_list, topo, plan, interval, threshold,
                                        deadline=tlimit, source="orchestrator"),
                plan, topo, task_list, interval,
            )
            logger.info("re-solve: makespan %.1fs", plan.makespan)
            metrics.event("solve", makespan_s=plan.makespan, n_tasks=len(task_list))
        metrics.flush()
        interval_index += 1
    logger.info("orchestration complete (%d completed, %d failed)",
                len(completed_names), len(failed))
    return {"completed": completed_names, "failed": failed}
