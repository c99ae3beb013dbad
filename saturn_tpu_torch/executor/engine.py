"""Execution engine: forecast + dependency-ordered launch for one interval.

Counterpart of ``saturn_tpu/executor/engine.py``: each task gets a launcher
thread that waits for the tasks its block depends on (the plan's ordering
edges), runs its selected technique on its assigned block, advances its data
cursor and signals completion. The plan's launch invariants (no race on a
device, no dependency cycle) are checked before any launch. With a health
guardian every launcher runs under a watchdog deadline. Each technique's
``execute`` picks its own window size K (the JAX package's engine passes
one, from ``pick_window``). The JAX package's fault hooks, co-scheduled and
fused launchers are later items.
"""

from __future__ import annotations

import logging
import threading
import timeit
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch.analysis.plan_verifier import check_launch_invariants
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.health.guardian import HungDispatchError
from saturn_tpu_torch.solver.milp import Plan
from saturn_tpu_torch.utils import metrics

logger = logging.getLogger("saturn_tpu_torch")


def forecast(
    task_list: Sequence,
    interval: float,
    plan: Plan,
) -> Tuple[List, Dict[str, int], List]:
    """Which tasks run this interval, for how many batches, and which finish.

    A task runs if its planned start falls inside the interval; its batch
    budget is the rest of the interval over its per-batch time (at least 1),
    capped at its remaining batches. Remaining ``total_batches`` and every
    feasible strategy's remaining ``runtime`` are decremented by the work
    about to run."""
    relevant, batches, completed = [], {}, []
    for task in task_list:
        a = plan.assignments.get(task.name)
        if a is None or a.start >= interval:
            continue
        strat = task.strategies[a.apportionment]
        pbt = max(strat.per_batch_time, 1e-9)
        n = min(max(1, int((interval - a.start) / pbt)), task.total_batches)
        if n <= 0:
            continue
        relevant.append(task)
        batches[task.name] = n
        task.total_batches -= n
        for s in task.strategies.values():
            if s.feasible:
                s.runtime = max(0.0, s.per_batch_time * task.total_batches)
        if task.total_batches <= 0:
            completed.append(task)
    return relevant, batches, completed


def rollback_forecast(task, n_batches: int) -> None:
    """Undo :func:`forecast`'s accounting for a task whose interval did not
    complete (a failure, a health fault): the batches go back on the budget
    and every feasible strategy's remaining runtime is re-derived. An
    interval is all-or-nothing, so the whole deduction comes back; the
    checkpoint is what the next attempt resumes from."""
    task.total_batches += n_batches
    for s in task.strategies.values():
        if s.feasible:
            s.runtime = s.per_batch_time * task.total_batches


def _join_with_watchdog(watch, t0, hung, hung_lock, errors, events) -> None:
    """Join launcher threads under their watchdog deadlines.

    ``watch`` is ``[(thread, task, deadline_s | None)]``. A thread still
    alive past its deadline is ABANDONED: its task gets a
    ``HungDispatchError`` recorded on its behalf (the thread is wedged in a
    launch that cannot be cancelled), the task's ``_abandoned`` event is set
    so that a late finish publishes no state, its completion event fires so
    dependents unblock, and the engine stops joining the thread."""
    pending = list(watch)
    while pending:
        for entry in list(pending):
            th, task, deadline = entry
            th.join(timeout=0.02)
            if not th.is_alive():
                pending.remove(entry)
                continue
            if deadline is None:
                continue
            elapsed = timeit.default_timer() - t0
            if elapsed > deadline:
                logger.error("watchdog: abandoning launcher %s after %.1fs "
                             "(deadline %.1fs) — task %s marked hung",
                             th.name, elapsed, deadline, task.name)
                with hung_lock:
                    hung.add(task.name)
                    errors[task.name] = HungDispatchError(task.name, deadline, elapsed)
                task._abandoned.set()
                events[task.name].set()
                pending.remove(entry)


def execute(
    run_tasks: Sequence,
    batches: Dict[str, int],
    interval: float,
    plan: Plan,
    topology: SliceTopology,
    failure_policy: str = "raise",
    guardian=None,
    on_task_done=None,
) -> Dict[str, BaseException]:
    """Run one interval: every task on its block after the tasks it depends
    on, then a barrier. Returns ``{task name: error}`` of the tasks that
    failed.

    The plan's launch invariants are checked first
    (``check_launch_invariants``). ``failure_policy="raise"`` re-raises the
    first failure after the barrier, once every other task has finished its
    interval; ``"drop"`` returns the failures for the orchestrator to handle.
    With a ``guardian`` (``health.TrainingGuardian``) each launcher is
    joined under a deadline of ``floor + factor x`` its profiled window time
    (batches x per-batch time); past it the launch is abandoned
    (``HungDispatchError``, see ``_join_with_watchdog``), and training
    faults (``guardian.owns``) are returned even under ``"raise"``: they
    belong to the guardian's recovery policy. ``on_task_done(name, n)`` is
    called from a task's launcher once its interval ran to its end and its
    data cursor advanced (the durability journal's ``task_progress``): a
    batch count it is given really ran."""
    check_launch_invariants([t.name for t in run_tasks], plan)
    events = {t.name: threading.Event() for t in run_tasks}
    running = {t.name for t in run_tasks}
    errors: Dict[str, BaseException] = {}
    # tasks whose launcher the watchdog abandoned: a late wake records no
    # error and commits nothing
    hung: set = set()
    hung_lock = threading.Lock()

    def launcher(task, tid: int):
        try:
            for dep in plan.dependencies.get(task.name, ()):
                if dep in running:
                    events[dep].wait()
            a = plan.assignments[task.name]
            task.select_strategy(a.apportionment)
            n = batches[task.name]
            logger.info("interval: launching %s on block [%d:%d] for %d batches",
                        task.name, a.block.offset, a.block.end, n)
            task.selected_strategy.executor.execute(
                task, topology.block_devices(a.block), tid, override_batch_count=n
            )
            with hung_lock:
                if task.name in hung:
                    return
                task.reconfigure(n)
            if on_task_done is not None:
                on_task_done(task.name, n)
        except Exception as e:  # surfaced after the barrier
            logger.exception("task %s failed during interval", task.name)
            # drop the failed launch's locals (its device tensors) now; the
            # traceback keeps its text
            traceback.clear_frames(e.__traceback__)
            with hung_lock:
                if task.name not in hung:
                    errors[task.name] = e
        finally:
            events[task.name].set()

    def expected_s(t) -> float:
        strat = t.strategies.get(plan.assignments[t.name].apportionment)
        return batches.get(t.name, 0) * max(float(getattr(strat, "per_batch_time", 0.0)), 0.0)

    use_watchdog = guardian is not None and guardian.watchdog_enabled
    watch: List[Tuple[threading.Thread, object, Optional[float]]] = []
    for i, t in enumerate(run_tasks):
        t._abandoned = threading.Event()
        th = threading.Thread(target=launcher, args=(t, i), daemon=True,
                              name=f"launch-{t.name}")
        watch.append((th, t, guardian.window_deadline_s(expected_s(t))
                      if use_watchdog else None))
    t0 = timeit.default_timer()
    for th, _, _ in watch:
        th.start()
    if use_watchdog:
        _join_with_watchdog(watch, t0, hung, hung_lock, errors, events)
    else:
        for th, _, _ in watch:
            th.join()
    elapsed = timeit.default_timer() - t0
    with hung_lock:
        errors = dict(errors)
    metrics.event("interval", elapsed_s=elapsed, planned_s=interval,
                  n_tasks=len(run_tasks), failed=sorted(errors))
    metrics.flush()
    if failure_policy == "raise":
        real = {n: e for n, e in errors.items()
                if guardian is None or not guardian.owns(e)}
        if real:
            name, err = next(iter(real.items()))
            raise RuntimeError(f"interval execution failed for task {name}") from err
    logger.info("interval finished in %.1fs of %.1fs planned", elapsed, interval)
    return errors
