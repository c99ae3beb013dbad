"""Execution engine: forecast + dependency-ordered launch for one interval.

Counterpart of ``saturn_tpu/executor/engine.py``: each task gets a launcher
thread that waits for the tasks its block depends on (the plan's ordering
edges), runs its selected technique on its assigned block, advances its data
cursor and signals completion. The plan's blocks keep concurrently running
tasks on disjoint devices. Each technique's ``execute`` picks its own
window size K (the JAX package's engine passes one, from ``pick_window``).
The JAX package's watchdog, fault hooks, co-scheduled and fused launchers
are later items.
"""

from __future__ import annotations

import logging
import threading
import timeit
from typing import Dict, List, Sequence, Tuple

from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.solver.milp import Plan

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


def execute(
    run_tasks: Sequence,
    batches: Dict[str, int],
    interval: float,
    plan: Plan,
    topology: SliceTopology,
) -> None:
    """Run one interval: every task on its block after the tasks it depends
    on, then a barrier. A task failure is re-raised after the barrier, once
    every other task has finished its interval (the JAX package's
    ``failure_policy="raise"``; its other policies are later items)."""
    events = {t.name: threading.Event() for t in run_tasks}
    running = {t.name for t in run_tasks}
    errors: Dict[str, BaseException] = {}
    lock = threading.Lock()

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
            task.reconfigure(n)
        except Exception as e:  # surfaced after the barrier
            with lock:
                errors[task.name] = e
            logger.exception("task %s failed during interval", task.name)
        finally:
            events[task.name].set()

    threads = [
        threading.Thread(target=launcher, args=(t, i), daemon=True,
                         name=f"launch-{t.name}")
        for i, t in enumerate(run_tasks)
    ]
    t0 = timeit.default_timer()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    elapsed = timeit.default_timer() - t0
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"interval execution failed for task {name}") from err
    logger.info("interval finished in %.1fs of %.1fs planned", elapsed, interval)
