"""Orchestrator: solve, run an interval, fold in what it measured, re-solve.

Counterpart of ``saturn_tpu/executor/orchestrator.py``. Each round:
forecast the interval from the plan, run it (``engine.execute``, which also
advances each task's data cursor), fold each task's realized per-batch time
into its strategies, and re-solve, adopting the fresh plan only past
``threshold`` (``milp.resolve``); until no batches remain.

The JAX package runs a training-health guardian by default and offers fault
injection, elastic recovery, a durable journal, metrics and traces; here
those arguments raise when set, and there is no guardian (``ROADMAP.md``).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.executor import engine
from saturn_tpu_torch.solver import milp

logger = logging.getLogger("saturn_tpu_torch")


def _refuse(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"orchestrate({name}=...): not carried by the PyTorch port yet "
                "(see ROADMAP.md)"
            )


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
    ``solver_time_limit`` (default ``interval / 2``). ``failure_policy``
    must be ``"raise"``: a task failure ends the run after the interval's
    barrier. ``max_task_retries``, ``recovery_policy`` and
    ``replan_degrade_factor`` only act under the policies and the health
    monitor that this slice does not carry, as in the JAX package.

    Returns ``{"completed": [names], "failed": {}}``.
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    if failure_policy != "raise":
        raise NotImplementedError(
            f"failure_policy={failure_policy!r}: drop / retry are later items "
            "of the PyTorch port"
        )
    _refuse(metrics_path=metrics_path, trace_dir=trace_dir,
            fault_injector=fault_injector, health_monitor=health_monitor,
            resume_dir=resume_dir, health_guardian=health_guardian,
            crash_barrier=crash_barrier)
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

    task_list = list(task_list)
    completed_names: List[str] = []
    plan = milp.resolve(task_list, topo, None, interval, threshold, time_limit=tlimit)
    logger.info("initial plan: makespan %.1fs, %d tasks", plan.makespan, len(task_list))
    while task_list:
        run_tasks, batches, completed = engine.forecast(task_list, interval, plan)
        if run_tasks:
            engine.execute(run_tasks, batches, interval, plan, topo)
        else:
            logger.info("idle interval: no task starts within %.1fs", interval)
        for t in run_tasks:
            upd = t.apply_realized_feedback()
            if upd is not None and abs(upd[1] - upd[0]) > 0.25 * max(upd[0], 1e-9):
                logger.info("estimate correction for %s: %.4fs -> %.4fs per batch",
                            t.name, upd[0], upd[1])
        completed_names += [t.name for t in completed]
        task_list = [t for t in task_list if t not in completed]
        if task_list:
            plan = milp.resolve(task_list, topo, plan, interval, threshold,
                                time_limit=tlimit)
            logger.info("re-solve: makespan %.1fs", plan.makespan)
    logger.info("orchestration complete (%d completed)", len(completed_names))
    return {"completed": completed_names, "failed": {}}
