"""Execution engine: forecast + dependency-ordered launch for one interval.

Counterpart of ``saturn_tpu/executor/engine.py``: each task gets a launcher
thread that waits for the tasks its block depends on (the plan's ordering
edges), runs its selected technique on its assigned block, advances its data
cursor and signals completion. The plan's launch invariants (no race on a
device, no dependency cycle) are checked before any launch. With a health
guardian every launcher runs under a watchdog deadline. Each technique's
``execute`` picks its own window size K (the JAX package's engine passes
one, from ``pick_window``). A fusion group of the plan runs on one launcher
as one stacked program (``fused_launcher``), a co-schedule group on one
launcher that interleaves its members' dispatches (``group_launcher``), as
in the JAX package. The JAX package's fault hooks are later items.
"""

from __future__ import annotations

import logging
import threading
import time
import timeit
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch.analysis.plan_verifier import check_launch_invariants, coschedule_find
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


def _coschedule_groups(run_tasks, plan) -> List[List]:
    """The co-schedule groups launching this interval: lists of tasks (two
    running members at least), one shared launcher each. Callers pass
    ``run_tasks`` without the fusion groups' members (``_fused_groups``
    claims them first): the condensed union-find merges fusion groups too."""
    find = coschedule_find((t.name for t in run_tasks), plan)
    by_root: Dict[str, List] = {}
    for t in run_tasks:
        by_root.setdefault(find(t.name), []).append(t)
    return [g for g in by_root.values() if len(g) >= 2]


def _fused_groups(run_tasks, plan) -> List[List]:
    """The fusion groups launching this interval: lists of tasks (two
    running members at least, in the plan's order), one stacked program
    each. A group that shrank below two runs on the per-task path."""
    by_name = {t.name: t for t in run_tasks}
    out: List[List] = []
    claimed: set = set()
    for grp in getattr(plan, "fused", None) or []:
        members = [by_name[n] for n in grp if n in by_name and n not in claimed]
        if len(members) >= 2:
            out.append(members)
            claimed.update(t.name for t in members)
    return out


def _join_with_watchdog(watch, t0, hung, hung_lock, errors, events) -> None:
    """Join launcher threads under their watchdog deadlines.

    ``watch`` is ``[(thread, tasks, deadline_s | None)]``. A thread still
    alive past its deadline is ABANDONED: each of its tasks gets a
    ``HungDispatchError`` recorded on its behalf (the thread is wedged in a
    launch that cannot be cancelled), each task's ``_abandoned`` event is
    set so that a late finish publishes no state, their completion events
    fire so dependents unblock, and the engine stops joining the thread."""
    pending = list(watch)
    while pending:
        for entry in list(pending):
            th, tasks, deadline = entry
            th.join(timeout=0.02)
            if not th.is_alive():
                pending.remove(entry)
                continue
            if deadline is None:
                continue
            elapsed = timeit.default_timer() - t0
            if elapsed > deadline:
                logger.error("watchdog: abandoning launcher %s after %.1fs "
                             "(deadline %.1fs) — task(s) %s marked hung",
                             th.name, elapsed, deadline, [t.name for t in tasks])
                with hung_lock:
                    for task in tasks:
                        hung.add(task.name)
                        errors[task.name] = HungDispatchError(task.name, deadline, elapsed)
                for task in tasks:
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
    failed. The running members of a plan's fusion group (two or more) run
    on one ``fused_launcher``, those of a co-schedule group on one
    ``group_launcher``; a group's watchdog deadline covers its members'
    summed profiled work.

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

    def record_error(name: str, e: BaseException) -> None:
        with hung_lock:
            if name not in hung:
                errors.setdefault(name, e)

    def abandoned(name: str) -> bool:
        with hung_lock:
            return name in hung

    def group_launcher(members: List, tids: List[int]):
        """One launcher for a co-schedule group: round-robin the members'
        dispatch generators (``interval_dispatches(shared=True)``), one unit
        per visit; a member whose staged batch is not ready yields
        ``waiting`` and the next member dispatches instead. Once every
        member has enqueued its units, each is resumed past its ``drain``
        for its readback and checkpoint. A member's dispatch order, and so
        its losses and checkpoints, is its solo run's. Completion events
        fire at group end (the members share the block until the last one
        drains). The group's wall time is attributed to its members by
        profiled work share as their realized per-batch time; a member
        whose technique has no generator runs after, on this thread."""
        names = {t.name for t in members}
        active: List[Dict] = []
        t_group0 = timeit.default_timer()
        try:
            for t in members:
                for dep in plan.dependencies.get(t.name, ()):
                    if dep in running and dep not in names:
                        events[dep].wait()
            for t, tid in zip(members, tids):
                try:
                    a = plan.assignments[t.name]
                    t.select_strategy(a.apportionment)
                    tech = t.selected_strategy.executor
                    n = batches[t.name]
                    pbt = max(getattr(t.selected_strategy, "per_batch_time", 0.0), 1e-9)
                    inter = (getattr(tech, "supports_coschedule", False)
                             and hasattr(tech, "interval_dispatches"))
                    devices = topology.block_devices(a.block)
                    logger.info("interval: co-launching %s on block [%d:%d] for %d batches "
                                "(%s)", t.name, a.block.offset, a.block.end, n,
                                "interleaved" if inter else "sequential")
                    gen = (tech.interval_dispatches(t, devices, tid, override_batch_count=n,
                                                    shared=True) if inter else None)
                    active.append({"task": t, "tech": tech, "gen": gen, "tid": tid, "n": n,
                                   "pbt": pbt, "devices": devices, "per_batch": None,
                                   "interleaved": inter})
                except Exception as e:
                    logger.exception("task %s failed during interval", t.name)
                    record_error(t.name, e)
            pending = [m for m in active if m["gen"] is not None]
            drained: List[Dict] = []
            while pending:
                progressed = False
                for m in list(pending):
                    try:
                        tag, _ = next(m["gen"])
                    except StopIteration:
                        pending.remove(m)
                        m["gen"] = None
                        continue
                    except Exception as e:
                        logger.exception("task %s failed during interval", m["task"].name)
                        traceback.clear_frames(e.__traceback__)
                        record_error(m["task"].name, e)
                        pending.remove(m)
                        m["gen"] = None
                        continue
                    if tag == "dispatched":
                        progressed = True
                    elif tag == "drain":
                        pending.remove(m)
                        drained.append(m)
                        progressed = True
                if not progressed and pending:
                    time.sleep(0.0005)  # every member waits on its staging copy
            for m in drained:
                try:
                    for _ in m["gen"]:
                        pass
                except Exception as e:
                    logger.exception("task %s failed during interval", m["task"].name)
                    traceback.clear_frames(e.__traceback__)
                    record_error(m["task"].name, e)
                finally:
                    m["gen"] = None
            for m in active:
                if m["interleaved"] or m["task"].name in errors:
                    continue
                try:
                    t_solo = timeit.default_timer()
                    m["tech"].execute(m["task"], m["devices"], m["tid"],
                                      override_batch_count=m["n"])
                    m["per_batch"] = (timeit.default_timer() - t_solo) / max(m["n"], 1)
                except Exception as e:
                    logger.exception("task %s failed during interval", m["task"].name)
                    traceback.clear_frames(e.__traceback__)
                    record_error(m["task"].name, e)
            dt_group = timeit.default_timer() - t_group0
            ok = [m for m in drained if m["task"].name not in errors]
            denom = sum(m["n"] * m["pbt"] for m in ok)
            for m in ok:
                share = m["n"] * m["pbt"] / denom if denom > 0 else 1.0 / len(ok)
                m["per_batch"] = dt_group * share / max(m["n"], 1)
                m["task"].last_per_batch_s = m["per_batch"]
                m["task"].note_realized_per_batch(m["per_batch"])
            for m in active:
                name = m["task"].name
                if name in errors or m["per_batch"] is None:
                    continue
                with hung_lock:
                    if name in hung:
                        continue
                    m["task"].reconfigure(m["n"])
                if on_task_done is not None:
                    on_task_done(name, m["n"])
        except Exception as e:
            logger.exception("co-schedule group %s failed", sorted(names))
            for t in members:
                record_error(t.name, e)
        finally:
            for m in active:
                if m["gen"] is not None:
                    m["gen"].close()
            for t in members:
                events[t.name].set()

    def fused_launcher(members: List, tids: List[int]):
        """One launcher for a fusion group: one stacked program
        (``parallel.fused.run_fused_interval``). Healthy members commit as
        the solo launcher commits; the realized lockstep time is EWMA'd
        into each member's ``fused_per_batch_time``; a member whose budget
        exceeded the lockstep count gets its shortfall back
        (``rollback_forecast``); a member's sentinel fault surfaces as a
        solo fault; a detached member resumes solo on the same block for
        the rest of its budget within this interval (the stack checkpointed
        it at the detach point, so no step is lost or repeated)."""
        from saturn_tpu_torch.parallel import fused

        names = {t.name for t in members}
        try:
            for t in members:
                for dep in plan.dependencies.get(t.name, ()):
                    if dep in running and dep not in names:
                        events[dep].wait()
            a = plan.assignments[members[0].name]
            devices = topology.block_devices(a.block)
            for t in members:
                t.select_strategy(a.apportionment)
            counts = [batches[t.name] for t in members]
            logger.info("interval: fused-launching %s on block [%d:%d] (lockstep %d batches "
                        "x %d members)", sorted(names), a.block.offset, a.block.end,
                        min(counts), len(members))
            report = fused.run_fused_interval(members, devices, tids[0], batch_counts=counts)
            if any(abandoned(t.name) for t in members):
                logger.warning("fused group %s finished after the watchdog abandoned it; "
                               "discarding it", sorted(names))
                return
            detached = {t.name: s for t, s in report.detached}
            for t in members:
                mr = report.members.get(t.name)
                if mr is None:
                    continue
                try:
                    if mr.fault is not None:
                        raise mr.fault
                    budget = batches[t.name]
                    if t.name in detached:
                        remaining = max(0, budget - mr.steps)
                        if remaining > 0:
                            logger.info("interval: resuming unfused %s solo for %d "
                                        "remaining batches", t.name, remaining)
                            t.selected_strategy.executor.execute(
                                t, devices, tids[0], override_batch_count=remaining)
                            # the solo restore set the cursor to the detach point
                            t.reconfigure(remaining)
                        else:
                            t.reconfigure(mr.steps)
                        done = budget
                    else:
                        t.reconfigure(mr.steps)
                        if budget > mr.steps:
                            rollback_forecast(t, budget - mr.steps)
                        done = mr.steps
                    strat = t.selected_strategy
                    if report.per_step_s > 0:
                        old = strat.fused_per_batch_time
                        strat.fused_per_batch_time = (
                            report.per_step_s if old is None
                            else 0.7 * report.per_step_s + 0.3 * old)
                    t.last_per_batch_s = report.per_step_s
                    if on_task_done is not None:
                        on_task_done(t.name, done)
                except Exception as e:
                    if mr.fault is None:
                        logger.exception("task %s failed during interval", t.name)
                    traceback.clear_frames(e.__traceback__)
                    record_error(t.name, e)
        except Exception as e:
            logger.exception("fused group %s failed", sorted(names))
            traceback.clear_frames(e.__traceback__)
            for t in members:
                record_error(t.name, e)
        finally:
            for t in members:
                events[t.name].set()

    def expected_s(t) -> float:
        strat = t.strategies.get(plan.assignments[t.name].apportionment)
        return batches.get(t.name, 0) * max(float(getattr(strat, "per_batch_time", 0.0)), 0.0)

    fused_groups = _fused_groups(run_tasks, plan)
    fused_names = {t.name for g in fused_groups for t in g}
    co_groups = _coschedule_groups([t for t in run_tasks if t.name not in fused_names], plan)
    grouped = {t.name for g in co_groups for t in g} | fused_names
    tid_of = {t.name: i for i, t in enumerate(run_tasks)}
    use_watchdog = guardian is not None and guardian.watchdog_enabled
    watch: List[Tuple[threading.Thread, List, Optional[float]]] = []
    for t in run_tasks:
        t._abandoned = threading.Event()
    for i, t in enumerate(run_tasks):
        if t.name in grouped:
            continue
        th = threading.Thread(target=launcher, args=(t, i), daemon=True,
                              name=f"launch-{t.name}")
        watch.append((th, [t], guardian.window_deadline_s(expected_s(t))
                      if use_watchdog else None))
    for kind, target, groups in (("colaunch", group_launcher, co_groups),
                                 ("fuselaunch", fused_launcher, fused_groups)):
        for g in groups:
            # the deadline covers the members' summed profiled solo work
            th = threading.Thread(target=target, args=(g, [tid_of[t.name] for t in g]),
                                  daemon=True,
                                  name=f"{kind}-" + "+".join(t.name for t in g))
            watch.append((th, list(g), guardian.window_deadline_s(
                sum(expected_s(t) for t in g)) if use_watchdog else None))
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
