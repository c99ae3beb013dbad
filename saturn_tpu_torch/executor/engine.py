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
in the JAX package.

With a health monitor (``resilience.FleetHealthMonitor``) the elastic hooks
are on: each run's per-batch seconds feed straggler detection, and a device
lost during the interval (a fault injector's timer, or a platform notice)
aborts and requeues. A task not yet launched, or whose block lost a device
before its interval was published, fails with ``PreemptedError``, which
the orchestrator requeues without using a retry. With a fault injector the
engine also injects the interval's transient crashes, dispatch stalls and
loss poisoning, and arms the mid-interval timers. A launched CUDA graph
cannot be stopped: the abort stops only work that has not started, and a
loss during a run is seen when the run ends.
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
from saturn_tpu_torch.resilience.faults import PreemptedError
from saturn_tpu_torch.resilience.health import block_indices
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


def _join_with_watchdog(watch, started, hung, hung_lock, errors, events) -> None:
    """Join launcher threads under their watchdog deadlines.

    ``watch`` is ``[(thread, tasks, deadline_s | None)]``; ``started`` maps a
    thread's name to the moment it launched, once the tasks it depends on
    finished: a launcher's clock starts there, not at the interval's start
    (the JAX package's), so a task queued behind a stalled one on its block
    is not abandoned with it. A thread still alive past its deadline is
    ABANDONED: each of its tasks gets a
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
            t_start = started.get(th.name)
            if deadline is None or t_start is None:
                continue
            elapsed = timeit.default_timer() - t_start
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


class PublishGate:
    """The moment a run's interval becomes its task's: called by the
    technique after the loss readback and the sentinel, before anything of
    the interval is published (``task._publish_gate``). It raises
    ``PreemptedError`` when the block lost a device by then, so the interval
    is discarded and no checkpoint is written that the data cursor would
    not count; once it has passed, the interval stands, and a loss that
    lands later counts from the next interval on. A technique that does not
    call it is checked after its run instead, as the JAX package checks."""

    def __init__(self, health, didx: List[int], label: str):
        self.health, self.didx, self.label = health, didx, label
        self.passed = False

    def lost(self) -> bool:
        return bool(self.didx) and self.health.any_lost(self.didx)

    def __call__(self) -> None:
        if self.lost():
            raise PreemptedError(f"{self.label} lost devices mid-run")
        self.passed = True

    def after_run(self) -> None:
        if not self.passed and self.lost():
            raise PreemptedError(f"{self.label} lost devices mid-run")


def execute(
    run_tasks: Sequence,
    batches: Dict[str, int],
    interval: float,
    plan: Plan,
    topology: SliceTopology,
    failure_policy: str = "raise",
    guardian=None,
    on_task_done=None,
    health=None,
    faults=None,
    interval_index: int = 0,
    on_task_start=None,
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
    (batches x per-batch time), counted from its launch, once the tasks it
    depends on finished; past it the launch is abandoned
    (``HungDispatchError``, see ``_join_with_watchdog``), and training
    faults (``guardian.owns``) are returned even under ``"raise"``: they
    belong to the guardian's recovery policy. ``on_task_done(name, n)`` is
    called from a task's launcher once its interval ran to its end and its
    data cursor advanced (the durability journal's ``task_progress``): a
    batch count it is given really ran. ``on_task_start(name)`` is called
    from a task's launcher once its dependencies finished and the
    preemption check passed, just before its technique runs (the online
    service marks the job RUNNING there).

    ``health`` (a ``resilience.FleetHealthMonitor``) and ``faults`` (a
    ``resilience.FaultInjector``) turn on the elastic hooks of the module
    docstring for interval ``interval_index``; the monitor's indices of a
    block come from the block's positions (``resilience.health.block_indices``).
    A ``PreemptedError`` is returned, never raised, under either policy."""
    check_launch_invariants([t.name for t in run_tasks], plan)
    events = {t.name: threading.Event() for t in run_tasks}
    running = {t.name for t in run_tasks}
    errors: Dict[str, BaseException] = {}
    # tasks whose launcher the watchdog abandoned: a late wake records no
    # error and commits nothing
    hung: set = set()
    hung_lock = threading.Lock()
    # launcher thread name -> when it launched, its dependencies done (the
    # watchdog's clock)
    started: Dict[str, float] = {}

    def mark_started() -> None:
        started[threading.current_thread().name] = timeit.default_timer()

    abort = threading.Event()
    timers = (faults.arm_watchdog(interval_index, health, abort)
              if faults is not None and health is not None else [])

    def block_didx(a) -> List[int]:
        return block_indices(topology, a.block) if health is not None else []

    def crash_or_preempt(names, a, didx) -> None:
        """The injected crash, then the abort before launch: the fleet
        changed under this interval, so no work starts that the re-plan
        moves anyway."""
        for name in names:
            if faults is not None and faults.crashes(name, interval_index):
                raise RuntimeError(f"injected transient trial crash for {name}")
        if abort.is_set() or (didx and health.any_lost(didx)):
            raise PreemptedError(f"task(s) {sorted(names)} preempted before launch "
                                 f"(block [{a.block.offset}:{a.block.end}])")

    def stall_then_check(name: str) -> bool:
        """Apply an injected dispatch stall; True if the watchdog abandoned
        this launch meanwhile (the caller returns without touching the
        task: the attempt already failed)."""
        stall = faults.dispatch_stall_s(name, interval_index) if faults is not None else 0.0
        if stall > 0.0:
            logger.warning("injected dispatch stall: wedging %s for %.1fs", name, stall)
            time.sleep(stall)
        return abandoned(name)

    def set_poison(task) -> None:
        """Hand the sentinel this interval's observation-level loss
        poisoning, if the injector has one for the task."""
        if faults is not None:
            p = faults.numeric_plan(task.name, interval_index)
            if p:
                task._health_poison = p

    def drop_gate(task, gate) -> None:
        """Take this launch's gate off the task (not a later launch's: an
        abandoned launcher can wake after the next interval set its own)."""
        if gate is not None and vars(task).get("_publish_gate") is gate:
            del task._publish_gate

    def gate_for(task, a, didx) -> Optional[PublishGate]:
        if health is None:
            return None
        gate = PublishGate(health, didx,
                           f"task {task.name} (block [{a.block.offset}:{a.block.end}])")
        task._publish_gate = gate
        return gate

    def note_failure(name: str, e: BaseException) -> None:
        if isinstance(e, PreemptedError):
            logger.warning("%s", e)
        else:
            logger.exception("task %s failed during interval", name)

    def launcher(task, tid: int):
        gate = None
        try:
            for dep in plan.dependencies.get(task.name, ()):
                if dep in running:
                    events[dep].wait()
            mark_started()
            a = plan.assignments[task.name]
            didx = block_didx(a)
            crash_or_preempt([task.name], a, didx)
            task.select_strategy(a.apportionment)
            if on_task_start is not None:
                on_task_start(task.name)
            n = batches[task.name]
            logger.info("interval: launching %s on block [%d:%d] for %d batches",
                        task.name, a.block.offset, a.block.end, n)
            if stall_then_check(task.name):
                return  # the watchdog abandoned this launch during the stall
            set_poison(task)
            gate = gate_for(task, a, didx)
            t_run = timeit.default_timer()
            task.selected_strategy.executor.execute(
                task, topology.block_devices(a.block), tid, override_batch_count=n
            )
            dt_run = timeit.default_timer() - t_run
            if gate is not None:
                gate.after_run()
            with hung_lock:
                if task.name in hung:
                    return
                task.reconfigure(n)
            if didx:
                health.note_step(didx, dt_run / max(n, 1))
            if on_task_done is not None:
                on_task_done(task.name, n)
        except Exception as e:  # surfaced after the barrier
            note_failure(task.name, e)
            # drop the failed launch's locals (its device tensors) now; the
            # traceback keeps its text
            traceback.clear_frames(e.__traceback__)
            with hung_lock:
                if task.name not in hung:
                    errors[task.name] = e
        finally:
            drop_gate(task, gate)
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
            mark_started()
            for t, tid in zip(members, tids):
                try:
                    a = plan.assignments[t.name]
                    didx = block_didx(a)
                    crash_or_preempt([t.name], a, didx)
                    t.select_strategy(a.apportionment)
                    if on_task_start is not None:
                        on_task_start(t.name)
                    if stall_then_check(t.name):
                        return  # the watchdog abandoned the group during the stall
                    set_poison(t)
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
                                   "interleaved": inter, "didx": didx,
                                   "gate": gate_for(t, a, didx)})
                except Exception as e:
                    note_failure(t.name, e)
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
                        note_failure(m["task"].name, e)
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
                    note_failure(m["task"].name, e)
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
                try:
                    if m["gate"] is not None:
                        m["gate"].after_run()
                except PreemptedError as e:
                    note_failure(name, e)
                    record_error(name, e)
                    continue
                with hung_lock:
                    if name in hung:
                        continue
                    m["task"].reconfigure(m["n"])
                if m["didx"]:
                    health.note_step(m["didx"], m["per_batch"])
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
            for m in active:
                drop_gate(m["task"], m["gate"])
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
            mark_started()
            a = plan.assignments[members[0].name]
            devices = topology.block_devices(a.block)
            didx = block_didx(a)
            crash_or_preempt([t.name for t in members], a, didx)
            for t in members:
                t.select_strategy(a.apportionment)
                if on_task_start is not None:
                    on_task_start(t.name)
                set_poison(t)
            if stall_then_check(members[0].name):
                return  # the watchdog abandoned the group during the stall
            counts = [batches[t.name] for t in members]
            logger.info("interval: fused-launching %s on block [%d:%d] (lockstep %d batches "
                        "x %d members)", sorted(names), a.block.offset, a.block.end,
                        min(counts), len(members))
            gate = (PublishGate(health, didx, f"fused group {sorted(names)} (block "
                                              f"[{a.block.offset}:{a.block.end}])")
                    if health is not None else None)
            report = fused.run_fused_interval(members, devices, tids[0], batch_counts=counts,
                                              publish_gate=gate)
            if any(abandoned(t.name) for t in members):
                logger.warning("fused group %s finished after the watchdog abandoned it; "
                               "discarding it", sorted(names))
                return
            if gate is not None:
                gate.after_run()
            if didx and report.per_step_s > 0:
                health.note_step(didx, report.per_step_s)
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
            if isinstance(e, PreemptedError):
                logger.warning("%s", e)
            else:
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
        _join_with_watchdog(watch, started, hung, hung_lock, errors, events)
    else:
        for th, _, _ in watch:
            th.join()
    for tm in timers:
        tm.cancel()
    elapsed = timeit.default_timer() - t0
    with hung_lock:
        errors = dict(errors)
    preempted = sorted(n for n, e in errors.items() if isinstance(e, PreemptedError))
    metrics.event("interval", elapsed_s=elapsed, planned_s=interval,
                  n_tasks=len(run_tasks),
                  failed=sorted(n for n in errors if n not in preempted),
                  preempted=preempted)
    metrics.flush()
    if failure_policy == "raise":
        # preemptions and (with a guardian) training faults belong to the
        # caller's recovery, not to the crash-the-batch path
        real = {n: e for n, e in errors.items()
                if not isinstance(e, PreemptedError)
                and (guardian is None or not guardian.owns(e))}
        if real:
            name, err = next(iter(real.items()))
            raise RuntimeError(f"interval execution failed for task {name}") from err
    logger.info("interval finished in %.1fs of %.1fs planned", elapsed, interval)
    return errors
