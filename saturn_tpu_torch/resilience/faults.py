"""Deterministic fault injection for elasticity and health drills.

Counterpart of ``saturn_tpu/resilience/faults.py``. A fleet's real failure
signals (a lost card, a preemption notice, a slow device, a crashed run)
cannot be produced on demand, so this module simulates their observable
effects from a deterministic schedule: device loss, the preemption of an
aligned block, stragglers, transient run crashes, and the training-health
faults (a NaN or a spike in the observed loss, a poisoned batch, a wedged
dispatch). A schedule is built in code, drawn from a seed
(:func:`seeded_schedule`), or parsed from ``SATURN_TPU_FAULTS`` in the JAX
package's grammar, so the same string drives the same drill in both
packages.

The injector never touches a device itself: it drives the
:class:`~saturn_tpu_torch.resilience.health.FleetHealthMonitor` (which the
orchestrator polls) and answers the engine's per-task queries.
"""

from __future__ import annotations

import math
import os
import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class FaultKind:
    """Fault taxonomy (string constants, so schedules serialize as they are)."""

    DEVICE_LOSS = "device_loss"            # single devices vanish
    SLICE_PREEMPTION = "slice_preemption"  # a whole aligned block vanishes
    STRAGGLER = "straggler"                # devices slow down by `slowdown` x
    TRIAL_CRASH = "trial_crash"            # one task's interval run raises once
    DEVICE_RETURN = "device_return"        # lost devices come back
    # Health faults (the guardian's detection targets), all injected at the
    # observation level: the sentinel's view of the loss vector, or a host
    # stall before the dispatch; never into the train state, so a rolled-back
    # retry follows the fault-free trajectory.
    NUMERIC_NAN = "numeric_nan"            # one observed step loss becomes NaN (once)
    LOSS_SPIKE = "loss_spike"              # one observed step loss explodes (once)
    BATCH_POISON = "batch_poison"          # dataset indices observe NaN (persistent)
    DISPATCH_STALL = "dispatch_stall"      # a task's dispatch wedges for stall_s (once)

    ALL = (DEVICE_LOSS, SLICE_PREEMPTION, STRAGGLER, TRIAL_CRASH, DEVICE_RETURN,
           NUMERIC_NAN, LOSS_SPIKE, BATCH_POISON, DISPATCH_STALL)
    # Kinds aimed at one task's run, not at the fleet: left out of due() and
    # apply_due, answered through the engine's per-task queries.
    TASK_LEVEL = (TRIAL_CRASH, NUMERIC_NAN, LOSS_SPIKE, BATCH_POISON, DISPATCH_STALL)


class PreemptedError(RuntimeError):
    """A task's interval run was lost to a device or block preemption.

    Unlike an ordinary failure, the orchestrator requeues a preempted task
    without counting it against ``max_task_retries``: losing the devices is
    the fleet's fault, not the task's."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at_interval`` is the orchestrator's 0-based interval index the event
    fires in; ``after_s`` delays it that many seconds into the interval
    (0.0: at the health poll before the interval; above 0: mid-interval,
    from the engine's watchdog timer)."""

    at_interval: int
    kind: str
    devices: Tuple[int, ...] = ()     # device indices (loss, preemption, straggler, return)
    task: Optional[str] = None        # task-level target; None = any task
    slowdown: float = 1.0             # STRAGGLER latency multiplier
    after_s: float = 0.0              # seconds into the interval
    batches: Tuple[int, ...] = ()     # BATCH_POISON dataset indices
    step: int = 0                     # NUMERIC_NAN / LOSS_SPIKE step offset in the interval
    stall_s: float = 0.0              # DISPATCH_STALL seconds
    value: float = float("nan")       # injected loss value (NaN by default)

    def __post_init__(self) -> None:
        if self.kind not in FaultKind.ALL:
            raise ValueError(f"unknown fault kind {self.kind!r}; use one of {FaultKind.ALL}")

    @property
    def mid_interval(self) -> bool:
        return self.after_s > 0.0


@dataclass
class FaultInjector:
    """Replays a fault schedule against the health monitor and the engine.

    One injector serves one orchestration: a crash, a numeric fault or a
    stall fires once (a transient; the retry runs clean), and the interval
    polls are idempotent within an interval."""

    schedule: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.schedule = sorted(self.schedule, key=lambda e: (e.at_interval, e.after_s, e.kind))
        self._consumed_crashes: set = set()
        self._consumed_numeric: set = set()
        self._consumed_stalls: set = set()

    # ------------------------------------------------------------- interval
    def due(self, interval_index: int, mid_interval: bool = False) -> List[FaultEvent]:
        """Topology events due in this interval: at its start
        (``mid_interval=False``, the orchestrator's poll) or during it
        (``True``, the engine's watchdog)."""
        return [e for e in self.schedule
                if e.at_interval == interval_index and e.mid_interval == mid_interval
                and e.kind not in FaultKind.TASK_LEVEL]

    def apply_due(self, interval_index: int, monitor,
                  mid_interval: bool = False) -> List[FaultEvent]:
        """Apply every due topology event to ``monitor``; returns them."""
        events = self.due(interval_index, mid_interval=mid_interval)
        for e in events:
            _apply(e, monitor)
        return events

    def arm_watchdog(self, interval_index: int, monitor, abort_event) -> List[threading.Timer]:
        """Arm one timer per mid-interval event due this interval (the
        engine's abort-and-requeue hook). A loss also sets ``abort_event``,
        so that launchers start no new work; the caller cancels the timers
        that have not fired when the interval ends."""
        timers = []
        for ev in self.due(interval_index, mid_interval=True):
            def fire(ev=ev):
                _apply(ev, monitor)
                if ev.kind in (FaultKind.DEVICE_LOSS, FaultKind.SLICE_PREEMPTION):
                    abort_event.set()

            t = threading.Timer(ev.after_s, fire)
            t.daemon = True
            t.start()
            timers.append(t)
        return timers

    # ---------------------------------------------------------------- crash
    def crashes(self, task_name: str, interval_index: int) -> bool:
        """Whether this task's run raises a transient crash this interval.
        Each TRIAL_CRASH event fires exactly once."""
        for i, e in enumerate(self.schedule):
            if (e.kind == FaultKind.TRIAL_CRASH and e.at_interval == interval_index
                    and (e.task is None or e.task == task_name)
                    and i not in self._consumed_crashes):
                self._consumed_crashes.add(i)
                return True
        return False

    # --------------------------------------------------------------- health
    def numeric_plan(self, task_name: str, interval_index: int) -> Optional[dict]:
        """The observation-level loss poisoning due for this task's interval,
        or None: ``{"steps": {offset: value}, "batches": {dataset index:
        value}}``, the slots the sentinel overwrites in the observed loss
        vector before folding (``health.sentinel.poison_overrides``).
        ``numeric_nan`` and ``loss_spike`` fire once (the rolled-back retry
        is clean); ``batch_poison`` holds from its interval on (the fault
        follows the dataset index through rollbacks, which is what makes
        quarantine the fix)."""
        steps: dict = {}
        batches: dict = {}
        for i, e in enumerate(self.schedule):
            if e.task is not None and e.task != task_name:
                continue
            if e.kind in (FaultKind.NUMERIC_NAN, FaultKind.LOSS_SPIKE):
                if e.at_interval == interval_index and i not in self._consumed_numeric:
                    self._consumed_numeric.add(i)
                    v = e.value
                    if e.kind == FaultKind.LOSS_SPIKE and math.isnan(v):
                        v = 1e9  # a spike stays finite, so the EWMA rule sees it
                    steps[int(e.step)] = float(v)
            elif e.kind == FaultKind.BATCH_POISON and interval_index >= e.at_interval:
                for b in e.batches:
                    batches[int(b)] = float(e.value)
        if not steps and not batches:
            return None
        return {"steps": steps, "batches": batches}

    def dispatch_stall_s(self, task_name: str, interval_index: int) -> float:
        """Seconds this task's dispatch wedges this interval (0: none). Fires
        once: the retry after the watchdog gave up runs clean."""
        for i, e in enumerate(self.schedule):
            if (e.kind == FaultKind.DISPATCH_STALL and e.at_interval == interval_index
                    and (e.task is None or e.task == task_name)
                    and i not in self._consumed_stalls):
                self._consumed_stalls.add(i)
                return float(e.stall_s)
        return 0.0

    # ------------------------------------------------------------------ env
    @classmethod
    def from_env(cls, var: str = "SATURN_TPU_FAULTS") -> Optional["FaultInjector"]:
        """A schedule parsed from the environment, or None where it is unset
        or blank.

        Format: events separated by semicolons,
        ``<interval>[+<after_s>]:<kind>:<spec>``, where ``spec`` is a device
        range ``lo-hi`` or comma list for topology events, a task name for
        ``trial_crash``, ``devs@slowdown`` for ``straggler``, ``task[@step]``
        for ``numeric_nan`` / ``loss_spike``, ``task@i,j`` for
        ``batch_poison`` and ``task@seconds`` for ``dispatch_stall``::

            SATURN_TPU_FAULTS="0:trial_crash:jobA;1+0.5:device_loss:0;2:device_return:0"
        """
        raw = os.environ.get(var, "").strip()
        if not raw:
            return None
        return cls(schedule=[_parse_event(tok) for tok in raw.split(";") if tok.strip()])


def _apply(e: FaultEvent, monitor) -> None:
    if e.kind in (FaultKind.DEVICE_LOSS, FaultKind.SLICE_PREEMPTION):
        monitor.mark_lost(e.devices, cause=e.kind)
    elif e.kind == FaultKind.DEVICE_RETURN:
        monitor.mark_restored(e.devices)
    elif e.kind == FaultKind.STRAGGLER:
        monitor.mark_straggler(e.devices, e.slowdown)


def _parse_devices(spec: str) -> Tuple[int, ...]:
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return tuple(out)


def _parse_event(token: str) -> FaultEvent:
    try:
        when, kind, spec = token.strip().split(":", 2)
        after_s = 0.0
        if "+" in when:
            when, after = when.split("+", 1)
            after_s = float(after)
        interval = int(when)
        kind = kind.strip()
        if kind == FaultKind.TRIAL_CRASH:
            return FaultEvent(interval, kind, task=spec.strip() or None, after_s=after_s)
        if kind in (FaultKind.NUMERIC_NAN, FaultKind.LOSS_SPIKE):
            name, _, step = spec.partition("@")
            return FaultEvent(interval, kind, task=name.strip() or None,
                              step=int(step) if step else 0, after_s=after_s)
        if kind == FaultKind.BATCH_POISON:
            name, _, idx = spec.partition("@")
            return FaultEvent(interval, kind, task=name.strip() or None,
                              batches=_parse_devices(idx), after_s=after_s)
        if kind == FaultKind.DISPATCH_STALL:
            name, _, secs = spec.partition("@")
            return FaultEvent(interval, kind, task=name.strip() or None,
                              stall_s=float(secs) if secs else 5.0, after_s=after_s)
        if kind == FaultKind.STRAGGLER:
            devs, _, slow = spec.partition("@")
            return FaultEvent(interval, kind, devices=_parse_devices(devs),
                              slowdown=float(slow) if slow else 3.0, after_s=after_s)
        return FaultEvent(interval, kind, devices=_parse_devices(spec), after_s=after_s)
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"bad SATURN_TPU_FAULTS event {token!r} "
            "(expected '<interval>[+<after_s>]:<kind>:<spec>')"
        ) from e


def seeded_schedule(
    seed: int,
    n_intervals: int,
    n_devices: int,
    p_preempt: float = 0.15,
    p_crash: float = 0.1,
    p_straggler: float = 0.05,
) -> List[FaultEvent]:
    """A reproducible random fault schedule (the JAX package's draws, in its
    order). Each interval, each fault class fires with its probability: a
    preemption takes an aligned power-of-two block, a straggler one device.
    The same (seed, shape) always gives the same schedule."""
    rng = random.Random(seed)
    events: List[FaultEvent] = []
    for i in range(n_intervals):
        if rng.random() < p_preempt and n_devices >= 2:
            size = 2 ** rng.randint(0, max(0, n_devices.bit_length() - 2))
            offset = rng.randrange(0, n_devices // size) * size
            events.append(FaultEvent(i, FaultKind.SLICE_PREEMPTION,
                                     devices=tuple(range(offset, offset + size)),
                                     after_s=round(rng.uniform(0.0, 0.2), 3)))
        if rng.random() < p_crash:
            events.append(FaultEvent(i, FaultKind.TRIAL_CRASH))
        if rng.random() < p_straggler:
            events.append(FaultEvent(i, FaultKind.STRAGGLER,
                                     devices=(rng.randrange(n_devices),),
                                     slowdown=round(rng.uniform(2.0, 6.0), 2)))
    return events
