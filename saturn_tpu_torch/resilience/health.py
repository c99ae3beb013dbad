"""Fleet health: per-device liveness and latency, and typed change events.

Counterpart of ``saturn_tpu/resilience/health.py``. The engine feeds each
block's realized per-batch seconds after every interval run
(:meth:`FleetHealthMonitor.note_step`); fault injection (on a real fleet,
the platform's notices) feeds liveness (``mark_lost`` / ``mark_restored``).
The orchestrator polls the monitor before each interval and gets at most
one aggregated :class:`TopologyChange`, which it hands to the elastic
replanner.

A straggler is found by latency: a device whose EWMA per-batch time passes
``straggler_factor`` x the fleet's median gives a ``degrade`` event
(advisory: the run goes on). With one device there is no median to
compare with, so one device never degrades.

The monitor's indices are those of the topology the run started with. The
JAX package maps a block's device objects to them by identity; here they
come from the block's positions through ``SliceTopology.base_indices``
(:func:`block_indices`), since ``torch.device`` objects compare by value and
a CPU topology repeats one device.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: How many consecutive healthy polls a returned device must survive before
#: ``poll()`` reports a ``grow`` (at least 1: at once).
ENV_GROW_HYSTERESIS = "SATURN_TPU_GROW_HYSTERESIS"
DEFAULT_GROW_HYSTERESIS = 2


def block_indices(topology, block) -> List[int]:
    """The monitor's (base topology) indices of a block's devices."""
    base = getattr(topology, "base_indices", None) or list(range(len(topology.devices)))
    return [base[i] for i in range(block.offset, block.end)]


@dataclass(frozen=True)
class TopologyChange:
    """One aggregated fleet transition, as the replanner takes it.

    ``kind``: ``"shrink"`` (devices lost), ``"grow"`` (devices returned;
    only when nothing was lost in the same poll window) or ``"degrade"``
    (liveness unchanged, stragglers found)."""

    kind: str
    lost: Tuple[int, ...] = ()
    gained: Tuple[int, ...] = ()
    stragglers: Tuple[int, ...] = ()
    cause: str = ""
    at: float = field(default_factory=time.time)

    def to_fields(self) -> dict:
        """Flat JSON fields for the metrics stream."""
        return {"change": self.kind, "lost": list(self.lost), "gained": list(self.gained),
                "stragglers": list(self.stragglers), "cause": self.cause}


@dataclass
class DeviceHealth:
    """Liveness and latency of one device index."""

    alive: bool = True
    latency_ewma: Optional[float] = None   # seconds per batch, EWMA
    slowdown: float = 1.0                  # injected straggler multiplier
    last_seen: float = 0.0


class FleetHealthMonitor:
    """Tracks every device of a topology by index.

    Thread-safe: launcher threads call :meth:`note_step`, the mid-interval
    fault timer calls :meth:`mark_lost`, and the orchestrator polls."""

    EWMA_ALPHA = 0.5  # an observation is a whole interval's average

    def __init__(self, n_devices: int, straggler_factor: float = 3.0,
                 grow_hysteresis: Optional[int] = None):
        if n_devices < 1:
            raise ValueError("n_devices must be positive")
        self.n_devices = n_devices
        self.straggler_factor = straggler_factor
        if grow_hysteresis is None:
            grow_hysteresis = int(os.environ.get(ENV_GROW_HYSTERESIS, DEFAULT_GROW_HYSTERESIS))
        self.grow_hysteresis = max(1, grow_hysteresis)
        self._devices: Dict[int, DeviceHealth] = {i: DeviceHealth() for i in range(n_devices)}
        self._lock = threading.Lock()
        # transitions since the last poll(), aggregated there
        self._pending_lost: set = set()
        self._pending_gained: set = set()
        self._pending_cause: str = ""
        # returned devices serving out the hysteresis: index -> [streak,
        # loss_surfaced]. ``streak`` counts consecutive healthy polls;
        # ``loss_surfaced`` whether a poll reported the loss before the
        # return (a loss and a return within one poll window cancel before
        # the consumer sees the loss). Such a device is alive but its grow
        # waits until the streak matures, so a blinking device cannot churn
        # the plan.
        self._grow_pending: Dict[int, List] = {}

    @classmethod
    def for_topology(cls, topology, straggler_factor: float = 3.0) -> "FleetHealthMonitor":
        """A monitor over every device of ``topology`` (the usual path)."""
        return cls(len(topology.devices), straggler_factor)

    # -------------------------------------------------------------- feeding
    def note_step(self, device_indices: Sequence[int], per_batch_s: float) -> None:
        """Fold one run's realized per-batch seconds into every device of
        its block. An injected slowdown inflates the observation, so the
        detection runs the path a slow device would."""
        now = time.time()
        with self._lock:
            for i in device_indices:
                d = self._devices.get(i)
                if d is None or not d.alive:
                    continue
                obs = per_batch_s * d.slowdown
                d.latency_ewma = (obs if d.latency_ewma is None
                                  else self.EWMA_ALPHA * obs
                                  + (1 - self.EWMA_ALPHA) * d.latency_ewma)
                d.last_seen = now

    def mark_lost(self, device_indices: Sequence[int], cause: str = "device_loss") -> None:
        with self._lock:
            surfaced_any = False
            for i in device_indices:
                d = self._devices.get(i)
                if d is None or not d.alive:
                    continue
                d.alive = False
                cand = self._grow_pending.pop(i, None)
                if cand is not None and cand[1]:
                    # down again before its return surfaced, after a loss
                    # that did: to the consumer it was dead all along, so no
                    # new shrink (one shrink per flap storm)
                    continue
                surfaced_any = True
                self._pending_lost.add(i)
                self._pending_gained.discard(i)
            if cause and surfaced_any:
                self._pending_cause = cause

    def mark_restored(self, device_indices: Sequence[int]) -> None:
        with self._lock:
            for i in device_indices:
                d = self._devices.get(i)
                if d is not None and not d.alive:
                    d.alive = True
                    d.latency_ewma = None  # a returned device's history is stale
                    d.slowdown = 1.0
                    # a loss no poll reported yet is cancelled (no shrink for
                    # a device that is back), but the return still serves the
                    # hysteresis and surfaces as a grow, whose re-solve takes
                    # back work a mid-interval loss preempted
                    loss_surfaced = i not in self._pending_lost
                    self._pending_lost.discard(i)
                    self._grow_pending[i] = [0, loss_surfaced]

    def mark_straggler(self, device_indices: Sequence[int], slowdown: float) -> None:
        """An injected slowdown; detection stays latency-based."""
        with self._lock:
            for i in device_indices:
                d = self._devices.get(i)
                if d is not None:
                    d.slowdown = max(1.0, slowdown)

    # -------------------------------------------------------------- queries
    def alive_indices(self) -> List[int]:
        with self._lock:
            return [i for i, d in sorted(self._devices.items()) if d.alive]

    def is_alive(self, index: int) -> bool:
        with self._lock:
            d = self._devices.get(index)
            return d is not None and d.alive

    def any_lost(self, device_indices: Sequence[int]) -> bool:
        """Whether any device of the block died (an unknown index counts as
        dead). Work a block computed after it lost a device is discarded."""
        with self._lock:
            return any((d := self._devices.get(i)) is None or not d.alive
                       for i in device_indices)

    def max_slowdown(self, device_indices: Sequence[int]) -> float:
        """The worst injected slowdown of a block's devices (1.0: nominal)."""
        with self._lock:
            return max((self._devices[i].slowdown for i in device_indices
                        if i in self._devices), default=1.0)

    def latency_ewma(self, index: int) -> Optional[float]:
        with self._lock:
            d = self._devices.get(index)
            return None if d is None else d.latency_ewma

    def stragglers(self) -> List[int]:
        """Alive devices with an observation whose latency EWMA passes
        straggler_factor x the fleet's median (two observed devices at
        least)."""
        with self._lock:
            obs = {i: d.latency_ewma for i, d in self._devices.items()
                   if d.alive and d.latency_ewma is not None}
        if len(obs) < 2:
            return []
        vals = sorted(obs.values())
        median = vals[len(vals) // 2]
        if median <= 0.0:
            return []
        return sorted(i for i, v in obs.items() if v > self.straggler_factor * median)

    # ---------------------------------------------------------------- polls
    def poll(self) -> Optional[TopologyChange]:
        """Consume the pending transitions into one event, or None.

        A liveness change wins over stragglers. A window with both losses
        and returns reports ``shrink`` with both sets. A grow waits for
        ``grow_hysteresis`` consecutive healthy polls; a shrink meanwhile
        flushes the candidates into its ``gained`` set."""
        with self._lock:
            lost = tuple(sorted(self._pending_lost))
            cause = self._pending_cause
            self._pending_lost.clear()
            self._pending_cause = ""
            if lost:
                gained = set(self._pending_gained) | set(self._grow_pending)
                self._pending_gained.clear()
                self._grow_pending.clear()
                return TopologyChange(kind="shrink", lost=lost, gained=tuple(sorted(gained)),
                                      cause=cause or "device_loss")
            matured = []
            for i in sorted(self._grow_pending):
                cand = self._grow_pending[i]
                cand[0] += 1
                if cand[0] >= self.grow_hysteresis:
                    matured.append(i)
                    del self._grow_pending[i]
            gained = set(self._pending_gained) | set(matured)
            self._pending_gained.clear()
        if gained:
            return TopologyChange(kind="grow", gained=tuple(sorted(gained)),
                                  cause="device_return")
        stragglers = self.stragglers()
        if stragglers:
            return TopologyChange(kind="degrade", stragglers=tuple(stragglers),
                                  cause="straggler")
        return None
