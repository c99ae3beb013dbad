"""Virtual fleets: the device pool the twin schedules, without the devices.

Counterpart of ``saturn_tpu/twin/fleet.py``. A :class:`VirtualFleet` is N
identical slices of M virtual devices, slice-major in the port's
:class:`~saturn_tpu_torch.core.mesh.SliceTopology`, so block alignment and
capacity arithmetic are the production code's. The devices are inert
descriptors: no technique screens them and no memory is read, so the
twin's own oracle (``twin/oracle.py``) is the memory gate.

The port's topology has no ``slice_size`` (its ``subset`` forms one pool):
nothing the twin drives reads it in either package, so the slice geometry
stays here (:meth:`VirtualFleet.slice_indices`, the oracle's DCN penalty
on blocks wider than a slice). ``ROADMAP.md`` queue 3 records it.

Failure processes, both seeded:

- :meth:`VirtualFleet.failure_schedule`: per-slice Bernoulli preemption
  renewal processes (a live slice is reclaimed with ``p_preempt`` per
  interval and returns ``outage_intervals`` later), the spot-fleet shape.
- :meth:`VirtualFleet.storm_schedule`: the generic chaos generator
  (``resilience.faults.seeded_schedule``: block preemptions, stragglers,
  transient crashes), sanitized so the fleet never loses its last slice's
  worth of devices: a topology of zero devices has no plan.

Both return ``FaultEvent`` lists for ``resilience.faults.FaultInjector``,
the injector and monitor the real orchestrator uses.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.resilience.faults import FaultEvent, FaultKind, seeded_schedule


@dataclass(frozen=True)
class VirtualDevice:
    """An inert device descriptor (no runtime behind it)."""

    index: int              # global device index (slice-major)
    slice_id: int
    hbm_bytes: int
    platform: str = "twin"
    device_kind: str = "virtual-tpu"

    @property
    def process_index(self) -> int:
        return self.slice_id  # one virtual host per slice

    def __repr__(self) -> str:
        return f"VirtualDevice(d{self.index}/s{self.slice_id})"


@dataclass(frozen=True)
class SliceSpec:
    """Shape and failure parameters of one (or every) virtual slice."""

    chips: int = 8
    hbm_gib: float = 16.0
    ici_gbps: float = 1200.0      # intra-slice interconnect (descriptive)
    dcn_gbps: float = 25.0        # cross-slice fabric (descriptive)
    p_preempt: float = 0.0        # per-interval whole-slice reclaim probability
    outage_intervals: int = 2     # intervals until a reclaimed slice returns


class VirtualFleet:
    """``n_slices`` virtual slices of one :class:`SliceSpec` shape.

    Chip counts must be uniform across slices (the JAX topology encodes one
    ``slice_size``); memory and failure parameters may vary per slice
    through ``overrides``."""

    def __init__(self, n_slices: int = 4, spec: SliceSpec = SliceSpec(),
                 overrides: Optional[Dict[int, SliceSpec]] = None):
        if n_slices < 1:
            raise ValueError(f"need at least one slice, got {n_slices}")
        self.spec = spec
        self.specs: List[SliceSpec] = [(overrides or {}).get(s, spec) for s in range(n_slices)]
        if any(sp.chips != spec.chips for sp in self.specs):
            raise ValueError("slice chip counts must be uniform (one slice size); vary "
                             "HBM or failure parameters instead")
        self.n_slices = n_slices
        self.chips = spec.chips
        self.devices: List[VirtualDevice] = []
        for s, sp in enumerate(self.specs):
            hbm = int(sp.hbm_gib * (1 << 30))
            for c in range(sp.chips):
                self.devices.append(VirtualDevice(index=s * sp.chips + c, slice_id=s,
                                                  hbm_bytes=hbm))

    # ------------------------------------------------------------- topology
    def topology(self) -> SliceTopology:
        return SliceTopology(list(self.devices))

    def slice_indices(self, slice_id: int) -> Tuple[int, ...]:
        if not 0 <= slice_id < self.n_slices:
            raise IndexError(f"no slice {slice_id} in a {self.n_slices}-slice fleet")
        base = slice_id * self.chips
        return tuple(range(base, base + self.chips))

    def describe(self) -> dict:
        return {
            "n_slices": self.n_slices,
            "chips_per_slice": self.chips,
            "n_devices": len(self.devices),
            "hbm_gib_per_chip": self.spec.hbm_gib,
            "ici_gbps": self.spec.ici_gbps,
            "dcn_gbps": self.spec.dcn_gbps,
        }

    # ------------------------------------------------------------- failures
    def failure_schedule(self, seed: int, n_intervals: int) -> List[FaultEvent]:
        """A per-slice seeded preemption renewal process.

        Each interval every live slice is reclaimed with its spec's
        ``p_preempt`` and returns whole after ``outage_intervals``; the last
        live slice is never taken. Draws go in (interval, slice) order, so
        the schedule is a pure function of (seed, n_intervals, specs)."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        down_until = [0] * self.n_slices   # the interval a slice returns in
        for i in range(n_intervals):
            for s, sp in enumerate(self.specs):
                if i < down_until[s]:
                    continue
                if sp.p_preempt <= 0.0 or rng.random() >= sp.p_preempt:
                    continue
                live_others = sum(1 for o in range(self.n_slices)
                                  if o != s and i >= down_until[o])
                if live_others == 0:
                    continue  # never empty the fleet
                devs = self.slice_indices(s)
                events.append(FaultEvent(i, FaultKind.SLICE_PREEMPTION, devices=devs,
                                         after_s=0.001))  # mid-interval: work is lost
                back = i + max(1, sp.outage_intervals)
                down_until[s] = back
                events.append(FaultEvent(back, FaultKind.DEVICE_RETURN, devices=devs))
        return events

    def storm_schedule(self, seed: int, n_intervals: int, *,
                       p_preempt: float = 0.15, p_crash: float = 0.1,
                       p_straggler: float = 0.05,
                       outage_intervals: int = 2) -> List[FaultEvent]:
        """A chaos storm: ``resilience.faults.seeded_schedule`` over the
        whole fleet, sanitized for a long campaign.

        The raw generator's preemptions have no returns and no floor on the
        surviving capacity. Here every preemption gets a ``DEVICE_RETURN``
        ``outage_intervals`` later, and one that would leave fewer than a
        slice's worth of live devices is dropped."""
        raw = seeded_schedule(seed, n_intervals, len(self.devices), p_preempt=p_preempt,
                              p_crash=p_crash, p_straggler=p_straggler)
        events: List[FaultEvent] = []
        down: Dict[int, int] = {}   # device index -> its return interval
        for ev in sorted(raw, key=lambda e: (e.at_interval, e.after_s, e.kind)):
            if ev.kind != FaultKind.SLICE_PREEMPTION:
                events.append(ev)
                continue
            i = ev.at_interval
            for d, back in list(down.items()):
                if back <= i:
                    del down[d]
            taking = [d for d in ev.devices if d not in down]
            survivors = len(self.devices) - len(down) - len(taking)
            if not taking or survivors < self.chips:
                continue  # keep at least one slice's worth of capacity
            events.append(FaultEvent(i, FaultKind.SLICE_PREEMPTION, devices=tuple(taking),
                                     after_s=ev.after_s))
            back = i + max(1, outage_intervals)
            events.append(FaultEvent(back, FaultKind.DEVICE_RETURN, devices=tuple(taking)))
            for d in taking:
                down[d] = back
        return events
