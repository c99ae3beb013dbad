"""Device pool and aligned-block allocation.

Counterpart of ``saturn_tpu/core/mesh.py``. The pool is a flat list of
devices; allocation is buddy-style: block sizes are powers of two and a
block of size ``s`` starts at a multiple of ``s``, so two blocks either nest
or are disjoint — the property the MILP's non-overlap constraints need.

A position of the pool is a replica's place, not necessarily a card of its
own: a list may name one device more than once (``[cuda:0, cuda:0]``, or
``[cpu] * n`` in the CPU tests), and a block over such positions holds one
model replica per position on the devices they name (``parallel/
spmd_base.py``). :func:`physical_groups` says which positions share a
device, and ``SliceTopology.distinct`` how many devices the pool holds.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

log = logging.getLogger("saturn_tpu_torch")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _physical_key(device: Any) -> Any:
    """What identifies the device a position names: ``str(torch.device)``
    for a torch device or a device string (``cuda`` is ``cuda:0``), the
    object itself for anything else (the tests' fake devices)."""
    import torch

    if isinstance(device, (torch.device, str)):
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        return str(d)
    return device


def physical_groups(devices: Sequence[Any]) -> List[List[int]]:
    """The positions of ``devices`` grouped by the device they name, each
    group in position order and the groups in order of first appearance:
    ``[cuda:0, cuda:1, cuda:0]`` gives ``[[0, 2], [1]]``."""
    groups: dict = {}
    for i, d in enumerate(devices):
        groups.setdefault(_physical_key(d), []).append(i)
    return list(groups.values())


@dataclass(frozen=True)
class Block:
    """A contiguous, size-aligned run of devices: the allocatable unit."""

    offset: int
    size: int

    def __post_init__(self) -> None:
        if not _is_pow2(self.size):
            raise ValueError(f"block size must be a power of two, got {self.size}")
        if self.offset % self.size != 0:
            raise ValueError(
                f"block offset {self.offset} not aligned to size {self.size}"
            )

    @property
    def end(self) -> int:
        return self.offset + self.size

    def overlaps(self, other: "Block") -> bool:
        return self.offset < other.end and other.offset < self.end

    def devices_of(self, devices: Sequence[Any]) -> List[Any]:
        return list(devices[self.offset : self.end])


class SliceTopology:
    """The device pool the scheduler allocates from.

    ``devices=None`` takes every ``torch.cuda`` device once and raises when
    there is none: the port runs on the card unless the caller asks for the
    CPU with an explicit list, e.g. ``SliceTopology([torch.device("cpu")])``.
    An explicit list may repeat a device (a rehearsal of a multi-device
    block on fewer cards): ``distinct`` counts the devices, ``shared``
    says whether any two positions name one device.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        if devices is None:
            import torch

            if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
                raise RuntimeError(
                    "SliceTopology(): no CUDA device; pass an explicit device "
                    "list, e.g. SliceTopology([torch.device('cpu')])"
                )
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices: List[Any] = list(devices)
        n = len(self.devices)
        if n < 1:
            raise ValueError("cannot build a topology over zero devices")
        # each device's index in the topology the run started with (the
        # health monitor's indices): ``subset`` keeps them across shrinks
        self.base_indices: List[int] = list(range(n))
        # Usable capacity is the largest power of two <= N so buddy
        # allocation is well-formed on any device count.
        self.capacity = 1 << (n.bit_length() - 1)
        if self.capacity != n:
            log.warning(
                "SliceTopology: %d of %d devices stranded (buddy allocation "
                "uses the largest power-of-two capacity, %d)",
                n - self.capacity, n, self.capacity,
            )

    @property
    def distinct(self) -> int:
        """How many distinct devices the positions name."""
        return len(physical_groups(self.devices))

    @property
    def shared(self) -> bool:
        """Whether two positions name one device."""
        return self.distinct < len(self.devices)

    def valid_sizes(self) -> List[int]:
        """All allocatable block sizes: powers of two up to capacity."""
        out, s = [], 1
        while s <= self.capacity:
            out.append(s)
            s <<= 1
        return out

    def subset(self, indices: Sequence[int]) -> "SliceTopology":
        """A topology over the surviving devices at ``indices`` (sorted,
        positions again from 0; the elastic replanner's shrink and grow
        primitive). The port's topology has no slices: the survivors form
        one pool, as the JAX package's do once a slice lost part of its
        devices. Each survivor keeps its base index."""
        idx = sorted(set(int(i) for i in indices))
        if not idx:
            raise ValueError("cannot build a topology over zero devices")
        if idx[0] < 0 or idx[-1] >= len(self.devices):
            raise ValueError(f"device indices {idx[0]}..{idx[-1]} out of range for "
                             f"{len(self.devices)} devices")
        sub = SliceTopology([self.devices[i] for i in idx])
        sub.base_indices = [self.base_indices[i] for i in idx]
        return sub

    def blocks(self, size: int) -> List[Block]:
        """All aligned blocks of a given size (the MILP's placement domain)."""
        if size not in self.valid_sizes():
            raise ValueError(f"invalid block size {size} for capacity {self.capacity}")
        return [Block(off, size) for off in range(0, self.capacity, size)]

    def block_devices(self, block: Block) -> List[Any]:
        return block.devices_of(self.devices)
