"""Device pool and aligned-block allocation.

Counterpart of ``saturn_tpu/core/mesh.py``. The pool is a flat list of
devices; allocation is buddy-style: block sizes are powers of two and a
block of size ``s`` starts at a multiple of ``s``, so two blocks either nest
or are disjoint — the property the MILP's non-overlap constraints need.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

log = logging.getLogger("saturn_tpu_torch")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


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

    ``devices=None`` takes every ``torch.cuda`` device and raises when there
    is none: the port runs on the card unless the caller asks for the CPU
    with an explicit list, e.g. ``SliceTopology([torch.device("cpu")])``.
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
        # Usable capacity is the largest power of two <= N so buddy
        # allocation is well-formed on any device count.
        self.capacity = 1 << (n.bit_length() - 1)
        if self.capacity != n:
            log.warning(
                "SliceTopology: %d of %d devices stranded (buddy allocation "
                "uses the largest power-of-two capacity, %d)",
                n - self.capacity, n, self.capacity,
            )

    def valid_sizes(self) -> List[int]:
        """All allocatable block sizes: powers of two up to capacity."""
        out, s = [], 1
        while s <= self.capacity:
            out.append(s)
            s <<= 1
        return out

    def blocks(self, size: int) -> List[Block]:
        """All aligned blocks of a given size (the MILP's placement domain)."""
        if size not in self.valid_sizes():
            raise ValueError(f"invalid block size {size} for capacity {self.capacity}")
        return [Block(off, size) for off in range(0, self.capacity, size)]

    def block_devices(self, block: Block) -> List[Any]:
        return block.devices_of(self.devices)
