"""The block's reducer: sums the replicas' gradients, and the fused head's
``(loss_sum, valid_count)`` parts, across the replicas of a block.

The JAX package leaves this to XLA: dp's replicated parameters make GSPMD
emit a ``psum`` of the gradients over the ``data`` axis, and the fused
head's shard_map wrapper ``psum``s its two parts
(``saturn_tpu/parallel/spmd_base.py:497-512``). The port runs a block of n
positions as n model replicas in one process (``parallel/spmd_base.py``),
so the sum is explicit, in place, over one flat buffer per replica (one
collective a step, not one per parameter):

- positions that name one device (a rehearsal ``[cuda:0, cuda:0]``, or the
  CPU's ``[cpu] * n``) are summed on that device into the first of them, in
  position order, and the sum is copied into the others, so every replica
  holds the same bits;
- the devices of a block that holds more than one (``[cuda:0, cuda:1]``)
  are then summed by ``torch.cuda.nccl.all_reduce``, NCCL communicators
  over a list of devices in one process (the API behind
  ``torch.nn.parallel.comm``), on each device's current stream.

Nothing falls back: NCCL missing or failing on distinct devices raises, and
so does a block that mixes device types.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from saturn_tpu_torch.core.mesh import physical_groups


class BlockReducer:
    """Sums in place across the replicas of a block of ``devices`` (one
    replica per position)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self.groups: List[List[int]] = physical_groups(self.devices)
        types = {d.type for d in self.devices}
        if len(self.groups) > 1 and types != {"cuda"}:
            raise ValueError(f"a block over distinct devices must be all CUDA devices, got "
                             f"{[str(d) for d in self.devices]}")

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """Whether the replicas sit on more than one device (NCCL sums)."""
        return len(self.groups) > 1

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each replica's tensor (``tensors[r]`` on its position's
        device, all of one shape) by the sum over the replicas, in place.
        Reads nothing back to the host."""
        if len(tensors) != self.n:
            raise ValueError(f"{len(tensors)} tensors for a block of {self.n} replicas")
        for group in self.groups:
            lead = tensors[group[0]]
            for r in group[1:]:
                lead.add_(tensors[r])
        if self.distinct:
            from torch.cuda import nccl

            leads = [tensors[g[0]] for g in self.groups]
            if not nccl.is_available(leads):
                raise RuntimeError("NCCL cannot sum these tensors across devices "
                                   f"{[str(t.device) for t in leads]}")
            nccl.all_reduce(leads)
        for group in self.groups:
            lead = tensors[group[0]]
            for r in group[1:]:
                tensors[r].copy_(lead)

    def sum_parts(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """The sums of the replicas' ``(loss_sum, valid_count)`` parts: one
        float32 ``(2,)`` tensor ``[S, C]`` per replica, on its device, every
        one the same bits. The parts are taken detached: the caller
        back-propagates its own ``loss_sum`` over the global count."""
        vecs = [torch.stack([s.detach().float().reshape(()), c.detach().float().reshape(())])
                for s, c in parts]
        self.all_reduce_(vecs)
        return vecs
