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

A sharded state (fsdp, ``parallel/spmd_base.sharded_step_fns``) gathers and
reduce-scatters instead: ``all_gather`` fills every position's full tensor
with every position's block, ``reduce_scatter`` leaves each position the
block of the sum that it owns. Positions that share a device gather by
on-device copies and reduce by one sum in position order, then slice (the
same sums as ``all_reduce_``, held in pieces); distinct devices (one
position each) use ``torch.cuda.nccl.all_gather`` / ``reduce_scatter``, and
``broadcast`` / ``reduce`` where one position owns a whole tensor (a stacked
leaf split over its layer axis). A block that mixes shared and distinct
devices does not shard.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from saturn_tpu_torch.core.mesh import physical_groups

Extent = Tuple[Tuple[int, int], ...]


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
        self.sum_to_leads_(tensors)
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

    def sum_to_leads_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each device group's tensors into its first position's, in
        position order (the on-device half of ``all_reduce_``)."""
        if len(tensors) != self.n:
            raise ValueError(f"{len(tensors)} tensors for a block of {self.n} replicas")
        for group in self.groups:
            lead = tensors[group[0]]
            for r in group[1:]:
                lead.add_(tensors[r])

    def _sharding_mode(self) -> str:
        if not self.distinct:
            return "shared"
        if any(len(g) > 1 for g in self.groups):
            raise ValueError("a block that mixes shared and distinct devices does not shard: "
                             f"{[str(d) for d in self.devices]}")
        return "distinct"

    @staticmethod
    def _split(extents: Sequence[Optional[Extent]], shape) -> Tuple[str, int]:
        """How the positions' extents cut a tensor: ``("even", d)`` (equal
        blocks along dimension d, in position order), ``("owner", r)``
        (position r holds it whole, the others nothing) or ``("repeated",
        -1)`` (several positions hold one extent)."""
        held = [r for r, e in enumerate(extents) if e is not None]
        if len({extents[r] for r in held}) < len(held):
            return "repeated", -1
        if len(held) == 1 and all(b - a == s for (a, b), s in zip(extents[held[0]], shape)):
            return "owner", held[0]
        if len(held) == len(extents):
            dims = {d for e in extents for d, ((a, b), s) in enumerate(zip(e, shape))
                    if b - a != s}
            if len(dims) == 1:
                return "even", dims.pop()
        raise ValueError(f"extents {list(extents)} of {tuple(shape)} are neither an even split "
                         f"nor one owner")

    @staticmethod
    def _slices(ext: Extent):
        return tuple(slice(a, b) for a, b in ext)

    def all_gather(self, shards: Sequence[Optional[torch.Tensor]],
                   fulls: Sequence[torch.Tensor], extents: Sequence[Optional[Extent]]) -> None:
        """Fill every position's full tensor ``fulls[r]`` with every
        position's block: ``shards[s]`` is position s's block, its extent
        ``extents[s]`` (None: it holds none). Reads nothing back to the
        host."""
        mode = self._sharding_mode()
        if mode == "shared":
            lead = fulls[0]
            for s, e in enumerate(extents):
                if e is not None:
                    lead[self._slices(e)].copy_(shards[s])
            for r in range(1, self.n):
                fulls[r].copy_(lead)
            return
        from torch.cuda import nccl

        how, d = self._split(extents, fulls[0].shape)
        if how == "repeated":
            # each extent's first holder fills it in a zeroed buffer; the sum
            # of the buffers is every block once (x + 0 is x)
            first = {}
            for s, e in enumerate(extents):
                if e is not None:
                    first.setdefault(e, s)
            for r, f in enumerate(fulls):
                f.zero_()
                if extents[r] is not None and first[extents[r]] == r:
                    f[self._slices(extents[r])].copy_(shards[r])
            self._nccl_check(nccl, fulls)
            nccl.all_reduce(list(fulls))
            return
        if how == "owner":
            fulls[d].copy_(shards[d])
            self._nccl_check(nccl, fulls)
            nccl.broadcast(list(fulls), root=d)
            return
        n, shape = self.n, fulls[0].shape
        block = list(shape)
        block[d] //= n
        bufs = [torch.empty((n, *block), dtype=f.dtype, device=f.device) for f in fulls]
        ins = [s.contiguous() for s in shards]
        self._nccl_check(nccl, ins)
        nccl.all_gather(ins, [b.view(-1) for b in bufs])
        for f, b in zip(fulls, bufs):
            f.copy_(b.movedim(0, d).reshape(shape))

    def reduce_scatter(self, fulls: Sequence[torch.Tensor],
                       shards: Sequence[Optional[torch.Tensor]],
                       extents: Sequence[Optional[Extent]]) -> None:
        """Leave each position the block ``extents[r]`` of the sum of every
        position's ``fulls[r]`` in ``shards[r]``. On a shared device the
        sum is taken in position order into ``fulls[0]`` (which it
        overwrites), as ``all_reduce_`` takes it."""
        mode = self._sharding_mode()
        if mode == "shared":
            self.sum_to_leads_(fulls)
            self.scatter_from_lead(fulls[0], shards, extents)
            return
        from torch.cuda import nccl

        how, d = self._split(extents, fulls[0].shape)
        self._nccl_check(nccl, fulls)
        if how == "repeated":
            nccl.all_reduce(list(fulls))
            for s, e in enumerate(extents):
                if e is not None:
                    shards[s].copy_(fulls[s][self._slices(e)])
            return
        if how == "owner":
            nccl.reduce(list(fulls), root=d)
            shards[d].copy_(fulls[d])
            return
        n = self.n
        ins = [f.unflatten(d, (n, f.shape[d] // n)).movedim(d, 0).contiguous().view(-1)
               for f in fulls]
        outs = [torch.empty(s.shape, dtype=s.dtype, device=s.device) for s in shards]
        nccl.reduce_scatter(ins, [o.view(-1) for o in outs])
        for s, o in zip(shards, outs):
            s.copy_(o)

    def scatter_from_lead(self, summed: torch.Tensor, shards: Sequence[Optional[torch.Tensor]],
                          extents: Sequence[Optional[Extent]]) -> None:
        """On a shared device: each position's block of an already summed
        tensor into its shard."""
        for s, e in enumerate(extents):
            if e is not None:
                shards[s].copy_(summed[self._slices(e)])

    @staticmethod
    def _nccl_check(nccl, tensors) -> None:
        if not nccl.is_available(list(tensors)):
            raise RuntimeError("NCCL cannot run over these tensors across devices "
                               f"{[str(t.device) for t in tensors]}")

    def sum_parts(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """The sums of the replicas' ``(loss_sum, valid_count)`` parts: one
        float32 ``(2,)`` tensor ``[S, C]`` per replica, on its device, every
        one the same bits. The parts are taken detached: the caller
        back-propagates its own ``loss_sum`` over the global count."""
        vecs = [torch.stack([s.detach().float().reshape(()), c.detach().float().reshape(())])
                for s, c in parts]
        self.all_reduce_(vecs)
        return vecs


# ------------------------------------------------- tp's Megatron operators
def _sum_over(reducer: BlockReducer, xs: Sequence[Optional[torch.Tensor]],
              like: Sequence[Tuple[Any, ...]]) -> List[torch.Tensor]:
    """The group's sum of ``xs`` (None counts as zeros of ``like``'s
    ``(shape, dtype, device)``), one tensor per position, every one the
    same bits; ``xs`` are not changed."""
    outs = [_zeros(m) if x is None else x.detach().clone() for x, m in zip(xs, like)]
    reducer.all_reduce_(outs)
    return outs


def _meta(x: torch.Tensor) -> Tuple[Any, ...]:
    return (tuple(x.shape), x.dtype, x.device)


def _zeros(meta):
    shape, dtype, device = meta
    return torch.zeros(shape, dtype=dtype, device=device)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, the group's sum backward."""

    @staticmethod
    def forward(ctx, reducer, *xs):
        ctx.reducer = reducer
        ctx.like = [_meta(x) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_sum_over(ctx.reducer, grads, ctx.like))


class _SumOverGroup(torch.autograd.Function):
    """Megatron's g: the group's sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, reducer, *xs):
        return tuple(_sum_over(reducer, xs, [_meta(x) for x in xs]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class ModelGroup:
    """The tp positions of one data row (devices ``devices``, in model
    order) and their Megatron operators. On a shared device a sum is one
    sum in position order, copied to every position; across cards an NCCL
    all-reduce over the group's devices (``BlockReducer``). A CUDA graph
    captures the shared form."""

    def __init__(self, devices: Sequence[torch.device]):
        self.reducer = BlockReducer(devices)

    def f(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Before a column-parallel product: the replicated input as it is,
        its gradients summed over the group."""
        return list(_CopyToGroup.apply(self.reducer, *xs))

    def g(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """After a row-parallel product: the partial outputs summed over
        the group, the gradient passed to each as it is."""
        return list(_SumOverGroup.apply(self.reducer, *xs))
