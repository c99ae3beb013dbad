"""Collective matmul and ZeRO-3 prefetch: overlap-friendly sharded matmuls.

Counterpart of ``saturn_tpu/ops/collective_matmul.py``. The port runs a
block's positions in one process, so where the JAX package's functions run
inside ``shard_map`` on one device's shard, these take the list of every
position's tensor (position r's on its device) and return one per position.

The TP half. ``ring_all_gather`` gathers the positions' chunks by S - 1
neighbour hops, each chunk placed by its source index, so every position
ends with the in-order concatenation; a hop is a copy to the next
position's device (an on-device copy where positions share a card, a peer
copy on a side stream across cards). ``allgather_matmul`` is ``x @ W`` for
a weight split on its contracting dimension: serial, the ring gather then
one product; overlapped, hop s + 1 issued before partial product s and the
partials accumulated, which reassociates the contraction (close to the
serial form, not bitwise).

The ZeRO-3 half. The block stack's leaves are sharded over the block's
positions (``zero3_block_rules``: each stacked leaf's largest dimension
after the layer axis; the embeddings, norms and head replicated), and the
step gathers one layer at a time. ``prefetch=True`` issues layer k+1's
gather on a side stream of each card, ordered by events, before layer k
computes, so the copies ride under it; ``prefetch=False`` gathers each
layer on the critical path. A gather is a copy: the two orders compute the
same bits, with and without remat. fsdp runs it over a ``data`` axis, tp's
``overlap`` config over ``model`` with the batch over both axes.

As in the JAX package's program each replica's loss is the mean over its
own rows, the step's loss the mean of the replicas' losses, and the
gradients the sum of the replicas' over the block, divided by its size.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Version tag for profile-cache fingerprints: bump when the overlapped
# program changes shape (a serial profile must never price an overlapped
# one, and the other way round).
OVERLAP_SET_VERSION = 1


def overlap_signature() -> str:
    """The overlap machinery's signature, for cache identities."""
    return f"comm-overlap-v{OVERLAP_SET_VERSION}"


# ------------------------------------------------------------ ring gather
def _side(device: torch.device):
    from saturn_tpu_torch.parallel.spmd_base import _side_stream

    return _side_stream("hop", device)


def _hop(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` copied to ``device``: an on-device copy on the same device;
    across cards, a peer copy on the destination's side stream, ordered
    after both cards' current work and before the destination's next."""
    if t.device == device:
        return t.clone()
    if device.type != "cuda" or t.device.type != "cuda":
        raise ValueError(f"a hop between {t.device} and {device} needs two CUDA devices")
    side = _side(device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(device).wait_stream(side)
    t.record_stream(side)
    out.record_stream(torch.cuda.current_stream(device))
    return out


def ring_all_gather(xs: Sequence[torch.Tensor], *, axis: int = 0) -> List[torch.Tensor]:
    """Every position's chunk ``xs[r]`` gathered along ``axis`` by S - 1
    neighbour hops: after hop s position r holds the chunk of position
    (r - s) % S and places it at that source's offset, so each position
    ends with the in-order concatenation, on its device (the JAX package's
    ``ring_all_gather`` inside ``shard_map``)."""
    S = len(xs)
    if S == 1:
        return [xs[0]]
    c = xs[0].shape[axis]
    devices = [x.device for x in xs]
    bufs = [x.new_empty(x.shape[:axis] + (c * S,) + x.shape[axis + 1:]) for x in xs]
    cur = list(xs)
    for s in range(S):
        nxt = ([_hop(cur[(r - 1) % S], devices[r]) for r in range(S)] if s + 1 < S else None)
        for r in range(S):
            bufs[r].narrow(axis, ((r - s) % S) * c, c).copy_(cur[r])
        cur = nxt
    return bufs


# ------------------------------------------------------ collective matmul
def allgather_matmul(xs: Sequence[torch.Tensor], w_shards: Sequence[torch.Tensor], *,
                     overlap: bool = True) -> List[torch.Tensor]:
    """``x @ W`` on every position, for a ``(K, N)`` weight split on its
    contracting dimension: ``w_shards[r]`` is position r's ``(K/S, N)``
    row block, ``xs[r]`` its ``(..., K)`` copy of the replicated input.
    Serial (``overlap=False``): the ring gather, then one product per
    position. Overlapped: hop s + 1 is issued before partial product s,
    and each position accumulates ``x[..., block] @ chunk`` from a zero
    start in the hops' order."""
    S = len(xs)
    if S == 1:
        return [xs[0] @ w_shards[0]]
    if not overlap:
        return [x @ w for x, w in zip(xs, ring_all_gather(w_shards, axis=0))]
    devices = [x.device for x in xs]
    c = w_shards[0].shape[0]
    accs = [x.new_zeros(x.shape[:-1] + (w.shape[-1],)) for x, w in zip(xs, w_shards)]
    cur = list(w_shards)
    for s in range(S):
        nxt = ([_hop(cur[(r - 1) % S], devices[r]) for r in range(S)] if s + 1 < S else None)
        for r in range(S):
            src = (r - s) % S
            accs[r] = accs[r] + xs[r].narrow(-1, src * c, c) @ cur[r]
        cur = nxt
    return accs


def _block_dim(shape: Tuple[int, ...], n_shard: int, min_size: int) -> Optional[int]:
    """The split dimension of a stacked block leaf ``(L, ...)``: its largest
    dimension after the layer axis that the axis size divides (ties to the
    later, as ``sharding.fsdp_rules``); None keeps it replicated."""
    if len(shape) < 2 or int(np.prod(shape)) < min_size:
        return None
    best, best_size = None, -1
    for i, s in enumerate(shape[1:], start=1):
        if s % n_shard == 0 and s >= best_size:
            best, best_size = i, s
    return best


def zero3_block_rules(block_key: str = "blocks", axis: str = "data", min_size: int = 1024):
    """The rules of :func:`zero3_loss_and_grads`: a leaf under ``block_key``
    (``params/blocks/...``, ``opt_state/0/mu/blocks/...``) splits its
    :func:`_block_dim` over ``axis``; every other leaf stays replicated."""
    seg = re.compile(rf"(^|/){re.escape(block_key)}(/|$)")

    def rules(path: str, shape: Tuple[int, ...], mesh_axes) -> Tuple[Any, ...]:
        if not seg.search(path):
            return ()
        d = _block_dim(tuple(shape), mesh_axes[axis], min_size)
        if d is None:
            return ()
        spec = [None] * len(shape)
        spec[d] = axis
        return tuple(spec)

    return rules


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def zero3_loss_and_grads(
    models: Sequence[Any],
    chunks: Sequence[torch.Tensor],
    *,
    devices: Sequence[torch.device],
    gather_layer: Callable[[int], None],
    gather_streams: Sequence[Any] = (),
    n_layers: int,
    embed_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    head_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    block_key: str = "blocks",
    prefetch: bool = True,
    remat: bool = False,
) -> torch.Tensor:
    """The loss of one ZeRO-3 step over the block's replicas, with each
    replica's gradients of its own loss left in its parameters' ``.grad``
    (the caller reduce-scatters them and divides by the block's size).

    Replica r runs ``models[r]`` on ``chunks[r]`` (its rows, on
    ``devices[r]``): ``embed_fn``, the ``n_layers`` blocks of
    ``block_key`` through ``block_fn`` (checkpointed with ``remat``), then
    ``loss_fn(head_fn(...), chunk)``. ``gather_layer(k)`` fills layer k's
    full parameters in every replica from the shards. With ``prefetch`` and
    ``gather_streams`` (one side stream per distinct card), layer k+1's
    gather is issued on them after an event of the current streams, and
    layer k's compute waits only for layer k's; without, each gather runs
    on the current streams just before its layer. The loss is the mean of
    the replicas' losses, on ``devices[0]``, detached."""
    n = len(models)
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    side = list(gather_streams) if prefetch and cards else []
    ready: List[Any] = []

    def issue(k: int) -> None:
        if not side:
            gather_layer(k)
            ready.append(None)
            return
        with contextlib.ExitStack() as stack:
            for s in side:
                stack.enter_context(torch.cuda.stream(s))
            gather_layer(k)
            events = []
            for s in side:
                ev = torch.cuda.Event()
                ev.record(s)
                events.append((s.device, ev))
        ready.append(events)

    def wait(k: int) -> None:
        for device, ev in ready[k] or ():
            torch.cuda.current_stream(device).wait_event(ev)

    for s in side:
        # the shards are the previous step's: the gathers follow its update
        s.wait_stream(torch.cuda.current_stream(s.device))

    hs = []
    for m, c, d in zip(models, chunks, devices):
        with _on(d):
            hs.append(embed_fn(m, c))
    if prefetch and n_layers:
        issue(0)
    for k in range(n_layers):
        if prefetch and k + 1 < n_layers:
            issue(k + 1)
        elif not prefetch:
            issue(k)
        wait(k)
        for r, (m, d) in enumerate(zip(models, devices)):
            blk = getattr(m, block_key)[k]
            with _on(d):
                if remat and torch.is_grad_enabled():
                    from torch.utils.checkpoint import checkpoint

                    hs[r] = checkpoint(block_fn, blk, hs[r], use_reentrant=False,
                                       preserve_rng_state=False)
                else:
                    hs[r] = block_fn(blk, hs[r])
    for s in side:
        torch.cuda.current_stream(s.device).wait_stream(s)
    losses = []
    for m, h, c, d in zip(models, hs, chunks, devices):
        with _on(d):
            losses.append(loss_fn(head_fn(m, h), c))
    del hs
    total = losses[0].detach().float()
    for loss in losses[1:]:
        total = total + loss.detach().float().to(devices[0])
    for loss, d in zip(losses, devices):
        with _on(d):
            loss.backward()
    return total / n
