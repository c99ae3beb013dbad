"""Flash attention: hand-written Hopper kernels (forward, dQ, dK/dV) + plain versions.

Counterpart of ``saturn_tpu/ops/flash.py``. The kernels live in
``csrc/flash_attn.cu`` (built at first use by ``utils/cuda_build``, bound with
``ctypes``); each replaces one Pallas kernel of the JAX package and computes
what it computes, in the same (B*H, T, D) layout with lse and delta in f32:

- ``flash_fwd``  <- ``_fwd`` / ``_fwd_kernel`` (JAX ``flash.py:132``)
- ``flash_dq``   <- ``_bwd`` / ``_dq_kernel``  (JAX ``flash.py:250``)
- ``flash_dkv``  <- ``_bwd`` / ``_dkv_kernel`` (JAX ``flash.py:276``)

Each wrapper runs its kernel on a CUDA tensor (or raises on what the kernel
does not take) and its plain PyTorch version on a CPU tensor; there is no
fallback from one to the other. Each counts its kernel launches in
``LAUNCHES``. The kernels tile at 64 x 64 and take bf16 with head dim 64 or
128 (every GPT-2 and Llama preset). All three load their tiles with TMA
into rings of shared-memory stages and multiply on wgmma (helpers in
``csrc/sm90.cuh``); the note at the top of the CUDA source says what bounds
them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
#: q rows and kv rows per CUDA tile (``TILE`` in ``csrc/flash_attn.cu``).
KERNEL_TILE = 64
KERNEL_HEAD_DIMS = (64, 128)

#: Kernel launches per wrapper since the last ``reset_launch_counts``.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------- binding
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_L, _I, _L, _I] + [_I] * 5 + [_F, _I, _P],
    "flash_dq": [_P] * 7 + [_L, _I, _L, _I] + [_I] * 5 + [_F, _I, _P],
    "flash_dkv": [_P] * 8 + [_L, _I, _L, _I] + [_I] * 5 + [_F, _I, _P],
}


def _kernel(name: str):
    from saturn_tpu_torch.utils import cuda_build

    fn = getattr(cuda_build.load("flash_attn"), name)
    if fn.restype is not ctypes.c_int or fn.argtypes != _ARGTYPES[name]:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take."""
    BH, T, D = q.shape
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError("flash kernels: all tensors must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash kernels take bfloat16 on CUDA, got {t.dtype}; "
                "use attention='dense' for other dtypes"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash kernels: tensors must be contiguous and 16-byte aligned")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels support head dim {KERNEL_HEAD_DIMS}, got {D}")
    if T % KERNEL_TILE:
        raise ValueError(f"flash kernels need seq len % {KERNEL_TILE} == 0, got {T}")


def _row_stats(lse: torch.Tensor, delta: torch.Tensor):
    """lse and delta as the kernels read them: contiguous f32 (B*H, T),
    16-byte aligned (the dK/dV kernel copies their rows in bulk)."""
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("flash kernels: lse and delta must be float32")
    return tuple(t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (lse, delta))


def _launch(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _strides(q: torch.Tensor, k: torch.Tensor):
    return q.stride(0), q.stride(1), k.stride(0), k.stride(1)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got {t.device}")


# ------------------------------------------------------------ plain versions
def _kv_index(bh: int, h: int, kv: int, device) -> torch.Tensor:
    """Flat (B*H) q head -> flat (B*KV) k/v row (JAX ``_kv_of``)."""
    i = torch.arange(bh, device=device)
    return (i // h) * kv + (i % h) // (h // kv)


def _scores(q, k, kv_idx, causal: bool, scale: float) -> torch.Tensor:
    """f32 scores from the storage dtype, causal-masked with NEG_INF."""
    s = torch.matmul(q.float(), k[kv_idx].float().transpose(-1, -2)) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool, h: int, kv: int):
    """Plain version of the forward kernel: (o, lse) on (B*H, T, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    idx = _kv_index(q.shape[0], h, kv, q.device)
    s = _scores(q, k, idx, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v[idx].float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _ds(q, k, v, do, lse, delta, causal, h, kv):
    scale = 1.0 / math.sqrt(q.shape[-1])
    idx = _kv_index(q.shape[0], h, kv, q.device)
    p = torch.exp(_scores(q, k, idx, causal, scale) - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v[idx].float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1)), idx, scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool, h: int, kv: int):
    """Plain version of the dQ kernel."""
    _, ds, idx, scale = _ds(q, k, v, do, lse, delta, causal, h, kv)
    dq = torch.matmul(ds.to(k.dtype).float(), k[idx].float()) * scale
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool, h: int, kv: int):
    """Plain version of the dK/dV kernel: group sum over the q heads that
    share each k/v head, in f32, then one cast."""
    p, ds, idx, scale = _ds(q, k, v, do, lse, delta, causal, h, kv)
    dk_h = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv_h = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device).index_add_(0, idx, dk_h)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device).index_add_(0, idx, dv_h)
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- wrappers
def flash_fwd(q, k, v, causal: bool, h: int, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel on (B*H, T, D) q and (B*KV, T, D) k/v -> (o, lse)."""
    if not _on_cuda(q):
        return flash_fwd_reference(q, k, v, causal, h, kv)
    _check_kernel_inputs(q, k, v)
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(), *_strides(q, k), BH, T, D, h, kv,
                1.0 / math.sqrt(D), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool, h: int, kv: int) -> torch.Tensor:
    """dQ kernel; ``delta`` = rowsum(do * o) in f32, (B*H, T)."""
    if not _on_cuda(q):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, h, kv)
    _check_kernel_inputs(q, k, v, do)
    lse, delta = _row_stats(lse, delta)
    BH, T, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *_strides(q, k),
                BH, T, D, h, kv, 1.0 / math.sqrt(D), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool, h: int, kv: int):
    """dK/dV kernel -> (dk, dv) at (B*KV, T, D), group sum in-kernel."""
    if not _on_cuda(q):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, h, kv)
    _check_kernel_inputs(q, k, v, do)
    lse, delta = _row_stats(lse, delta)
    BKV, T, D = k.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_strides(q, k), BKV, T, D, h, kv, 1.0 / math.sqrt(D),
                int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the dQ and dK/dV kernels as its backward
    (JAX ``_flash_bh`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, h, kv):
        o, lse = flash_fwd(q, k, v, causal, h, kv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, h, kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta stays a plain op, as it is plain jnp in the JAX package
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


# ------------------------------------------------------------------- public
def flash_attention_reference(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The same function as :func:`flash_attention` in plain PyTorch over
    (B, H, T, D): f32 scores from the storage dtype, NEG_INF mask, k/v
    repeated over the GQA group, differentiable by autograd."""
    B, H, T, D = q.shape
    rep = H // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(D)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _default_block(T: int) -> int:
    """The kernels' tile (64 rows of q and of k/v), or T when shorter."""
    return min(KERNEL_TILE, T)


def flash_supported(cfg=None) -> bool:
    """Can the CUDA kernels run this model config on this machine?

    True only with a CUDA device of capability >= (9, 0) and, given a
    config: bf16 compute, a head dim the kernels take, a sequence length
    divisible by the tile, and no sequence-parallel axis. Used by the
    attention='auto' rule and the executors' autotune grids, so a config the
    kernels cannot run resolves to dense by rule, not by a caught failure.
    """
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        return False
    if cfg is not None:
        if getattr(cfg, "seq_axis", None) is not None:
            return False
        if getattr(cfg, "dtype", torch.bfloat16) != torch.bfloat16:
            return False
        if getattr(cfg, "head_dim", KERNEL_HEAD_DIMS[0]) not in KERNEL_HEAD_DIMS:
            return False
        T = getattr(cfg, "seq_len", None)
        if T is not None and T % KERNEL_TILE:
            return False
    return True


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Fused causal (or full) attention over (B, H, T, D); differentiable.

    Grouped-query attention is native: ``k``/``v`` may carry KV heads
    dividing H; dk/dv come back at (B, KV, T, D). T must divide by the block
    sizes or this raises ``ValueError``, as the JAX op does. The CUDA kernels
    tile at 64 x 64: on a CUDA tensor a block size other than 64 raises
    ``NotImplementedError``.
    """
    B, H, T, D = q.shape
    KV = k.shape[1]
    if v.shape[1] != KV or KV < 1 or H % KV != 0:
        raise ValueError(
            f"k/v heads ({k.shape[1]}, {v.shape[1]}) must match and divide "
            f"q heads ({H})"
        )
    bq = block_q or _default_block(T)
    bk = block_k or _default_block(T)
    if T % bq or T % bk:
        raise ValueError(f"seq len {T} not divisible by blocks ({bq}, {bk})")
    if _on_cuda(q) and (bq, bk) != (KERNEL_TILE, KERNEL_TILE):
        raise NotImplementedError(
            f"the CUDA flash kernels tile at {KERNEL_TILE}; blocks ({bq}, {bk}) "
            "are a later item"
        )
    qf = q.reshape(B * H, T, D).contiguous()
    kf = k.reshape(B * KV, T, D).contiguous()
    vf = v.reshape(B * KV, T, D).contiguous()
    o = _FlashAttention.apply(qf, kf, vf, causal, H, KV)
    return o.reshape(B, H, T, D)
