"""Fused linear + cross-entropy head: hand-written Hopper kernels + plain versions.

Counterpart of ``saturn_tpu/ops/ce.py``: ``mean CE(x @ W^T, labels)``
without materializing f32 logits or the softmax gradient. The kernels live
in ``csrc/linear_ce.cu`` (built at first use by ``utils/cuda_build``, bound
with ``ctypes``); each replaces one Pallas kernel of the JAX package:

- ``ce_fwd`` <- ``_run_fwd`` / ``_fwd_kernel`` (JAX ``ce.py:208``): per-token
  loss and lse in f32, and in stash mode a bf16 copy of the logits; in both
  modes ``ce_fwd_sm90_kernel`` (TMA and wgmma), vocab-split, with a combine
  pass;
- ``ce_dx``  <- ``_fused_ce_bwd`` / ``_dx_kernel`` (JAX ``ce.py:290``); in
  stash mode ``ce_dx_sm90_kernel`` (TMA and wgmma), in recompute mode the
  mma.sync ``ce_dx_kernel``, each with a split-K reduction pass;
- ``ce_dw``  <- ``_fused_ce_bwd`` / ``_dw_kernel`` (JAX ``ce.py:314``); in
  stash mode ``ce_dw_sm90_kernel`` (TMA and wgmma), in recompute mode the
  mma.sync ``ce_dw_kernel``.

The backward's score source is the stash (stash mode) or x·Wᵀ recomputed in
f32 inside each kernel (recompute mode: no O(N·V) memory). Labels below 0
are ignored: they match no vocab column, and the masked mean outside the
autograd Function gives their rows a zero cotangent, hence zero gradient.

Each wrapper runs its kernel on a CUDA tensor (or raises on what the kernel
does not take) and its plain PyTorch version on a CPU tensor; there is no
fallback from one to the other. Each counts its kernel launches in
``LAUNCHES``, a launch captured into a CUDA graph at each replay
(``ops/launches.py``); the forward's combine pass and dx's split-K
reduction are part of their wrapper's one launch. The plain versions round the stash to bf16
exactly where the kernel does, so they hold against the Pallas kernels in
interpret mode.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Optional

import torch

from saturn_tpu_torch.ops import launches

#: The one ``block_n`` / ``block_v`` that ``fused_linear_cross_entropy`` takes
#: on CUDA: the kernels choose their own tiles.
KERNEL_TILE = 128
#: d_model must be a multiple of this for the kernels.
KERNEL_D_MULTIPLE = 64

# Auto stash threshold (the JAX package's): keep the bf16 logits stash while
# it stays under 512 MiB, else recompute the score tiles in the backward.
STASH_BYTES_MAX = 512 * 1024 * 1024
#: From this vocab up, the JAX package tiles the vocab at 512 columns.
JAX_WIDE_VOCAB = 2048

#: Kernel launches per wrapper since the last ``reset_launch_counts``.
LAUNCHES = {"ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------- binding
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (return type, argument types) of each exported function.
_SIGNATURES = {
    "ce_fwd": (_I, [_P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _P]),
    "ce_dx": (_I, [_P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "ce_dw": (_I, [_P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _P]),
    "ce_fwd_scratch": (_L, [_I, _I, _I]),
    "ce_dx_scratch": (_L, [_I, _I, _I, _I]),
}


def _kernel(name: str):
    from saturn_tpu_torch.utils import cuda_build

    fn = getattr(cuda_build.load("linear_ce"), name)
    restype, argtypes = _SIGNATURES[name]
    if fn.restype is not restype or fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _launch(name: str, *args) -> None:
    """Launch through the ctypes binding; the last argument is the stream."""
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches.count(LAUNCHES, name, args[-1])


def _scratch(name: str, device, *shape) -> torch.Tensor:
    """The f32 scratch that the launcher asks for (it chooses the split)."""
    n = _kernel(name + "_scratch")(*shape)
    if n < 0:
        raise RuntimeError(f"{name}_scratch failed: CUDA error {-n}")
    return torch.empty(n, dtype=torch.float32, device=device)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the CE head runs on cuda or cpu tensors, got {t.device}")


def _check_kernel_inputs(x, w, labels, *rows, stash=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    N, D = x.shape
    for t in (w, labels, *rows, *([stash] if stash is not None else [])):
        if t.device != x.device:
            raise ValueError(f"CE kernels: all tensors must be on {x.device}, got {t.device}")
    for t in (x, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"CE kernels take bfloat16 x and W on CUDA, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("CE kernels: x and W must be contiguous and 16-byte aligned")
    if w.shape[1] != D or D % KERNEL_D_MULTIPLE:
        raise ValueError(f"CE kernels need d_model % {KERNEL_D_MULTIPLE} == 0 and "
                         f"x, W of one width, got {tuple(x.shape)}, {tuple(w.shape)}")
    if labels.dtype != torch.int32 or labels.shape != (N,) or not labels.is_contiguous():
        raise TypeError("CE kernels: labels must be contiguous int32 of shape (N,)")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (N,) or not t.is_contiguous():
            raise TypeError("CE kernels: lse and g must be contiguous float32 of shape (N,)")
    if stash is not None and (
        stash.dtype != torch.bfloat16 or stash.shape != (N, w.shape[0])
        or stash.stride(1) != 1 or stash.stride(0) % 8 or stash.data_ptr() % 16
    ):
        raise ValueError("CE kernels: the stash must be the bf16 (N, V) view ce_fwd returns")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ plain versions
def _scores(x, w) -> torch.Tensor:
    """f32 logits (N, V) from the storage dtype (products in f32)."""
    return torch.matmul(x.float(), w.float().t())


def _ds(s, labels, lse, g) -> torch.Tensor:
    """(softmax - onehot(labels)) * g, f32."""
    cols = torch.arange(s.shape[1], device=s.device)
    onehot = (labels.long()[:, None] == cols[None, :]).float()
    return (torch.exp(s - lse[:, None]) - onehot) * g[:, None]


def ce_fwd_reference(x, w, labels, stash: bool):
    """Plain version of the forward kernel: (loss, lse, bf16 stash or None);
    the label logit of an ignored (negative) label is 0, as in the kernel."""
    s = _scores(x, w)
    lse = torch.logsumexp(s, dim=-1)
    lbl = s.gather(1, labels.long().clamp_min(0)[:, None])[:, 0]
    lbl = torch.where(labels >= 0, lbl, torch.zeros_like(lbl))
    return lse - lbl, lse, s.to(torch.bfloat16) if stash else None


def ce_dx_reference(x, w, labels, lse, g, stash=None) -> torch.Tensor:
    """Plain version of the dx kernel: ds rounded to W's dtype, then ds W."""
    s = stash.float() if stash is not None else _scores(x, w)
    ds = _ds(s, labels, lse, g).to(w.dtype)
    return torch.matmul(ds.float(), w.float()).to(x.dtype)


def ce_dw_reference(x, w, labels, lse, g, stash=None) -> torch.Tensor:
    """Plain version of the dW kernel: ds rounded to x's dtype, dsᵀ x in f32."""
    s = stash.float() if stash is not None else _scores(x, w)
    ds = _ds(s, labels, lse, g).to(x.dtype)
    return torch.matmul(ds.float().t(), x.float())


# ----------------------------------------------------------------- wrappers
def ce_fwd(x, w, labels, stash: bool):
    """Forward kernel on (N, D) x, (V, D) W, (N,) int32 labels ->
    (loss, lse, stash): loss and lse f32 (N,), the stash a bf16 (N, V) view
    (row stride rounded up to 8) or None."""
    if not _on_cuda(x):
        return ce_fwd_reference(x, w, labels, stash)
    _check_kernel_inputs(x, w, labels)
    N, D = x.shape
    V = w.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    loss, lse = torch.empty(N, **f32), torch.empty(N, **f32)
    ld = -(-V // 8) * 8
    buf = torch.empty((N, ld), dtype=torch.bfloat16, device=x.device) if stash else None
    with torch.cuda.device(x.device):
        part = _scratch("ce_fwd", x.device, N, V, int(stash))
        _launch("ce_fwd", x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                buf.data_ptr() if stash else None, ld, part.data_ptr(),
                loss.data_ptr(), lse.data_ptr(), N, V, D, _stream(x))
    return loss, lse, buf[:, :V] if stash else None


def _stash_args(stash):
    return (stash.data_ptr(), stash.stride(0)) if stash is not None else (None, 0)


def ce_dx(x, w, labels, lse, g, stash=None) -> torch.Tensor:
    """dx kernel: (N, D) in x's dtype; stash mode when ``stash`` is given."""
    if not _on_cuda(x):
        return ce_dx_reference(x, w, labels, lse, g, stash)
    _check_kernel_inputs(x, w, labels, lse, g, stash=stash)
    N, D = x.shape
    V = w.shape[0]
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        part = _scratch("ce_dx", x.device, N, V, D, int(stash is not None))
        _launch("ce_dx", x.data_ptr(), w.data_ptr(), *_stash_args(stash),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(), part.data_ptr(),
                dx.data_ptr(), N, V, D, _stream(x))
    return dx


def ce_dw(x, w, labels, lse, g, stash=None) -> torch.Tensor:
    """dW kernel: (V, D) f32; stash mode when ``stash`` is given."""
    if not _on_cuda(x):
        return ce_dw_reference(x, w, labels, lse, g, stash)
    _check_kernel_inputs(x, w, labels, lse, g, stash=stash)
    if stash is not None:  # the stash-mode kernel loads the rows by TMA: 16-byte aligned
        labels, lse, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (labels, lse, g))
    N, D = x.shape
    V = w.shape[0]
    dw = torch.empty((V, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("ce_dw", x.data_ptr(), w.data_ptr(), *_stash_args(stash),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(), dw.data_ptr(),
                N, V, D, _stream(x))
    return dw


class _FusedCE(torch.autograd.Function):
    """Per-token loss through the forward kernel, with the dx and dW kernels
    as its backward (JAX ``_fused_ce`` custom_vjp). The primal W is f32; it
    is cast to x's dtype here and that copy is saved, so dW comes back in
    f32, the primal's dtype (JAX ``ce.py:234-239``)."""

    @staticmethod
    def forward(ctx, x, w, labels, stash):
        wc = w.to(x.dtype)
        loss, lse, s = ce_fwd(x, wc, labels, stash)
        ctx.save_for_backward(x, wc, labels, lse, s)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, wc, labels, lse, s = ctx.saved_tensors
        g = g.float().contiguous()
        dx = ce_dx(x, wc, labels, lse, g, s)
        dw = ce_dw(x, wc, labels, lse, g, s)
        return dx, dw, None, None


# ------------------------------------------------------------------- public
def _auto_bv_dw(d_model: int) -> int:
    """The JAX package's dW vocab block: a (bv_dw, D) f32 accumulator of at
    most 4 MiB, rounded down to a power of two of at least 128."""
    cap = min(1024, (1 << 20) // max(d_model, 1024))
    return max(128, 1 << (cap.bit_length() - 1))


def padded_vocab(V: int, D: int, block_v: Optional[int] = None) -> int:
    """The vocab the JAX package pads W to (JAX ``ce.py:454-492``): to
    ``block_v`` when given, else from ``JAX_WIDE_VOCAB`` up to a common
    multiple of its two vocab blocks (512 and ``_auto_bv_dw(D)``), else to a
    multiple of 128. Only the auto stash decision reads it: the kernels take
    V as it is."""
    if block_v is not None:
        mult = int(block_v)
    elif V >= JAX_WIDE_VOCAB:
        mult = math.lcm(512, _auto_bv_dw(D))
    else:
        mult = 128
    return -(-V // mult) * mult


def auto_stash(N: int, V: int, D: int, block_v: Optional[int] = None) -> bool:
    """``stash=None``'s decision: stash while the bf16 logits of the padded
    vocab, ``N * padded_vocab * 2`` bytes, stay under ``STASH_BYTES_MAX``
    (so both packages stash, or recompute, at the same N)."""
    return N * padded_vocab(V, D, block_v) * 2 <= STASH_BYTES_MAX


def dense_linear_cross_entropy(x, w, labels, *, ignore_index: int = -1) -> torch.Tensor:
    """Unfused reference: the same objective through plain PyTorch ops
    (f32 logits from the storage dtype), differentiable by autograd."""
    D = x.shape[-1]
    x2, lab = x.reshape(-1, D), labels.reshape(-1)
    logits = torch.matmul(x2.float(), w.to(x2.dtype).float().t())
    lbl = logits.gather(1, lab.long().clamp_min(0)[:, None])[:, 0]
    per_tok = torch.logsumexp(logits, dim=-1) - lbl
    valid = lab != ignore_index
    return torch.where(valid, per_tok, 0.0).sum() / valid.sum().clamp_min(1)


def ce_supported(cfg=None) -> bool:
    """Can the CUDA CE kernels run this model config on this machine?

    True only with a CUDA device of capability >= (9, 0) and, given a
    config, bf16 compute and ``d_model % 64 == 0`` (every GPT-2, GPT-J,
    Llama and BERT preset). The model specs use it to set their fused loss,
    so a config the kernels cannot run keeps the logits path by rule, not by
    a caught failure.
    """
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        return False
    if cfg is not None:
        if getattr(cfg, "dtype", torch.bfloat16) != torch.bfloat16:
            return False
        if getattr(cfg, "d_model", KERNEL_D_MULTIPLE) % KERNEL_D_MULTIPLE:
            return False
    return True


def fused_linear_cross_entropy(
    x: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: int = -1,
    block_n: Optional[int] = None,
    block_v: Optional[int] = None,
    reduction: str = "mean",
    stash: Optional[bool] = None,
) -> Any:
    """Cross-entropy of ``x @ w.T`` against ``labels``, fused.

    ``x``: (..., N, D) hidden states (leading dims flattened with N); ``w``:
    (V, D) head weights (the tied embedding); ``labels``: integers matching
    x's leading dims, ``ignore_index`` (negative) masks. Differentiable in x
    and w; the gradient of w is computed in f32.

    ``reduction="mean"`` returns the mean over unmasked tokens;
    ``"sum_count"`` returns ``(loss_sum, valid_count)`` for callers that sum
    both parts across shards before dividing.

    ``stash``: True keeps a bf16 logits stash for the backward, False
    recomputes the score tiles there (no O(N·V) memory), None decides as
    the JAX package does (:func:`auto_stash`).

    The CUDA kernels choose their own tiles (the forward 128 tokens x 256
    vocab columns, the backward 128 x 256 or 128 x 128 output tiles): on a
    CUDA tensor a ``block_n`` or ``block_v`` other than None or 128 raises
    ``NotImplementedError``. The plain version (CPU tensors) has no tiles and
    ignores them.
    """
    if ignore_index >= 0:
        raise ValueError("ignore_index must be negative (labels are matched "
                         "against vocab columns inside the kernel)")
    if reduction not in ("mean", "sum_count"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if _on_cuda(x) and any(b not in (None, KERNEL_TILE) for b in (block_n, block_v)):
        raise NotImplementedError(
            f"the CUDA CE kernels choose their own tiles and take block sizes None or "
            f"{KERNEL_TILE}; blocks ({block_n}, {block_v}) are a later item"
        )
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    N, V = x2.shape[0], w.shape[0]
    if stash is None:
        stash = auto_stash(N, V, D, block_v)
    per_tok = _FusedCE.apply(x2, w.float(), lab, bool(stash))
    valid = lab != ignore_index
    total = torch.where(valid, per_tok, 0.0).sum()
    count = valid.sum()
    if reduction == "sum_count":
        return total, count
    return total / count.clamp_min(1)
