"""GPT-2 family in PyTorch: GPT-2, GPT-J-style and Llama-style dense decoders.

Counterpart of ``saturn_tpu/models/gpt2.py``, with its numerics: bf16
activations and products, fp32 parameters, fp32 attention softmax and
logits, norms with eps 1e-6 and fp32 statistics (flax's), tanh GELU, a
-1e30 attention mask, and every dense layer casting both its input and its
weights to the compute dtype (a flax ``Dense(dtype=bf16)``). Casts are
explicit; nothing runs under ``torch.autocast``.

The JAX package scans one block over a stacked layer axis; here the blocks
are a ``ModuleList`` walked by a loop, and ``remat`` checkpoints each block
(``torch.utils.checkpoint``). Parameter names follow the flax tree
(``blocks.{i}.qkv.weight`` <-> ``blocks/qkv/kernel[i]``), so
``models/convert.py`` maps one onto the other. Mixture-of-experts and
sequence-parallel configs are later items and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from saturn_tpu_torch.core.modelspec import ModelSpec

NORM_EPS = 1e-6  # flax LayerNorm / RMSNorm default


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to a multiple of 128
    seq_len: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: Optional[int] = None  # default 4*d_model
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False  # checkpoint each block (activation recompute)
    # GPT-J structure: rotary q/k on the first ``rotary_dim`` head dims (no
    # learned positions) and the parallel attention + MLP residual.
    rotary: bool = False
    rotary_dim: Optional[int] = None  # default: full head_dim
    parallel_residual: bool = False
    # Mixture-of-experts and sequence parallelism: fields kept so every
    # preset of the JAX table constructs; enabling either raises.
    moe: bool = False
    n_experts: int = 8
    capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    seq_axis: Optional[str] = None
    seq_axis_size: int = 1
    seq_mode: str = "ring"
    seq_overlap: bool = False
    # "dense", "flash" (ops/flash.py) or "auto" (flash wherever the CUDA
    # kernels can run this config, see ``flash_supported``).
    attention: str = "auto"
    causal: bool = True
    # Llama-class knobs: RMSNorm, SwiGLU, grouped-query attention.
    norm: str = "layernorm"          # "layernorm" | "rmsnorm"
    mlp_act: str = "gelu"            # "gelu" | "swiglu"
    n_kv_heads: Optional[int] = None
    name: str = "gpt2-small"

    def __post_init__(self) -> None:
        if self.moe:
            raise NotImplementedError(
                "moe=True: the Switch expert MLP (ops/moe.py) is a later item "
                "of the PyTorch port"
            )
        if self.seq_axis is not None:
            raise NotImplementedError(
                "seq_axis: ring / Ulysses sequence parallelism is a later item "
                "of the PyTorch port"
            )
        if self.seq_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_mode must be 'ring' or 'ulysses', got {self.seq_mode!r}"
            )
        if self.attention not in ("auto", "dense", "flash"):
            raise ValueError(
                f"attention must be 'auto', 'dense' or 'flash', "
                f"got {self.attention!r}"
            )
        if self.rotary:
            rd = self.rotary_dim if self.rotary_dim is not None else self.head_dim
            if rd % 2 != 0 or rd > self.head_dim:
                raise ValueError(
                    f"rotary_dim must be even and <= head_dim "
                    f"({self.head_dim}), got {rd}"
                )
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm' or 'rmsnorm', "
                             f"got {self.norm!r}")
        if self.mlp_act not in ("gelu", "swiglu"):
            raise ValueError(f"mlp_act must be 'gelu' or 'swiglu', "
                             f"got {self.mlp_act!r}")
        if self.n_kv_heads is not None and (
            self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads != 0
        ):
            raise ValueError(
                f"n_kv_heads must divide n_heads ({self.n_heads}), "
                f"got {self.n_kv_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


# The JAX package's preset table, verbatim.
PRESETS: Dict[str, Dict[str, Any]] = {
    "test-tiny": dict(d_model=64, n_layers=2, n_heads=4, vocab_size=256, seq_len=64),
    "gpt2-small": dict(d_model=768, n_layers=12, n_heads=12),
    "gpt2-medium": dict(d_model=1024, n_layers=24, n_heads=16),
    "gpt2-large": dict(d_model=1280, n_layers=36, n_heads=20),
    "gpt2-xl": dict(d_model=1600, n_layers=48, n_heads=25),
    "gptj-6b": dict(
        d_model=4096, n_layers=28, n_heads=16, d_ff=16384,
        rotary=True, rotary_dim=64, parallel_residual=True,
    ),
    "gptj-1b3": dict(
        d_model=2048, n_layers=24, n_heads=16, d_ff=8192,
        rotary=True, rotary_dim=64, parallel_residual=True,
    ),
    "gptj-test-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, vocab_size=256, seq_len=64,
        rotary=True, rotary_dim=8, parallel_residual=True,
    ),
    "llama-1b": dict(
        d_model=2048, n_layers=22, n_heads=32, n_kv_heads=4, d_ff=5632,
        rotary=True, norm="rmsnorm", mlp_act="swiglu",
    ),
    "llama-8b": dict(
        d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        rotary=True, norm="rmsnorm", mlp_act="swiglu",
    ),
    "llama-test-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, seq_len=64, rotary=True, norm="rmsnorm",
        mlp_act="swiglu",
    ),
    "moe-test-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, vocab_size=256, seq_len=64,
        moe=True, n_experts=4, d_ff=128,
    ),
    "gpt2-small-moe8": dict(d_model=768, n_layers=12, n_heads=12, moe=True,
                            n_experts=8),
}


def config_for(name: str, **overrides) -> GPT2Config:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; options: {list(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return GPT2Config(name=name, **kw)


def resolve_attention(cfg: GPT2Config) -> GPT2Config:
    """attention='auto' -> flash where the CUDA kernels can run the config
    (``ops.flash.flash_supported``), dense otherwise."""
    if cfg.attention != "auto":
        return cfg
    from saturn_tpu_torch.ops.flash import flash_supported

    return replace(cfg, attention="flash" if flash_supported(cfg) else "dense")


def rotary_sin_cos(positions: torch.Tensor, rotary_dim: int):
    """(sin, cos) tables, each (T, rotary_dim // 2), fp32."""
    inv_freq = 1.0 / (
        10000.0 ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                 device=positions.device) / rotary_dim)
    )
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(t: torch.Tensor, sin, cos, rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of ``t`` (..., T, D) by position
    (half-split rotation)."""
    sin, cos = sin.to(t.dtype), cos.to(t.dtype)
    t_rot, t_pass = t[..., :rotary_dim], t[..., rotary_dim:]
    half = rotary_dim // 2
    t1, t2 = t_rot[..., :half], t_rot[..., half:]
    rotated = torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)
    return torch.cat([rotated, t_pass], dim=-1)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` numerics: fp32 statistics (E[x^2] - E[x]^2, clipped
    at 0), eps 1e-6, result in the compute dtype."""

    def __init__(self, d: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=param_dtype))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + NORM_EPS) * self.scale.float())
        return (y + self.bias.float()).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``RMSNorm`` numerics: fp32 mean square, eps 1e-6, no bias."""

    def __init__(self, d: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, dtype=param_dtype))

    def forward(self, x):
        xf = x.float()
        ms = (xf * xf).mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + NORM_EPS) * self.scale.float())).to(self.dtype)


def _norm(cfg: GPT2Config) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, cfg.dtype, cfg.param_dtype)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """A flax ``Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _attend(cfg: GPT2Config, qkv: torch.Tensor) -> torch.Tensor:
    """Attention of a (B, T, D + 2 kv) qkv projection, before the output
    projection: (B, T, D) in the compute dtype."""
    return _attend_heads(cfg, qkv, cfg.n_heads, cfg.kv_heads)


def _attend_heads(cfg: GPT2Config, qkv: torch.Tensor, n_q: int, n_kv: int,
                  expand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of ``n_q`` query heads over ``n_kv`` key / value heads
    from a (B, T, (n_q + 2 n_kv) hd) projection: (B, T, n_q hd), heads
    flattened head-major. ``expand`` (tp: a position's heads that read
    their kv groups unevenly) gives each query head's kv head, which is
    then repeated per query head."""
    dt = cfg.dtype
    B, T, _ = qkv.shape
    hd = cfg.head_dim
    q, k, v = qkv.split([n_q * hd, n_kv * hd, n_kv * hd], dim=-1)

    def heads(t, n):
        return t.reshape(B, T, n, hd).transpose(1, 2)

    q, k, v = heads(q, n_q), heads(k, n_kv), heads(v, n_kv)
    if expand is not None:
        k, v = k.index_select(1, expand), v.index_select(1, expand)
        n_kv = n_q
    if cfg.rotary:
        rd = cfg.rotary_dim or hd
        sin, cos = rotary_sin_cos(torch.arange(T, device=qkv.device), rd)
        q = apply_rotary(q, sin, cos, rd)
        k = apply_rotary(k, sin, cos, rd)
    if cfg.attention == "flash":
        from saturn_tpu_torch.ops.flash import flash_attention

        # grouped k/v go to the kernels as they are
        with _on(q):
            attn = flash_attention(q, k, v, causal=cfg.causal)
    else:
        if n_kv != n_q:
            rep = n_q // n_kv
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        # bf16 products, fp32 softmax
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        if cfg.causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
            scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.matmul(probs, v)
    return attn.transpose(1, 2).reshape(B, T, n_q * hd)


def _on(t: torch.Tensor):
    """The tensor's card as the current device (a kernel launched through
    ctypes runs on the current device's context), or nothing on the CPU."""
    import contextlib

    return torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext()


class Block(nn.Module):
    """Pre-LN transformer block: sequential GPT-2 wiring (ln_1 -> attn,
    ln_2 -> mlp) or, with ``parallel_residual``, GPT-J's (one norm, attention
    and MLP added together)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        cfg = resolve_attention(cfg)
        self.cfg = cfg
        D, F_, pdt = cfg.d_model, cfg.ff_dim, cfg.param_dtype
        kv_dim = cfg.kv_heads * cfg.head_dim
        self.ln_1 = _norm(cfg)
        self.qkv = nn.Linear(D, D + 2 * kv_dim, dtype=pdt)
        self.attn_out = nn.Linear(D, D, dtype=pdt)
        if cfg.mlp_act == "swiglu":
            self.mlp_gate = nn.Linear(D, F_, dtype=pdt)
        self.mlp_in = nn.Linear(D, F_, dtype=pdt)
        self.mlp_out = nn.Linear(F_, D, dtype=pdt)
        if not cfg.parallel_residual:
            self.ln_2 = _norm(cfg)

    def attention(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return _dense(self.attn_out, _attend(self.cfg, _dense(self.qkv, h, dt)), dt)

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        if self.cfg.mlp_act == "swiglu":
            m = F.silu(_dense(self.mlp_gate, h, dt)) * _dense(self.mlp_in, h, dt)
        else:
            m = F.gelu(_dense(self.mlp_in, h, dt), approximate="tanh")
        return _dense(self.mlp_out, m, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        if self.cfg.parallel_residual:
            return x + self.attention(h) + self.mlp(h)
        x = x + self.attention(h)
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    """Decoder-only LM with a tied output head; blocks under ``blocks``."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        cfg = resolve_attention(cfg)
        self.cfg = cfg
        pdt = cfg.param_dtype
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=pdt))
        if not cfg.rotary:
            self.wpe = nn.Parameter(torch.empty(cfg.seq_len, cfg.d_model, dtype=pdt))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.n_layers)])
        self.ln_f = _norm(cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers: wte ~ N(0, 0.02), wpe ~ N(0, 0.01), dense
        kernels lecun-normal (truncated at 2 std), biases 0, norm scales 1."""
        self.wte.normal_(0.0, 0.02, generator=generator)
        if not self.cfg.rotary:
            self.wpe.normal_(0.0, 0.01, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, RMSNorm)):
                mod.scale.fill_(1.0)
                if isinstance(mod, LayerNorm):
                    mod.bias.zero_()

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token (and, without rotary, position) embeddings in the compute
        dtype: the input of the first block."""
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.wte).to(cfg.dtype)
        if not cfg.rotary:
            x = x + self.wpe[: tokens.shape[-1]].to(cfg.dtype)
        return x

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits of final hidden states (after ln_f): the tied head, products
        in the compute dtype, fp32 logits for the loss."""
        return F.linear(h, self.wte.to(self.cfg.dtype)).float()

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final hidden states (after ln_f), in the compute dtype."""
        cfg = self.cfg
        x = self.embed(tokens)
        for blk in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                # the blocks draw no random numbers, so the RNG state needs
                # no saving (reading it is illegal inside a CUDA graph capture)
                x = checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x)
        return self.ln_f(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.hidden(tokens))


# ------------------------------------------------------------------ stacked
# The stacked forward of ``parallel/fused.py``: M members of one config whose
# parameters are stacked on a leading member axis (a ``GPT2`` whose every
# parameter is (M, *shape), ``stacked_model``), run as one program. The
# dense products are batched over the member axis (``torch.baddbmm``, one
# product for all members), norms, GELU and embeddings broadcast over it, and
# attention takes the members folded into its batch, (M * B, H, T, D): the
# flash kernels compute each row on its own, so one launch serves every
# member. The fused CE head runs once per member, each on its own W and at
# the member's own N = B * T, so ``ce.auto_stash`` picks the solo mode.


def stacked_model(cfg: GPT2Config, n: int, device) -> "GPT2":
    """A ``GPT2`` of ``cfg`` whose every parameter is an uninitialised
    (n, *shape) tensor on ``device``: the solo names, stacked shapes."""
    with torch.device("meta"):
        model = GPT2(cfg)
    for mod in model.modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, pname, nn.Parameter(
                torch.empty((int(n), *p.shape), dtype=p.dtype, device=device)))
    return model


def _stacked_norm(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``LayerNorm`` / ``RMSNorm`` of (M, ..., D) with (M, D) parameters,
    the solo numerics per member."""
    xf = x.float()
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    scale = mod.scale.float().view(shape)
    if isinstance(mod, RMSNorm):
        ms = (xf * xf).mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + NORM_EPS) * scale)).to(mod.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + NORM_EPS) * scale)
    return (y + mod.bias.float().view(shape)).to(mod.dtype)


def _stacked_dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``_dense`` of (M, B, T, in) with (M, out, in) weights: one batched
    product over the member axis, bias added inside it as ``F.linear``
    adds it."""
    M, B, T, _ = x.shape
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    y = torch.baddbmm(b.unsqueeze(1), x.reshape(M, B * T, -1).to(dtype), w.transpose(1, 2))
    return y.reshape(M, B, T, -1)


def _stacked_block(blk: Block, x: torch.Tensor) -> torch.Tensor:
    cfg, dt = blk.cfg, blk.cfg.dtype
    M, B, T, D = x.shape

    def attention(h):
        qkv = _stacked_dense(blk.qkv, h, dt)
        attn = _attend(cfg, qkv.reshape(M * B, T, -1)).reshape(M, B, T, D)
        return _stacked_dense(blk.attn_out, attn, dt)

    def mlp(h):
        if cfg.mlp_act == "swiglu":
            m = F.silu(_stacked_dense(blk.mlp_gate, h, dt)) * _stacked_dense(blk.mlp_in, h, dt)
        else:
            m = F.gelu(_stacked_dense(blk.mlp_in, h, dt), approximate="tanh")
        return _stacked_dense(blk.mlp_out, m, dt)

    h = _stacked_norm(blk.ln_1, x)
    if cfg.parallel_residual:
        return x + attention(h) + mlp(h)
    x = x + attention(h)
    return x + mlp(_stacked_norm(blk.ln_2, x))


def stacked_hidden(model: "GPT2", tokens: torch.Tensor) -> torch.Tensor:
    """Final hidden states (after ln_f) of (M, B, T) tokens through a
    ``stacked_model``: (M, B, T, D) in the compute dtype."""
    cfg = model.cfg
    M, _, T = tokens.shape
    V = model.wte.shape[1]
    offsets = (torch.arange(M, device=tokens.device) * V).view(M, 1, 1)
    x = F.embedding(tokens.long() + offsets, model.wte.reshape(M * V, -1)).to(cfg.dtype)
    if not cfg.rotary:
        x = x + model.wpe[:, :T].to(cfg.dtype).unsqueeze(1)
    for blk in model.blocks:
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(_stacked_block, blk, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _stacked_block(blk, x)
    return _stacked_norm(model.ln_f, x)


# --------------------------------------------------------- tensor parallel
# tp's forward (``parallel/tp.py``, ``spmd_base.tp_step_fns``): the JAX
# package's ``tensor_parallel_rules`` placement run by hand. A block of
# data x tp positions holds one ``GPT2`` per position whose parameters are
# that position's extents (``mlp_in`` (F/tp, D), ``attn_out`` (D, D/tp),
# ``wte`` (V/tp, D); the norms, ``wpe`` and the row-parallel biases whole,
# and ``qkv`` whole as well: gathered from its column blocks before the
# step, since those blocks do not line up with heads). A leaf the rule
# leaves whole because tp does not divide its dimension (a vocabulary of
# 50257, an odd d_ff) is split all the same, by ``tp_part``: every
# position then holds it whole and computes with its part, and its
# gradient is summed over the model group. Position r sits at
# model coordinate r % tp of data row r // tp; ``groups[d]`` is the
# ``parallel.collectives.ModelGroup`` of row d, whose ``f`` (identity
# forward, group sum backward) goes before every column-parallel product
# and whose ``g`` (group sum forward) after every row-parallel one. Every
# function takes and returns one tensor per position.


def _grouped(groups, tp: int, xs, op: str) -> list:
    """``groups[d].f`` or ``.g`` over the positions of each data row."""
    out = []
    for d, grp in enumerate(groups):
        out += getattr(grp, op)(xs[d * tp:(d + 1) * tp])
    return out


def tp_part(w: torch.Tensor, full: int, tp: int, m: int, dim: int = 0) -> torch.Tensor:
    """Model coordinate m's part of a leaf split over ``model`` along
    ``dim`` (``full`` long whole): the leaf itself where the position
    holds its extent, else (the rule left it whole: tp does not divide
    ``full``) its indices ``[m full // tp, (m+1) full // tp)``, which are
    the extent when tp does divide."""
    if w.shape[dim] != full:
        return w
    a, b = m * full // tp, (m + 1) * full // tp
    return w.narrow(dim, a, b - a)


def tp_head_split(cfg: GPT2Config, tp: int, m: int):
    """Model coordinate m's share of attention: ``(slices, n_q, n_kv,
    expand)``, the (start, stop) rows of the whole qkv weight holding its
    query heads ``[m H/tp, (m+1) H/tp)`` and the key and value heads those
    read (GQA: the groups ``h // (H / kv)``; two positions may read one
    group), the counts of both, and, where the heads read their groups
    unevenly, ``(h0, rep, g0)``: query head h reads local kv head
    ``h // rep - g0`` for h from h0 (else None)."""
    H, kvh, hd, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    n_q = H // tp
    h0, h1 = m * n_q, (m + 1) * n_q
    rep = H // kvh
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    kv = kvh * hd
    slices = [(h0 * hd, h1 * hd), (D + g0 * hd, D + g1 * hd), (D + kv + g0 * hd, D + kv + g1 * hd)]
    groups = [h // rep - g0 for h in range(h0, h1)]
    n_kv = g1 - g0
    even = n_q % n_kv == 0 and groups == [i // (n_q // n_kv) for i in range(n_q)]
    return slices, n_q, n_kv, None if even else (h0, rep, g0)


def _tp_attention(blk: Block, h: torch.Tensor, tp: int, m: int) -> torch.Tensor:
    """Position m's heads: its rows of the gathered qkv, attention over
    them (flash on the card), before the output projection:
    (B, T, D / tp) in the compute dtype."""
    cfg, dt = blk.cfg, blk.cfg.dtype
    slices, n_q, n_kv, expand = tp_head_split(cfg, tp, m)
    w = torch.cat([blk.qkv.weight[a:b] for a, b in slices])
    bias = torch.cat([blk.qkv.bias[a:b] for a, b in slices])
    qkv = F.linear(h.to(dt), w.to(dt), bias.to(dt))
    idx = None
    if expand is not None:
        # made on the device (a CUDA graph captures no host-to-device copy)
        h0, rep, g0 = expand
        idx = torch.div(torch.arange(h0, h0 + n_q, device=h.device), rep,
                        rounding_mode="floor") - g0
    return _attend_heads(cfg, qkv, n_q, n_kv, idx)


def _row_parallel(groups, tp: int, parts, biases, dt) -> list:
    """The outputs of a row-parallel product from the positions' partial
    products (each in the compute dtype): the model group's sum taken in
    fp32, the bias added once after it in fp32, one rounding to ``dt``."""
    sums = _grouped(groups, tp, [p.float() for p in parts], "g")
    return [(s + b.to(dt).float()).to(dt) for s, b in zip(sums, biases)]


def tp_block(blocks, xs, groups, tp: int) -> list:
    """One layer over every position: ``blocks[r]`` is position r's block,
    ``xs[r]`` its copy of the residual stream (the same on every position
    of a data row)."""
    cfg, dt = blocks[0].cfg, blocks[0].cfg.dtype

    def attention(hs):
        parts = [F.linear(_tp_attention(blk, h, tp, r % tp), blk.attn_out.weight.to(dt))
                 for r, (blk, h) in enumerate(zip(blocks, hs))]
        return _row_parallel(groups, tp, parts, [blk.attn_out.bias for blk in blocks], dt)

    def column(layer, h, m):
        w, b = (tp_part(t, cfg.ff_dim, tp, m) for t in (layer.weight, layer.bias))
        return F.linear(h.to(dt), w.to(dt), b.to(dt))

    def mlp(hs):
        parts = []
        for r, (blk, h) in enumerate(zip(blocks, hs)):
            m = r % tp
            if cfg.mlp_act == "swiglu":
                a = F.silu(column(blk.mlp_gate, h, m)) * column(blk.mlp_in, h, m)
            else:
                a = F.gelu(column(blk.mlp_in, h, m), approximate="tanh")
            w = tp_part(blk.mlp_out.weight, cfg.ff_dim, tp, m, dim=1)
            parts.append(F.linear(a.to(dt), w.to(dt)))
        return _row_parallel(groups, tp, parts, [blk.mlp_out.bias for blk in blocks], dt)

    hs = _grouped(groups, tp, [blk.ln_1(x) for blk, x in zip(blocks, xs)], "f")
    if cfg.parallel_residual:
        return [x + a + m for x, a, m in zip(xs, attention(hs), mlp(hs))]
    xs = [x + a for x, a in zip(xs, attention(hs))]
    hs = _grouped(groups, tp, [blk.ln_2(x) for blk, x in zip(blocks, xs)], "f")
    return [x + m for x, m in zip(xs, mlp(hs))]


def tp_embed(models, tokens, groups, tp: int) -> list:
    """The vocab-parallel embedding: each position looks its data row's
    tokens up in its wte rows (``tp_part``; zero for the others), the
    model group sums them (one term is not zero: the sum is the lookup),
    then the positions are added as in ``GPT2.embed``."""
    cfg = models[0].cfg
    V = cfg.vocab_size
    parts = []
    for r, (model, t) in enumerate(zip(models, tokens)):
        w = tp_part(model.wte, V, tp, r % tp)
        rows = w.shape[0]
        ids = t.long() - (r % tp) * V // tp
        inside = (ids >= 0) & (ids < rows)
        e = F.embedding(ids.clamp(0, rows - 1), w)
        parts.append(e.masked_fill(~inside.unsqueeze(-1), 0.0))
    xs = [x.to(cfg.dtype) for x in _grouped(groups, tp, parts, "g")]
    if not cfg.rotary:
        T = tokens[0].shape[-1]
        xs = [x + model.wpe[:T].to(cfg.dtype) for x, model in zip(xs, models)]
    return xs


def tp_logits(models, tokens, groups, tp: int) -> list:
    """Position r's logits: the vocab columns ``[m V // tp, (m+1) V // tp)``
    (m = r % tp) of its data row's tokens, fp32. ``remat`` checkpoints each
    layer of every position, its collectives included."""
    cfg = models[0].cfg
    xs = tp_embed(models, tokens, groups, tp)
    for k in range(cfg.n_layers):
        blocks = [model.blocks[k] for model in models]
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            def layer(*xs, blocks=blocks):
                return tuple(tp_block(blocks, list(xs), groups, tp))

            xs = list(checkpoint(layer, *xs, use_reentrant=False, preserve_rng_state=False))
        else:
            xs = tp_block(blocks, xs, groups, tp)
    hs = _grouped(groups, tp, [model.ln_f(x) for model, x in zip(models, xs)], "f")
    return [F.linear(h, tp_part(model.wte, cfg.vocab_size, tp, r % tp).to(cfg.dtype)).float()
            for r, (model, h) in enumerate(zip(models, hs))]


def build_gpt2(name: str = "gpt2-small", pretrained: Any = None, **overrides) -> ModelSpec:
    """Model factory for ``Task(get_model=...)``.

    ``pretrained``: a local state-dict path (torch ``.pt`` / ``.bin`` or
    ``.npz``) or a loaded mapping, in HF GPT-2 or GPT-J naming
    (``models/ingest.py``). ``init_fn`` then returns those weights instead
    of a random draw, under every technique. Shape-checked against the
    preset here; a path is read once per (file, preset shape) and its
    mapping kept in the ingest cache, which the spec reads again at each
    init rather than holding it."""
    cfg = resolve_attention(config_for(name, **overrides))
    if pretrained is None:
        return spec_for(cfg)
    import logging

    from saturn_tpu_torch.models import ingest

    if isinstance(pretrained, (str, os.PathLike)):
        path = os.fspath(pretrained)

        def weights():
            return ingest.cached_params_from_path(path, cfg)[0]

        mapped, unused = ingest.cached_params_from_path(path, cfg)
    else:
        mapped, unused = ingest.params_from_state_dict(dict(pretrained), cfg)

        def weights():
            return mapped

    if unused:
        logging.getLogger("saturn_tpu_torch").info(
            "pretrained ingest: %d unused tensors (%s...)", len(unused), ", ".join(unused[:4]))
    with torch.device("meta"):
        ingest.validate_against(mapped, GPT2(cfg))
    return spec_for(cfg, weights=weights)


def fused_head_ok(cfg: GPT2Config) -> bool:
    """Whether a spec of ``cfg`` offers the fused head + loss: where the CUDA
    CE kernels can run it (``ops.ce.ce_supported``), or on a machine without
    a card, where the plain version serves. Elsewhere (f32 compute on the
    card) the loss runs over the logits, by rule."""
    from saturn_tpu_torch.ops.ce import ce_supported

    return ce_supported(cfg) or not torch.cuda.is_available()


def next_token_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Fused-head labels of ``pretraining_loss``: the next token, -1 at the
    last position, so the mean runs over the B * (T - 1) real targets."""
    return F.pad(tokens[:, 1:].to(torch.int32), (0, 1), value=-1)


def spec_for(cfg: GPT2Config, *, inputs_fn=None, labels_fn=None,
             objective: Optional[str] = None, weights=None) -> ModelSpec:
    """The ModelSpec of a resolved config (``build_gpt2`` and the BERT
    factory build through it).

    ``inputs_fn`` transforms the tokens before every forward entry point
    (BERT's [MASK] substitution). ``labels_fn`` gives the fused head's labels
    (-1 ignored) from the tokens, for the loss tagged ``objective``; a causal
    config defaults to next-token labels, tagged "causal-lm". The fused loss
    is set where ``fused_head_ok(cfg)`` holds. ``weights`` (``() -> state
    dict``) gives pretrained weights; without it the init is a draw from the
    generator (``GPT2.reset_parameters``)."""
    if labels_fn is None and cfg.causal:
        labels_fn, objective = next_token_labels, "causal-lm"
    inputs_fn = inputs_fn or (lambda tokens: tokens)

    @torch.no_grad()
    def fill_fn(model: GPT2, generator: torch.Generator) -> None:
        if weights is None:
            model.reset_parameters(generator)
        else:
            # copies into the allocated parameters, cast to their dtype
            model.load_state_dict(weights(), strict=True)

    def init_fn(generator: torch.Generator, device=None) -> GPT2:
        with torch.device("meta"):
            model = GPT2(cfg)
        model.to_empty(device="cpu")
        fill_fn(model, generator)
        return model.to(device) if device is not None else model

    def meta_init_fn() -> GPT2:
        with torch.device("meta"):
            return GPT2(cfg)

    def apply_fn(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
        return model(inputs_fn(tokens))

    def hidden_fn(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
        return model.hidden(tokens)

    # Pipeline decomposition (the JAX package's ``hints["pipeline"]``): the
    # embedding, one block and the head as functions over modules, for the
    # techniques that run the blocks one at a time (offload streaming).
    # ``other`` is a GPT2 whose wte, wpe and ln_f are the model's (its blocks
    # may be left out); head(other, blocks(embed(other, tokens))) is
    # ``apply_fn``, op for op.
    def pipeline_embed(other: GPT2, tokens: torch.Tensor) -> torch.Tensor:
        return other.embed(inputs_fn(tokens))

    def pipeline_block(block: Block, x: torch.Tensor) -> torch.Tensor:
        return block(x)

    def pipeline_head(other: GPT2, x: torch.Tensor) -> torch.Tensor:
        return other.head(other.ln_f(x))

    def stacked_loss_fn(model: GPT2, tokens: torch.Tensor, loss_fn=None) -> torch.Tensor:
        """(M,) per-member losses of (M, B, T) tokens through a
        ``stacked_model``: the fused head + loss on each member (``loss_fn``
        None, where ``fused_loss_fn`` is set), else ``loss_fn`` over each
        member's logits."""
        M, B, T = tokens.shape
        inputs = inputs_fn(tokens.reshape(M * B, T)).reshape(M, B, T)
        h = stacked_hidden(model, inputs)
        heads = model.wte.unbind(0)  # one gradient for all members (stack)
        if loss_fn is None:
            from saturn_tpu_torch.ops.ce import fused_linear_cross_entropy

            labels = labels_fn(tokens.reshape(M * B, T)).reshape(M, B, T)
            losses = [fused_linear_cross_entropy(h[m], heads[m], labels[m])
                      for m in range(M)]
        else:
            losses = [loss_fn(F.linear(h[m], heads[m].to(cfg.dtype)).float(), tokens[m])
                      for m in range(M)]
        return torch.stack(losses)

    fused_loss_fn = fused_loss_parts_fn = None
    if labels_fn is not None and fused_head_ok(cfg):
        # Fused head + loss (ops/ce.py): the hidden states and the f32 tied
        # wte go straight into the CE kernels, no (B, T, V) logits. The same
        # objective as the tagged loss over apply_fn: CE against labels_fn's
        # labels, mean over the labels that are not -1.
        def _fused(model, tokens, reduction):
            from saturn_tpu_torch.ops.ce import fused_linear_cross_entropy

            return fused_linear_cross_entropy(model.hidden(inputs_fn(tokens)), model.wte,
                                              labels_fn(tokens), reduction=reduction)

        def fused_loss_fn(model, tokens):
            return _fused(model, tokens, "mean")

        def fused_loss_parts_fn(model, tokens):
            # (loss_sum, valid_count) for callers that sum across devices
            return _fused(model, tokens, "sum_count")

    return ModelSpec(
        init_fn=init_fn,
        apply_fn=apply_fn,
        config=cfg,
        hints={
            "block_param_key": "blocks",
            # tp's forward (``tp_logits``) and the leaves it gathers whole
            # over the model group before use (their column blocks do not
            # line up with heads)
            "tensor_parallel": {
                "logits": lambda models, tokens, groups, tp: tp_logits(
                    models, [inputs_fn(t) for t in tokens], groups, tp),
                "gathered": r"(^|/)blocks/qkv/(kernel|bias)$",
            },
            "n_layers": cfg.n_layers,
            "embed_param_keys": ("wte",) if cfg.rotary else ("wte", "wpe"),
            "pipeline": {
                "embed": pipeline_embed,
                "block": pipeline_block,
                "head": pipeline_head,
                "act_shape": lambda batch, seqlen: (batch, seqlen, cfg.d_model),
                "act_dtype": cfg.dtype,
            },
        },
        fused_loss_fn=fused_loss_fn,
        fused_loss_parts_fn=fused_loss_parts_fn,
        fused_loss_objective=objective if fused_loss_fn else None,
        hidden_fn=hidden_fn,
        meta_init_fn=meta_init_fn,
        fill_fn=fill_fn,
        stacked_model_fn=lambda n, device: stacked_model(cfg, n, device),
        stacked_loss_fn=stacked_loss_fn,
    )


def build_gptj(name: str = "gptj-6b", **overrides) -> ModelSpec:
    return build_gpt2(name, **overrides)


def build_llama(name: str = "llama-1b", **overrides) -> ModelSpec:
    return build_gpt2(name, **overrides)
