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
        cfg, dt = self.cfg, self.cfg.dtype
        B, T, D = h.shape
        hd, kvh = cfg.head_dim, cfg.kv_heads
        qkv = _dense(self.qkv, h, dt)
        q, k, v = qkv.split([D, kvh * hd, kvh * hd], dim=-1)

        def heads(t, n):
            return t.reshape(B, T, n, hd).transpose(1, 2)

        q, k, v = heads(q, cfg.n_heads), heads(k, kvh), heads(v, kvh)
        if cfg.rotary:
            rd = cfg.rotary_dim or hd
            sin, cos = rotary_sin_cos(torch.arange(T, device=h.device), rd)
            q = apply_rotary(q, sin, cos, rd)
            k = apply_rotary(k, sin, cos, rd)
        if cfg.attention == "flash":
            from saturn_tpu_torch.ops.flash import flash_attention

            # grouped k/v go to the kernels as they are
            attn = flash_attention(q, k, v, causal=cfg.causal)
        else:
            if kvh != cfg.n_heads:
                rep = cfg.n_heads // kvh
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            # bf16 products, fp32 softmax
            scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
            if cfg.causal:
                mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
                scores = scores.masked_fill(~mask, -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            attn = torch.matmul(probs, v)
        attn = attn.transpose(1, 2).reshape(B, T, D)
        return _dense(self.attn_out, attn, dt)

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

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final hidden states (after ln_f), in the compute dtype."""
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.wte).to(cfg.dtype)
        if not cfg.rotary:
            x = x + self.wpe[: tokens.shape[-1]].to(cfg.dtype)
        for blk in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return self.ln_f(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.hidden(tokens)
        # tied head, products in the compute dtype, fp32 logits for the loss
        return F.linear(x, self.wte.to(self.cfg.dtype)).float()


def build_gpt2(name: str = "gpt2-small", pretrained: Any = None, **overrides) -> ModelSpec:
    """Model factory for ``Task(get_model=...)``."""
    if pretrained is not None:
        raise NotImplementedError(
            "pretrained: Hugging Face checkpoint ingest (models/ingest.py) is "
            "a later item of the PyTorch port"
        )
    return spec_for(resolve_attention(config_for(name, **overrides)))


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
             objective: Optional[str] = None) -> ModelSpec:
    """The ModelSpec of a resolved config (``build_gpt2`` and the BERT
    factory build through it).

    ``inputs_fn`` transforms the tokens before every forward entry point
    (BERT's [MASK] substitution). ``labels_fn`` gives the fused head's labels
    (-1 ignored) from the tokens, for the loss tagged ``objective``; a causal
    config defaults to next-token labels, tagged "causal-lm". The fused loss
    is set where ``fused_head_ok(cfg)`` holds."""
    if labels_fn is None and cfg.causal:
        labels_fn, objective = next_token_labels, "causal-lm"
    inputs_fn = inputs_fn or (lambda tokens: tokens)

    def init_fn(generator: torch.Generator, device=None) -> GPT2:
        with torch.device("meta"):
            model = GPT2(cfg)
        model.to_empty(device="cpu")
        model.reset_parameters(generator)
        return model.to(device) if device is not None else model

    def meta_init_fn() -> GPT2:
        with torch.device("meta"):
            return GPT2(cfg)

    def apply_fn(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
        return model(inputs_fn(tokens))

    def hidden_fn(model: GPT2, tokens: torch.Tensor) -> torch.Tensor:
        return model.hidden(tokens)

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
        hints={"block_param_key": "blocks", "n_layers": cfg.n_layers},
        fused_loss_fn=fused_loss_fn,
        fused_loss_parts_fn=fused_loss_parts_fn,
        fused_loss_objective=objective if fused_loss_fn else None,
        hidden_fn=hidden_fn,
        meta_init_fn=meta_init_fn,
    )


def build_gptj(name: str = "gptj-6b", **overrides) -> ModelSpec:
    return build_gpt2(name, **overrides)


def build_llama(name: str = "llama-1b", **overrides) -> ModelSpec:
    return build_gpt2(name, **overrides)
