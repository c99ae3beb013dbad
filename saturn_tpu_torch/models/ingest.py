"""Pretrained-weight ingest: HF state dicts -> the port's GPT-2 modules.

Counterpart of ``saturn_tpu/models/ingest.py``: map a torch-format state
dict in HF ``GPT2LMHeadModel`` or ``GPTJForCausalLM`` naming onto the
``state_dict`` of ``models/gpt2.GPT2``, so that ``build_gpt2(name,
pretrained=path)`` fine-tunes downloaded weights under any technique.
The mapping goes straight to the port's layout, where a Linear weight is
stored ``(out, in)`` and each block is its own module
(``blocks.{i}.qkv.weight``):

- **HF GPT-2 uses Conv1D**, weights stored ``(in, out)``: every matrix
  transposes. ``c_attn`` is the same fused q|k|v projection as ``qkv``.
- **HF GPT-J uses nn.Linear**, ``(out, in)``: taken as they are, with
  ``q/k/v_proj`` fused into ``qkv`` and zero attention biases (GPT-J's
  attention has none).
- **Vocab padding**: HF's 50257 rows are zero-padded up to the preset's
  ``vocab_size`` (50304); **positions**: ``wpe`` is cut to ``seq_len``.
- **Tied head**: the port's head is the tied ``wte``. GPT-J's untied
  ``lm_head`` is reported unused, or loaded into ``wte`` with
  ``tie_from_lm_head=True`` (then ``wte.weight`` is reported);
  ``lm_head.bias`` has no slot and is reported either way.
- **Rotary lanes**: HF GPT-J rotates interleaved lane pairs (2i, 2i+1) of
  each head's first ``rotary_dim`` lanes; the port rotates split halves
  (i, i + rotary_dim / 2). The q and k output rows of those lanes are
  permuted, 2i -> i and 2i+1 -> i + rotary_dim / 2, so that an ingested
  GPT-J computes HF's attention scores (a permutation of the lanes of both
  q and k leaves every q.k product as it was; v is not touched). The JAX
  package leaves its lanes unpermuted (``ROADMAP.md`` queue 3).

Mapped tensors keep the file's dtype (an fp16 GPT-J-6B maps to 12 GB, not
24); the model casts them to its parameter dtype as it loads them. No
network anywhere: callers hand a local path or a loaded mapping.
"""

from __future__ import annotations

import os
import threading
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "load_torch_state_dict",
    "params_from_state_dict",
    "gpt2_params_from_state_dict",
    "gptj_params_from_state_dict",
    "validate_against",
    "cached_params_from_path",
    "release_cache",
]

Params = Dict[str, torch.Tensor]

_cache_key: Optional[tuple] = None
_cache_val: Optional[Tuple[Params, List[str]]] = None
# Guards the size-1 cache: a sweep builds specs from more than one thread,
# and an unsynchronized lookup / load / store could both load a multi-GB
# file twice and publish a key beside another call's value.
_cache_lock = threading.Lock()


def cached_params_from_path(path: str, cfg: Any, **kw) -> Tuple[Params, List[str]]:
    """Load and map ``path`` once per (file, preset shape): search builds a
    spec per candidate config, and reading a multi-GB file for each would
    dominate the sweep. Size 1: a mapped 6B model is 12-24 GB of host
    memory, never hold two. The load runs under the lock on purpose: two
    at once would hold two copies."""
    global _cache_key, _cache_val
    key = (os.path.abspath(path), os.path.getmtime(path), cfg.n_layers, cfg.d_model,
           cfg.vocab_size, cfg.seq_len, cfg.rotary, cfg.rotary_dim, cfg.n_heads,
           tuple(sorted(kw.items())))
    with _cache_lock:
        if _cache_key == key and _cache_val is not None:
            return _cache_val
        _cache_key = _cache_val = None  # the old copy goes before the new one is made
        val = params_from_state_dict(load_torch_state_dict(path), cfg, **kw)
        _cache_key, _cache_val = key, val
        return val


def release_cache() -> None:
    """Drop the cached mapping (offload calls this before it allocates a
    host state, which the weights are then copied into)."""
    global _cache_key, _cache_val
    with _cache_lock:
        _cache_key = _cache_val = None


def load_torch_state_dict(path: str) -> Params:
    """A state dict from disk as CPU tensors: a torch file (``.pt``,
    ``.bin``; ``weights_only=True``, so a pickle cannot run code; memory-
    mapped where it is a zip archive) or an ``.npz`` archive."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if hasattr(sd, "state_dict"):  # a saved module instead of a state dict
        sd = sd.state_dict()
    return {k: v.detach() for k, v in sd.items()}


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _strip_prefix(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict as tensors, without HF's ``transformer.`` prefix."""
    strip = any(k.startswith("transformer.") for k in sd)
    return {(k.removeprefix("transformer.") if strip else k): _as_tensor(v)
            for k, v in sd.items()}


def _pad_vocab(wte: torch.Tensor, vocab_size: int, name: str) -> torch.Tensor:
    v, d = wte.shape
    if v > vocab_size:
        raise ValueError(
            f"{name} has {v} rows but the model preset only has "
            f"vocab_size={vocab_size}; pick a preset with vocab_size >= {v}"
        )
    if v < vocab_size:
        wte = torch.cat([wte, wte.new_zeros(vocab_size - v, d)])
    return wte


def _norms(sd, out: Params, src: str, dst: str) -> None:
    out[f"{dst}.scale"] = sd.pop(f"{src}.weight")
    out[f"{dst}.bias"] = sd.pop(f"{src}.bias")


def gpt2_params_from_state_dict(sd: Mapping[str, Any], cfg: Any) -> Tuple[Params, List[str]]:
    """HF ``GPT2LMHeadModel`` state dict -> the port's ``state_dict``.
    Returns ``(params, unused_keys)``."""
    sd = _strip_prefix(sd)
    wpe = sd.pop("wpe.weight")
    if wpe.shape[0] < cfg.seq_len:
        raise ValueError(
            f"pretrained wpe covers {wpe.shape[0]} positions < seq_len "
            f"{cfg.seq_len}"
        )
    out: Params = {"wte": _pad_vocab(sd.pop("wte.weight"), cfg.vocab_size, "wte.weight"),
                   "wpe": wpe[: cfg.seq_len]}
    _norms(sd, out, "ln_f", "ln_f")
    for i in range(cfg.n_layers):
        h, b = f"h.{i}.", f"blocks.{i}."
        _norms(sd, out, h + "ln_1", b + "ln_1")
        _norms(sd, out, h + "ln_2", b + "ln_2")
        for src, dst in (("attn.c_attn", "qkv"), ("attn.c_proj", "attn_out"),
                         ("mlp.c_fc", "mlp_in"), ("mlp.c_proj", "mlp_out")):
            out[f"{b}{dst}.weight"] = sd.pop(f"{h}{src}.weight").t()  # Conv1D (in, out)
            out[f"{b}{dst}.bias"] = sd.pop(f"{h}{src}.bias")
    return out, sorted(sd)


def rotary_rows(n_heads: int, head_dim: int, rotary_dim: int) -> torch.Tensor:
    """Row order that turns HF GPT-J's interleaved rotary lanes into the
    port's split halves: output row ``r`` of a q or k projection takes HF's
    row ``rotary_rows(...)[r]`` (within each head, lane i < rotary_dim / 2
    takes lane 2i and lane i + rotary_dim / 2 takes lane 2i + 1; the lanes
    past ``rotary_dim`` stay)."""
    half = rotary_dim // 2
    lane = torch.arange(head_dim)
    lane[:half] = torch.arange(0, rotary_dim, 2)
    lane[half:rotary_dim] = torch.arange(1, rotary_dim, 2)
    return (torch.arange(n_heads)[:, None] * head_dim + lane[None, :]).reshape(-1)


def gptj_params_from_state_dict(sd: Mapping[str, Any], cfg: Any,
                                tie_from_lm_head: bool = False) -> Tuple[Params, List[str]]:
    """HF ``GPTJForCausalLM`` state dict -> the port's ``state_dict``: q, k
    and v fused into ``qkv`` with the q and k rows in split-half rotary
    order (``rotary_rows``), zero attention biases. ``tie_from_lm_head``
    loads the untied head matrix into the tied ``wte``."""
    sd = _strip_prefix(sd)
    wte_key = "lm_head.weight" if tie_from_lm_head else "wte.weight"
    # the matrix not picked and lm_head.bias (the tied head has no bias slot)
    # stay in ``sd`` and are reported unused (the JAX mapping drops them unreported)
    out: Params = {"wte": _pad_vocab(sd.pop(wte_key), cfg.vocab_size, wte_key)}
    # HF GPT-J registers the mask and rotary tables as buffers in some versions
    for k in [k for k in sd if k.endswith(("attn.bias", "attn.masked_bias",
                                           "embed_positions.weight"))]:
        sd.pop(k)
    _norms(sd, out, "ln_f", "ln_f")
    rows = None
    if cfg.rotary:
        rows = rotary_rows(cfg.n_heads, cfg.head_dim, cfg.rotary_dim or cfg.head_dim)
    for i in range(cfg.n_layers):
        h, b = f"h.{i}.", f"blocks.{i}."
        _norms(sd, out, h + "ln_1", b + "ln_1")
        q, k, v = (sd.pop(f"{h}attn.{n}_proj.weight") for n in "qkv")
        if rows is not None:
            q, k = q[rows], k[rows]
        out[b + "qkv.weight"] = torch.cat([q, k, v])
        out[b + "qkv.bias"] = q.new_zeros(q.shape[0] + k.shape[0] + v.shape[0])
        out[b + "attn_out.weight"] = sd.pop(h + "attn.out_proj.weight")
        out[b + "attn_out.bias"] = q.new_zeros(out[b + "attn_out.weight"].shape[0])
        for src, dst in (("mlp.fc_in", "mlp_in"), ("mlp.fc_out", "mlp_out")):
            out[f"{b}{dst}.weight"] = sd.pop(f"{h}{src}.weight")
            out[f"{b}{dst}.bias"] = sd.pop(f"{h}{src}.bias")
    return out, sorted(sd)


def params_from_state_dict(sd: Mapping[str, Any], cfg: Any, **kw) -> Tuple[Params, List[str]]:
    """Dispatch on the state dict's key signature (GPT-2 vs GPT-J naming)."""
    keys = set(_strip_prefix(sd))
    if any(".attn.c_attn." in k for k in keys):
        if kw:
            raise TypeError(f"GPT-2 mapping takes no options, got {kw}")
        return gpt2_params_from_state_dict(sd, cfg)
    if any(".attn.q_proj." in k for k in keys):
        return gptj_params_from_state_dict(sd, cfg, **kw)
    raise ValueError(
        "unrecognized state-dict family: expected HF GPT-2 (attn.c_attn) or "
        "GPT-J (attn.q_proj) key naming; got keys like "
        + ", ".join(sorted(keys)[:5])
    )


def validate_against(params: Mapping[str, torch.Tensor], template: torch.nn.Module) -> None:
    """Shape-check a mapping against the model's own ``state_dict`` (a
    meta-device model will do), naming every mismatched entry: a wrong
    preset fails here, not as a shape error deep in a forward."""
    want = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    problems = []
    for k in sorted(set(params) | set(want)):
        if k not in params:
            problems.append(f"missing {k}")
        elif k not in want:
            problems.append(f"unexpected {k}")
        elif tuple(params[k].shape) != want[k]:
            problems.append(f"{k}: got {tuple(params[k].shape)}, model wants {want[k]}")
    if problems:
        raise ValueError(
            "pretrained state dict does not match this model preset:\n  "
            + "\n  ".join(problems)
        )
