"""BERT-class encoder family: bidirectional transformer + masked-LM objective.

Counterpart of ``saturn_tpu/models/bert.py``. The encoder is the GPT-2 stack
(``models/gpt2.py``) with ``causal=False``, so techniques see the same
parameter structure. Masking is static-positional (every ``MASK_STRIDE``-th
position): the mask derives from the position alone, so the loss and the
forward agree on which positions are masked with no random state.

The presets live in ``BERT_PRESETS`` and build through
``gpt2.spec_for``; the GPT-2 preset table is left as it is (the JAX module
adds its encoder presets to it at import instead).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from saturn_tpu_torch.core.modelspec import ModelSpec
from saturn_tpu_torch.models import gpt2

MASK_STRIDE = 7   # ~14% of positions masked, close to BERT's 15%
MASK_OFFSET = 3

BERT_PRESETS: Dict[str, Dict[str, Any]] = {
    "bert-test-tiny": dict(
        d_model=64, n_layers=2, n_heads=4, vocab_size=256, seq_len=64,
    ),
    "bert-base": dict(d_model=768, n_layers=12, n_heads=12),
    "bert-large": dict(d_model=1024, n_layers=24, n_heads=16),
}


def _mask(T: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device) % MASK_STRIDE) == MASK_OFFSET


def mlm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy at the masked positions against the ORIGINAL tokens.

    Pairs with :func:`build_bert`, whose forward replaces the same positions
    with the [MASK] id; ``tokens`` is the unmasked batch the dataloader
    serves, as for the causal ``pretraining_loss``.
    """
    B, T = tokens.shape
    m = _mask(T, tokens.device)[None, :].float()
    ce = F.cross_entropy(logits.float().reshape(B * T, -1), tokens.reshape(-1).long(),
                         reduction="none").reshape(B, T)
    return (ce * m).sum() / (m.sum() * B)


# Fused-head tag (see models/loss.py): the MLM objective is ignore-index CE
# over the masked positions, what ops/ce.py computes when the other
# positions carry label -1.
mlm_loss.supports_fused_head = "mlm"


def build_bert(name: str = "bert-base", **overrides) -> ModelSpec:
    """Encoder ModelSpec for ``Task(get_model=...)``; train with :func:`mlm_loss`.

    The top vocab id serves as [MASK] and must never occur in the data: pair
    BERT tasks with ``make_lm_dataset(..., reserved_ids=1)``. The [MASK]
    substitution is applied inside every forward entry point.
    """
    if name not in BERT_PRESETS:
        raise KeyError(f"unknown BERT preset {name!r}; options: {list(BERT_PRESETS)}")
    kw = dict(BERT_PRESETS[name], causal=False)
    kw.update(overrides)
    cfg = gpt2.resolve_attention(gpt2.GPT2Config(name=name, **kw))
    mask_id = cfg.vocab_size - 1

    def mask_tokens(tokens):
        return torch.where(_mask(tokens.shape[-1], tokens.device)[None, :],
                           torch.full_like(tokens, mask_id), tokens)

    def mlm_labels(tokens):
        # the fused MLM loss: hidden states of the MASKED input against the
        # original tokens, the unmasked positions ignored through label -1
        return torch.where(_mask(tokens.shape[-1], tokens.device)[None, :],
                           tokens.to(torch.int32), -1)

    return gpt2.spec_for(cfg, inputs_fn=mask_tokens, labels_fn=mlm_labels, objective="mlm")
