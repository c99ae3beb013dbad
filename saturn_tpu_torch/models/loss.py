"""Pretraining loss: next-token cross-entropy over the logits, in fp32.

Counterpart of ``saturn_tpu/models/loss.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pretraining_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits[:, :-1] predict tokens[:, 1:]; mean over B * (T - 1) targets."""
    V = logits.shape[-1]
    return F.cross_entropy(
        logits[:, :-1, :].reshape(-1, V).float(),
        tokens[:, 1:].reshape(-1).long(),
    )


# Objective tag matched against ``ModelSpec.fused_loss_objective``: an
# executor may compute this exact loss through a model's fused head+loss
# instead of materializing logits.
pretraining_loss.supports_fused_head = "causal-lm"
