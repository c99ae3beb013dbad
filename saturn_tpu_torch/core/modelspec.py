"""ModelSpec: the model contract techniques consume.

Counterpart of ``saturn_tpu/core/modelspec.py``, in PyTorch's idiom: the
"params" a spec's functions take is the ``nn.Module`` that ``init_fn``
builds, and ``abstract_init`` builds it on the meta device (shapes and
dtypes, no storage).

- ``init_fn(generator, device) -> nn.Module``: weights drawn from the CPU
  ``torch.Generator`` (so one seed gives the same weights on every device),
  then moved to ``device``.
- ``apply_fn(model, tokens) -> logits``.
- ``hidden_fn(model, tokens) -> final hidden states`` (pre-head forward).
- ``fused_loss_fn(model, tokens) -> loss``: the model's standard objective
  computed with a fused head+loss; used only when the task's loss carries a
  ``supports_fused_head`` tag equal to ``fused_loss_objective``.
  ``fused_loss_parts_fn`` is the same as ``(loss_sum, valid_count)``.
- ``apply_with_aux_fn(model, tokens) -> (logits, aux_loss)`` for models with
  an auxiliary training loss.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass
class ModelSpec:
    init_fn: Callable[..., Any]
    apply_fn: Callable[[Any, Any], Any]
    config: Any
    hints: Dict[str, Any] = field(default_factory=dict)
    apply_with_aux_fn: Optional[Callable[[Any, Any], Tuple[Any, Any]]] = None
    fused_loss_fn: Optional[Callable[[Any, Any], Any]] = None
    fused_loss_parts_fn: Optional[Callable[[Any, Any], Any]] = None
    fused_loss_objective: Optional[str] = None
    hidden_fn: Optional[Callable[[Any, Any], Any]] = None
    #: ``() -> nn.Module`` on the meta device; set by the model factory.
    meta_init_fn: Optional[Callable[[], Any]] = None

    def abstract_init(self):
        """The model on the meta device: every parameter's shape and dtype,
        no storage and no random draws."""
        if self.meta_init_fn is None:
            raise NotImplementedError("this ModelSpec has no meta-device init")
        return self.meta_init_fn()
