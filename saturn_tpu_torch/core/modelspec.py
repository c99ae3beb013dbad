"""ModelSpec: the model contract techniques consume.

Counterpart of ``saturn_tpu/core/modelspec.py``, in PyTorch's idiom: the
"params" a spec's functions take is the ``nn.Module`` that ``init_fn``
builds, and ``abstract_init`` builds it on the meta device (shapes and
dtypes, no storage).

- ``init_fn(generator, device) -> nn.Module``: weights drawn from the CPU
  ``torch.Generator`` (so one seed gives the same weights on every device),
  or a pretrained model's weights, then moved to ``device``.
- ``fill_fn(model, generator)``: writes those initial weights into a model
  whose parameters are already allocated (``init_fn`` allocates and calls
  it; host offload calls it on a model bound to its host buffers).
- ``apply_fn(model, tokens) -> logits``.
- ``hidden_fn(model, tokens) -> final hidden states`` (pre-head forward).
- ``fused_loss_fn(model, tokens) -> loss``: the model's standard objective
  computed with a fused head+loss; used only when the task's loss carries a
  ``supports_fused_head`` tag equal to ``fused_loss_objective``.
  ``fused_loss_parts_fn`` is the same as ``(loss_sum, valid_count)``.
- ``apply_with_aux_fn(model, tokens) -> (logits, aux_loss)`` for models with
  an auxiliary training loss.
- ``stacked_model_fn(n, device) -> nn.Module`` and ``stacked_loss_fn(model,
  tokens, loss_fn=None) -> (n,) losses``: the model with every parameter
  stacked on a leading member axis, and its per-member losses of (n, B, T)
  tokens (the fused head where ``loss_fn`` is None), for fused stacking
  (``parallel/fused.py``). A spec without them does not fuse.
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
    #: ``(model, generator) -> None``: the initial weights into an allocated model.
    fill_fn: Optional[Callable[[Any, Any], None]] = None
    #: ``(n, device) -> nn.Module`` with every parameter (n, *shape).
    stacked_model_fn: Optional[Callable[[int, Any], Any]] = None
    #: ``(stacked model, (n, B, T) tokens, loss_fn=None) -> (n,) losses``.
    stacked_loss_fn: Optional[Callable[..., Any]] = None

    def abstract_init(self):
        """The model on the meta device: every parameter's shape and dtype,
        no storage and no random draws."""
        if self.meta_init_fn is None:
            raise NotImplementedError("this ModelSpec has no meta-device init")
        return self.meta_init_fn()
