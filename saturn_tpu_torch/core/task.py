"""Task and HParams: the job descriptors users hand to the system.

Counterpart of ``saturn_tpu/core/task.py``. A Task bundles lazy model and
dataset factories, a loss, hyperparameters, and the profiled ``strategies``
table the solver consumes. The data cursor has O(1) random access
(``Dataset.batch(i)``); checkpoints are the full train state written by the
executing technique (``utils/checkpoint.py``). The JAX package's quarantine
skip-list and live device state belong to its health guardian and fused
dispatch, which are later items here.
"""

from __future__ import annotations

import os
import secrets
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

from saturn_tpu_torch.core.strategy import Strategy

_OPTIMIZERS = ("adamw", "adam", "sgd")


@dataclass
class HParams:
    """Hyperparameters. Exactly one of ``epochs`` / ``batch_count`` must be
    set. ``optimizer`` is a name or a callable ``(params, lr) ->
    torch.optim.Optimizer``; ``kwargs`` are forwarded to ``get_model``."""

    lr: float = 1e-4
    epochs: Optional[int] = None
    batch_count: Optional[int] = None
    optimizer: Any = "adamw"
    batch_size: Optional[int] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if (self.epochs is None) == (self.batch_count is None):
            raise ValueError(
                "exactly one of epochs / batch_count must be specified"
            )
        if isinstance(self.optimizer, str) and self.optimizer not in _OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}; use one of {_OPTIMIZERS} "
                "or pass a callable (params, lr) -> torch.optim.Optimizer"
            )

    def make_optimizer(self, params: Iterable[Any]):
        """A torch optimizer with optax's math for the named optimizers:
        ``adamw`` is ``optax.adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8, weight
        decay 1e-4 on every parameter — torch's own AdamW default is 0.01),
        ``adam`` is ``optax.adam(lr)``, ``sgd`` is ``optax.sgd(lr)``."""
        import torch

        if callable(self.optimizer):
            return self.optimizer(params, self.lr)
        if self.optimizer == "adamw":
            return torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
        if self.optimizer == "adam":
            return torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        return torch.optim.SGD(params, lr=self.lr)


class Task:
    """One training job in the batch."""

    def __init__(
        self,
        get_model: Callable[..., Any],
        get_dataloader: Callable[[], Any],
        loss_fn: Callable[[Any, Any], Any],
        hparams: HParams,
        chip_range: Optional[List[int]] = None,
        hints: Optional[Dict[str, Any]] = None,
        name: Optional[str] = None,
        save_dir: str = "saturn_ckpts",
    ):
        self._get_model = get_model
        self._get_dataloader = get_dataloader
        self.loss_fn = loss_fn
        self.hparams = hparams
        self.chip_range = chip_range  # allowed block sizes; None = all
        self.hints = dict(hints or {})
        self.name = name if name is not None else secrets.token_hex(8)
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

        self._dataset = None
        self.epoch_length = len(self.get_dataset())
        if hparams.epochs is not None:
            self.total_batches = self.epoch_length * hparams.epochs
        else:
            self.total_batches = hparams.batch_count

        self.current_batch = 0  # data cursor, persists across intervals
        self.strategies: Dict[int, Strategy] = {}
        self.selected_strategy: Optional[Strategy] = None
        # (strategy, realized per-batch seconds) noted by the executor and
        # folded in by the orchestrator between intervals
        self._pending_realized: Optional[tuple] = None
        # the most recent interval as the executing technique measured it:
        # per-step losses (host floats) and steady-state seconds per batch
        self.last_losses: List[float] = []
        self.last_per_batch_s: Optional[float] = None

    # ------------------------------------------------------------------ model
    def get_model(self, **overrides):
        """Instantiate the ModelSpec (never cached on the task). ``overrides``
        come from a technique's autotune config (e.g. ``remat=True``), merged
        over ``hparams.kwargs``."""
        kw = dict(self.hparams.kwargs)
        kw.update(overrides)
        return self._get_model(**kw)

    # ------------------------------------------------------------------- data
    def get_dataset(self):
        if self._dataset is None:
            self._dataset = self._get_dataloader()
        return self._dataset

    def dataset_index(self, step: int) -> int:
        return step % max(self.epoch_length, 1)

    def batch_at(self, step: int):
        """O(1) random access to the batch for global step ``step``."""
        return self.get_dataset().batch(self.dataset_index(step))

    def cursor_for_step(self, step: int) -> int:
        """The data cursor for a restored global step."""
        return step % max(self.epoch_length, 1)

    # ------------------------------------------------------------ checkpoints
    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.save_dir, f"{self.name}.pt")

    def has_ckpt(self) -> bool:
        return os.path.exists(self.ckpt_path)

    def clear_ckpt(self) -> None:
        if os.path.exists(self.ckpt_path):
            os.unlink(self.ckpt_path)

    # -------------------------------------------------------------- schedule
    def reconfigure(self, batch_count: int) -> None:
        """Advance the data cursor after an interval ran ``batch_count``."""
        self.current_batch = (self.current_batch + batch_count) % max(
            self.epoch_length, 1
        )

    def select_strategy(self, apportionment: int) -> None:
        self.selected_strategy = self.strategies[apportionment]

    # ------------------------------------------- profiled-vs-realized feedback
    EWMA_ALPHA = 0.7  # weight on the new measurement

    def note_realized_per_batch(self, per_batch_s: float) -> None:
        """Record the realized per-batch seconds of the selected strategy;
        called by the technique at the end of its interval."""
        if self.selected_strategy is not None and per_batch_s > 0.0:
            self._pending_realized = (self.selected_strategy, per_batch_s)

    def apply_realized_feedback(self) -> Optional[tuple]:
        """Fold the noted measurement into the executed strategy (EWMA) and
        rescale its remaining runtime; never-executed siblings are set to
        their trial profile times the executed strategy's realized/trial
        ratio (the JAX package's rule). Returns (old, new) per-batch seconds,
        or None when nothing was noted."""
        pending, self._pending_realized = self._pending_realized, None
        if pending is None:
            return None
        strat, realized = pending
        if not strat.feasible:
            return None
        for s in self.strategies.values():
            if s.feasible and getattr(s, "_trial_per_batch", None) is None:
                s._trial_per_batch = s.per_batch_time
        old = strat.per_batch_time
        strat.per_batch_time = (
            self.EWMA_ALPHA * realized + (1.0 - self.EWMA_ALPHA) * old
            if old > 0.0 else realized
        )
        strat._self_measured = True
        strat.runtime = strat.per_batch_time * max(self.total_batches, 0)
        trial_base = getattr(strat, "_trial_per_batch", 0.0) or 0.0
        if trial_base > 0.0:
            cum_ratio = strat.per_batch_time / trial_base
            for s in self.strategies.values():
                if (
                    s is not strat
                    and s.feasible
                    and not getattr(s, "_self_measured", False)
                    and (getattr(s, "_trial_per_batch", 0.0) or 0.0) > 0.0
                ):
                    s.per_batch_time = s._trial_per_batch * cum_ratio
                    s.runtime = s.per_batch_time * max(self.total_batches, 0)
        return old, strat.per_batch_time

    def feasible_strategies(self) -> Dict[int, Strategy]:
        return {g: s for g, s in self.strategies.items() if s.feasible}

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Task(name={self.name!r}, total_batches={self.total_batches}, "
            f"strategies={list(self.strategies)})"
        )
