"""Task and HParams: the job descriptors users hand to the system.

Counterpart of ``saturn_tpu/core/task.py``. A Task bundles lazy model and
dataset factories, a loss, hyperparameters, and the profiled ``strategies``
table the solver consumes. The data cursor has O(1) random access
(``Dataset.batch(i)``); checkpoints are the full train state written by the
executing technique (``utils/checkpoint.py``). ``_live_state`` keeps the
train state on the device between intervals that run the same bundle. The
quarantine skip-list (set by the health guardian) takes dataset indices out
of the training sequence; the cursor walks the surviving indices.
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
        ``adam`` is ``optax.adam(lr)``, ``sgd`` is ``optax.sgd(lr)``.

        On the card AdamW and Adam are built ``capturable``: their step
        counts live on the card, so a step reads nothing back to the host
        and a CUDA graph can capture it (``parallel/spmd_base.py``); the
        math is the same. SGD keeps no step count and takes no such flag.
        A callable's optimizer is the user's to make."""
        import torch

        if callable(self.optimizer):
            return self.optimizer(params, self.lr)
        params = list(params)
        on_card = bool(params) and params[0].is_cuda
        if self.optimizer == "sgd":
            return torch.optim.SGD(params, lr=self.lr)
        if self.optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-4, capturable=on_card)
        else:
            opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                   capturable=on_card)
        # torch warns once per instance when a capturable optimizer steps
        # outside a capture; here the eager steps (a window's warm-up, the
        # tail) use it so on purpose
        opt._warned_capturable_if_run_uncaptured = True
        return opt


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
        # Quarantine skip-list (health guardian): dataset indices excluded
        # from the training sequence. The cursor walks the SURVIVING
        # sequence — sorted non-quarantined indices — so ``batch_at``,
        # staging and the restore cursor agree on which batch step k is.
        self._quarantined: set = set()
        self._surviving: Optional[List[int]] = None  # cache, None = dirty
        # the health sentinel's EWMA carry [ewma, steps], advanced only by a
        # healthy interval (``health/sentinel.py``)
        self._sentinel_carry = None
        self.strategies: Dict[int, Strategy] = {}
        self.selected_strategy: Optional[Strategy] = None
        # Device train state from the most recent interval, keyed by the
        # executing bundle (task, config, devices): consecutive intervals
        # under an unchanged assignment skip the checkpoint read.
        self._live_state: Optional[tuple] = None
        # (strategy, realized per-batch seconds) noted by the executor and
        # folded in by the orchestrator between intervals
        self._pending_realized: Optional[tuple] = None
        # the strategy the most recent apply_realized_feedback measured: the
        # orchestrator writes its per-batch time to the profile cache
        self.last_feedback_strategy: Optional[Strategy] = None
        # the most recent interval as the executing technique measured it:
        # per-step losses (host floats) and steady-state seconds per batch
        self.last_losses: List[float] = []
        self.last_per_batch_s: Optional[float] = None

    def release_live_state(self) -> None:
        """Drop the cached device train state (frees device memory). Safe on
        a task that will run again: its next interval restores from the
        checkpoint."""
        self._live_state = None

    def release_compiled(self) -> None:
        """Release this task's bundles, CUDA graphs and graph memory pools in
        every technique that profiled it. Only for tasks that will not run
        again: a later interval would build and capture them anew."""
        seen = set()
        for strat in self.strategies.values():
            ex = getattr(strat, "executor", None)
            release = getattr(ex, "release_task", None)
            if release is not None and id(ex) not in seen:
                seen.add(id(ex))
                release(self.name)

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

    def batch_at(self, step: int):
        """O(1) random access to the batch for global step ``step``,
        skipping quarantined dataset indices."""
        return self.get_dataset().batch(self.dataset_index(step))

    # ------------------------------------------------------------- quarantine
    def quarantine_batches(self, indices) -> None:
        """Exclude dataset indices from the training sequence (the health
        guardian's skip-list). Refuses to quarantine the whole dataset — a
        job with no surviving batch is an eviction, not a skip."""
        add = {int(i) % max(self.epoch_length, 1) for i in indices}
        if len(self._quarantined | add) >= self.epoch_length:
            raise ValueError(
                f"task {self.name}: quarantining {sorted(add)} would leave "
                "no surviving batches"
            )
        self._quarantined |= add
        self._surviving = None

    def unquarantine_batches(self, indices=None) -> None:
        """Lift quarantine for ``indices`` (or all, when ``None``)."""
        if indices is None:
            self._quarantined.clear()
        else:
            self._quarantined -= {int(i) for i in indices}
        self._surviving = None

    @property
    def quarantined_batches(self) -> tuple:
        return tuple(sorted(self._quarantined))

    @property
    def surviving_epoch_length(self) -> int:
        """Epoch length after quarantine — the modulus for cursor math."""
        return self.epoch_length - len(self._quarantined)

    def _surviving_indices(self) -> List[int]:
        if self._surviving is None:
            q = self._quarantined
            self._surviving = [i for i in range(self.epoch_length) if i not in q]
        return self._surviving

    def dataset_index(self, step: int) -> int:
        """Map a cursor step to its dataset index through the skip-list."""
        if not self._quarantined:
            return step % max(self.epoch_length, 1)
        surviving = self._surviving_indices()
        return surviving[step % len(surviving)]

    def cursor_for_step(self, step: int) -> int:
        """The data cursor for a restored global step, on the surviving
        sequence."""
        return step % max(self.surviving_epoch_length, 1)

    # ------------------------------------------------------------ checkpoints
    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.save_dir, f"{self.name}.pt")

    def has_ckpt(self) -> bool:
        """Whether the checkpoint exists, once its in-flight write is done."""
        from saturn_tpu_torch.utils import checkpoint as ckpt

        return ckpt.exists(self.ckpt_path)

    def clear_ckpt(self) -> None:
        if self.has_ckpt():
            os.unlink(self.ckpt_path)

    # -------------------------------------------------------------- schedule
    def reconfigure(self, batch_count: int) -> None:
        """Advance the data cursor after an interval ran ``batch_count``."""
        self.current_batch = (self.current_batch + batch_count) % max(
            self.surviving_epoch_length, 1
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
        self.last_feedback_strategy = strat
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
