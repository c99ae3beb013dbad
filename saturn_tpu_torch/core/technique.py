"""BaseTechnique: the two-method plugin contract every parallelism executor obeys.

Counterpart of ``saturn_tpu/core/technique.py``: a technique can (a) autotune
and profile itself on a given block of devices (``search``) and (b) run a
bounded number of batches on a block, resuming from and writing checkpoints
(``execute``). ``devices`` is a list of ``torch.device``. ``search`` reports
steady-state seconds per batch, warm-up excluded, and rejects configurations
whose measured peak device memory does not fit.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Sequence, Tuple


class BaseTechnique(abc.ABC):
    """Abstract parallelism technique."""

    #: Optional friendly name used when registering into the library.
    name: str = "base"

    #: Which built-in technique family this is (``Techniques`` member), None
    #: for user-defined plugins.
    technique = None  # type: ignore[assignment]  # Optional[Techniques]

    @abc.abstractmethod
    def execute(
        self,
        task: Any,
        devices: Sequence[Any],
        tid: int,
        override_batch_count: Optional[int] = None,
    ) -> None:
        """Train ``task`` on ``devices`` for ``override_batch_count`` batches,
        resuming from the task's checkpoint if one exists and writing the full
        train state (params, optimizer state, step) at the end."""

    @abc.abstractmethod
    def search(
        self,
        task: Any,
        devices: Sequence[Any],
        tid: int,
    ) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """Autotune on ``devices``; return ``(params, per_batch_time)``, or
        ``(None, None)`` when the technique cannot run the task there."""
