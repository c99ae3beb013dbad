"""Strategy: the (technique, device count, params, runtime) tuple the solver picks.

Counterpart of ``saturn_tpu/core/strategy.py``. The allocation unit is a
power-of-two number of devices forming one aligned block (``core/mesh.py``).
The fields the JAX package adds for its profile cache, cost-model
interpolation, co-scheduling and fused stacking are later items.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class Techniques(enum.Enum):
    """Built-in parallelism technique families (the JAX package's enum;
    this slice ships DP only, the rest are in ``ROADMAP.md``)."""

    DP = 1
    FSDP = 2
    PIPELINE = 3
    OFFLOAD = 4
    TENSOR = 5
    RING = 6
    ULYSSES = 7
    EXPERT = 8
    SPILLED = 4     # aliases kept from the reference's spelling
    MEGATRON = 5


@dataclass
class Strategy:
    """One profiled execution option for a task.

    ``apportionment`` is the number of devices in the block; ``params`` the
    technique's autotuned knobs from ``BaseTechnique.search`` (None =
    infeasible); ``runtime`` the estimated *remaining* runtime in seconds,
    decremented by the forecast loop as batches complete.
    """

    executor: Any                      # BaseTechnique instance (or None = dummy)
    apportionment: int                 # number of devices (power of two)
    params: Optional[Dict[str, Any]]   # autotuned knobs; None = infeasible
    runtime: float                     # est. remaining runtime, seconds
    per_batch_time: float = field(default=0.0)  # seconds per batch (profiled)

    def __post_init__(self) -> None:
        if self.apportionment < 1:
            raise ValueError("apportionment must be a positive device count")

    @property
    def feasible(self) -> bool:
        return self.params is not None and self.executor is not None

    @property
    def technique(self) -> Optional[Techniques]:
        return getattr(self.executor, "technique", None)
