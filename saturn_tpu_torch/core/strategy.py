"""Strategy: the (technique, device count, params, runtime) tuple the solver picks.

Counterpart of ``saturn_tpu/core/strategy.py``. The allocation unit is a
power-of-two number of devices forming one aligned block (``core/mesh.py``).
It carries the JAX package's co-scheduling and fused-stacking fields
(``host_fraction``, ``fused_per_batch_time``, ``bubble_fraction``) and its
``interpolated`` and ``static_prior`` flags. The port has no shardflow, so
the digital twin's oracle (``twin/oracle.py``) is the one producer of
``static_prior`` strategies.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class Techniques(enum.Enum):
    """Built-in parallelism technique families (the JAX package's enum;
    the port ships DP, FSDP, TENSOR and OFFLOAD, the rest are in
    ``ROADMAP.md``)."""

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
    # An estimate, not a measured trial: the elastic replanner synthesizes a
    # strategy at a size never profiled from the Amdahl fit over the measured
    # ones (``resilience/replan.py``). Cleared the first time a realized
    # interval lands on it (``Task.apply_realized_feedback``); the profile
    # cache takes its time only after that.
    interpolated: bool = field(default=False)
    # A prior, not a trial: the twin's analytic oracle priced it (the JAX
    # package's shardflow cold-start priors carry the same flag). Counted
    # as ``n_static_prior`` by the anytime solver, kept by a strategy the
    # replanner synthesizes from priors alone, and cleared by the first
    # realized interval (``Task.apply_realized_feedback``).
    static_prior: bool = field(default=False)
    # the profile-cache entry this strategy was read from or written to, and
    # its directory: the orchestrator upgrades it with realized times
    cache_key: Optional[str] = None
    cache_dir: Optional[str] = None
    # Fraction of a steady-state batch spent on host work (staging the
    # batch) rather than device compute, in [0, 1], measured by the trial
    # (``SPMDTechnique._try_config``). The solver's co-location term reads
    # it: 0.0 (unmeasured) predicts no interleave win, so such a strategy is
    # never co-scheduled.
    host_fraction: float = 0.0
    # Seconds per lockstep step of a fused stack this task belongs to (every
    # member advances one batch per lockstep step), measured by
    # ``trial_runner.evaluator.profile_fused_group`` and updated by the
    # engine's fused launcher (EWMA). None: never profiled, and the solver
    # does not fuse on guesswork.
    fused_per_batch_time: Optional[float] = None
    # Device-idle fraction of a step from the schedule's bubble (pipeline
    # warm-up and cool-down) a co-scheduled partner could fill. 0.0 for dp
    # and offload, the port's techniques.
    bubble_fraction: float = 0.0
    # Peak device memory of the trial that measured this strategy, in bytes
    # (None: not measured, a cache entry of an earlier schema). The fusion
    # gate takes the activations a stack member adds from it.
    peak_bytes: Optional[float] = None

    def __post_init__(self) -> None:
        if self.apportionment < 1:
            raise ValueError("apportionment must be a positive device count")

    @property
    def feasible(self) -> bool:
        return self.params is not None and self.executor is not None

    @property
    def technique(self) -> Optional[Techniques]:
        return getattr(self.executor, "technique", None)
