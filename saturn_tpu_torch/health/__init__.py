"""Training health: numeric-fault detection and recovery policy.

Counterpart of ``saturn_tpu/health/__init__.py``:

- :mod:`~saturn_tpu_torch.health.sentinel` screens every step's loss of
  every interval (folded on the host from the interval's one loss
  readback) and raises a structured ``NumericFaultError`` before the
  interval's checkpoint is written;
- :mod:`~saturn_tpu_torch.health.guardian` decides what follows a fault
  (``TrainingGuardian``: retry with backoff, quarantine the batches that
  fault again, evict past a budget), with the deadline rule of the
  engine's hung-launch watchdog (``HungDispatchError``).
"""

from saturn_tpu_torch.health.guardian import (
    HEALTH_EVENT_CODES,
    GuardianConfig,
    HungDispatchError,
    TrainingGuardian,
)
from saturn_tpu_torch.health.sentinel import NumericFaultError, SentinelConfig

__all__ = [
    "GuardianConfig",
    "HEALTH_EVENT_CODES",
    "HungDispatchError",
    "NumericFaultError",
    "SentinelConfig",
    "TrainingGuardian",
]
