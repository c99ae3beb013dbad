"""Resilience: the kill-replay crash harness.

Counterpart of ``saturn_tpu/resilience/__init__.py``, so far its
:mod:`~saturn_tpu_torch.resilience.crash` part. Fault injection, fleet
health and elastic replanning are later items (``ROADMAP.md``).
"""

from saturn_tpu_torch.resilience.crash import (
    KILL_POINTS,
    CrashInjector,
    SimulatedKill,
    run_to_kill,
)

__all__ = ["KILL_POINTS", "CrashInjector", "SimulatedKill", "run_to_kill"]
