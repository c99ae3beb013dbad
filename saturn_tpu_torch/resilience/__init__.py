"""Resilience: fault injection, fleet health, elastic replanning, chaos
campaigns and the kill-replay crash harness.

Counterpart of ``saturn_tpu/resilience/__init__.py``, its batch half on
one host:

- :mod:`~saturn_tpu_torch.resilience.faults`: deterministic, seeded fault
  injection (device loss, block preemption, stragglers, transient crashes,
  the training-health faults), also from ``SATURN_TPU_FAULTS``;
- :mod:`~saturn_tpu_torch.resilience.health`: per-device liveness and
  latency fed by the engine, typed :class:`TopologyChange` events;
- :mod:`~saturn_tpu_torch.resilience.replan`: on a shrink or grow, the
  topology of the survivors and a plan for it under a recovery policy;
- :mod:`~saturn_tpu_torch.resilience.chaos`: seeded health-fault
  campaigns with kill-replay;
- :mod:`~saturn_tpu_torch.resilience.crash`: the kill-replay harness.

The grow coordinator, defragmentation waves and network chaos go with the
service (``ROADMAP.md``).
"""

from saturn_tpu_torch.resilience.chaos import (
    HEALTH_FAULT_CLASSES,
    CampaignResult,
    CampaignSpec,
    campaign_schedule,
    compare_checkpoints,
    run_campaign,
)
from saturn_tpu_torch.resilience.crash import (
    KILL_POINTS,
    CrashInjector,
    SimulatedKill,
    run_to_kill,
)
from saturn_tpu_torch.resilience.faults import (
    FaultEvent,
    FaultInjector,
    FaultKind,
    PreemptedError,
    seeded_schedule,
)
from saturn_tpu_torch.resilience.health import DeviceHealth, FleetHealthMonitor, TopologyChange
from saturn_tpu_torch.resilience.replan import RECOVERY_POLICIES, ElasticReplanner

__all__ = [
    "KILL_POINTS",
    "CrashInjector",
    "SimulatedKill",
    "run_to_kill",
    "FaultEvent",
    "FaultInjector",
    "FaultKind",
    "PreemptedError",
    "seeded_schedule",
    "DeviceHealth",
    "FleetHealthMonitor",
    "TopologyChange",
    "ElasticReplanner",
    "RECOVERY_POLICIES",
    "HEALTH_FAULT_CLASSES",
    "CampaignSpec",
    "CampaignResult",
    "campaign_schedule",
    "run_campaign",
    "compare_checkpoints",
]
