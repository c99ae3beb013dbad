"""Resilience: fault injection, fleet health, elastic replanning, chaos
campaigns and the kill-replay crash harness.

Counterpart of ``saturn_tpu/resilience/__init__.py`` on one host:

- :mod:`~saturn_tpu_torch.resilience.faults`: deterministic, seeded fault
  injection (device loss, block preemption, stragglers, transient crashes,
  the training-health faults), also from ``SATURN_TPU_FAULTS``;
- :mod:`~saturn_tpu_torch.resilience.health`: per-device liveness and
  latency fed by the engine, typed :class:`TopologyChange` events;
- :mod:`~saturn_tpu_torch.resilience.replan`: on a shrink or grow, the
  topology of the survivors and a plan for it under a recovery policy;
  the defragmentation waves of the online service;
- :mod:`~saturn_tpu_torch.resilience.grow`: the service's grow events,
  backlog drains and two-phase defragmentation waves;
- :mod:`~saturn_tpu_torch.resilience.chaos`: seeded health-fault
  campaigns with kill-replay;
- :mod:`~saturn_tpu_torch.resilience.crash`: the kill-replay harness;
- :mod:`~saturn_tpu_torch.resilience.netchaos`: a seeded frame-aware TCP
  proxy that attacks the wire in front of the service's gateway.
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
from saturn_tpu_torch.resilience.grow import GrowCoordinator, default_resident_bytes
from saturn_tpu_torch.resilience.health import DeviceHealth, FleetHealthMonitor, TopologyChange
from saturn_tpu_torch.resilience.netchaos import (NET_FAULT_CLASSES, NetChaosProxy, NetChaosSpec,
                                                  NetChaosStats, single_fault_spec)
from saturn_tpu_torch.resilience.replan import (RECOVERY_POLICIES, DefragMove, DefragWave,
                                                ElasticReplanner, plan_defrag_wave)

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
    "DefragMove",
    "DefragWave",
    "plan_defrag_wave",
    "GrowCoordinator",
    "default_resident_bytes",
    "HEALTH_FAULT_CLASSES",
    "CampaignSpec",
    "CampaignResult",
    "campaign_schedule",
    "run_campaign",
    "compare_checkpoints",
    "NET_FAULT_CLASSES",
    "NetChaosSpec",
    "NetChaosStats",
    "NetChaosProxy",
    "single_fault_spec",
]
