"""Chaos campaigns: seeded mixed health faults with kill-replay.

Counterpart of ``saturn_tpu/resilience/chaos.py``. The crash harness
(``resilience/crash.py``) kills the controller at journal barriers; the
sentinel and the guardian (``health/``) detect and recover from training
faults. A campaign composes both: a seeded schedule draws one event of
every health-fault class it names (a NaN loss, a loss spike, a poisoned
batch, a dispatch stall), optionally arms a simulated kill at the
``post-rollback`` barrier (just after a faulted task's quarantine records
became durable), and runs ``orchestrate`` again on the same journal
directory until the batch completes, as an operator's restart loop would.

What a campaign shows:

- no lost job: every task completes across the restarts;
- the quarantine survives the kill: the skip-list replayed from the journal
  keeps a restarted run off the poisoned batches;
- recovery bit for bit: a faulted task's final checkpoint equals that of a
  fault-free run over the same surviving batches, byte for byte (faults are
  injected into the observed losses, never into the train state).

The same seed gives the same campaign on every run.
"""

from __future__ import annotations

import logging
import os
import random
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from saturn_tpu_torch.resilience.crash import CrashInjector, SimulatedKill
from saturn_tpu_torch.resilience.faults import FaultEvent, FaultInjector, FaultKind

logger = logging.getLogger("saturn_tpu_torch")

#: The guardian's detection targets: a campaign draws one event of each
#: class its spec names.
HEALTH_FAULT_CLASSES = (
    FaultKind.NUMERIC_NAN,
    FaultKind.LOSS_SPIKE,
    FaultKind.BATCH_POISON,
    FaultKind.DISPATCH_STALL,
)


@dataclass(frozen=True)
class CampaignSpec:
    """One seeded campaign's shape.

    ``poison_range`` bounds the dataset indices batch poisoning may pick:
    keep it within the first interval's batches, so that the fault is
    observed (and small enough that quarantine never empties the dataset).
    ``stall_s`` is the injected dispatch wedge: pair it with a guardian
    whose watchdog deadline is below it, so that the watchdog ends the
    stall. ``max_intervals_hit`` defaults to 1: every fault lands in interval
    0, so the first rollback goes to the initial state, and a faulted run's
    final checkpoint compares exactly with a fault-free run that has the
    quarantine applied beforehand."""

    seed: int
    fault_classes: Tuple[str, ...] = HEALTH_FAULT_CLASSES
    kill_during_rollback: bool = False
    max_intervals_hit: int = 1     # faults land in intervals [0, hit)
    poison_range: int = 8
    poison_batches: int = 1
    stall_s: float = 0.3
    max_restarts: int = 8


@dataclass
class CampaignResult:
    """What one campaign did."""

    seed: int
    completed: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)
    restarts: int = 0
    kills: int = 0
    schedule: List[FaultEvent] = field(default_factory=list)
    quarantined: Dict[str, List[int]] = field(default_factory=dict)
    detached: List[str] = field(default_factory=list)


def campaign_schedule(task_names: List[str], spec: CampaignSpec) -> List[FaultEvent]:
    """One fault event per class in ``spec.fault_classes``, its target and
    timing drawn from the seed (the JAX package's draws, in its order): the
    same (names, spec) give the same schedule."""
    if not task_names:
        raise ValueError("campaign needs at least one task")
    rng = random.Random(spec.seed)
    hit = max(1, spec.max_intervals_hit)
    events: List[FaultEvent] = []
    for kind in spec.fault_classes:
        target = rng.choice(list(task_names))
        at = rng.randrange(hit)
        if kind in (FaultKind.NUMERIC_NAN, FaultKind.LOSS_SPIKE):
            events.append(FaultEvent(at, kind, task=target, step=rng.randrange(4)))
        elif kind == FaultKind.BATCH_POISON:
            n = min(spec.poison_batches, spec.poison_range)
            idx = tuple(sorted(rng.sample(range(spec.poison_range), n)))
            events.append(FaultEvent(at, kind, task=target, batches=idx))
        elif kind == FaultKind.DISPATCH_STALL:
            events.append(FaultEvent(at, kind, task=target, stall_s=spec.stall_s))
        else:
            raise ValueError(f"{kind!r} is not a health-fault class "
                             f"(use one of {HEALTH_FAULT_CLASSES})")
    return events


def run_campaign(
    tasks_factory: Callable[[], List[Any]],
    spec: CampaignSpec,
    workdir: str,
    guardian_config: Any = None,
    on_kill: Optional[Callable[[List[Any]], None]] = None,
    **orchestrate_kwargs,
) -> CampaignResult:
    """Run one seeded campaign to completion, restarting through kills.

    ``tasks_factory`` returns a fresh task list per call: each incarnation
    builds its tasks as a restarted process would, and the journal replay
    takes what was realized off their budgets. Keyword arguments go to
    ``orchestrate`` (``resume_dir``, ``fault_injector``, ``crash_barrier``
    and ``health_guardian`` are the harness's).

    The injector is built again for each incarnation, so a transient fault
    of an interval a restart runs again fires again: more chaos, the same
    invariants. ``guardian_config`` (a ``GuardianConfig``) builds a fresh
    guardian per incarnation: a restarted process keeps no policy state,
    only what the journal replays. ``on_kill(tasks)`` is called with the
    dead incarnation's tasks after a kill (the port keeps a task's train
    state and CUDA graphs on the task: the caller releases them there)."""
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.executor.orchestrator import orchestrate
    from saturn_tpu_torch.health import TrainingGuardian

    tasks = tasks_factory()
    schedule = campaign_schedule([t.name for t in tasks], spec)
    result = CampaignResult(seed=spec.seed, schedule=list(schedule))
    barrier = CrashInjector("post-rollback", hit=1).barrier if spec.kill_during_rollback \
        else None
    while True:
        guardian = (TrainingGuardian(config=guardian_config)
                    if guardian_config is not None else None)
        try:
            out = orchestrate(tasks, resume_dir=workdir,
                              fault_injector=FaultInjector(schedule=list(schedule)),
                              crash_barrier=barrier, health_guardian=guardian,
                              **orchestrate_kwargs)
        except SimulatedKill as e:
            traceback.clear_frames(e.__traceback__)  # the dead run's tensors
            result.kills += 1
            result.restarts += 1
            if result.restarts > spec.max_restarts:
                raise RuntimeError(f"campaign seed {spec.seed} exceeded "
                                   f"{spec.max_restarts} restarts — runaway kill loop")
            if on_kill is not None:
                on_kill(tasks)
            barrier = None  # the injector fired once; the process is "new"
            tasks = tasks_factory()
            logger.warning("chaos campaign (seed %d): killed at post-rollback — restart %d",
                           spec.seed, result.restarts)
            continue
        break
    result.completed = list(out["completed"])
    result.failed = dict(out["failed"])
    state = rmod.replay_batch_state(workdir)
    result.quarantined = dict(state.quarantined)
    result.detached = list(state.detached)
    return result


def _leaves(obj, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a checkpoint payload's nested dicts and lists."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def compare_checkpoints(dir_a: str, dir_b: str,
                        names: Optional[List[str]] = None) -> List[str]:
    """Byte-for-byte comparison of final checkpoints.

    Compares the ``{name}.pt`` checkpoints of both directories (every stem
    of ``dir_a`` when ``names`` is None; quarantine sidecars and temporary
    files are not checkpoints) leaf by leaf: each tensor by dtype, shape and
    raw bytes (strict enough for one flipped mantissa bit, and NaN-safe,
    which ``==`` is not), every other value by equality. Returns the
    mismatches as text; empty means identical."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    if names is None:
        stems = sorted(f[:-len(".pt")] for f in os.listdir(dir_a)
                       if f.endswith(".pt") and ".corrupt" not in f and ".tmp" not in f)
    else:
        stems = list(names)
    mismatches: List[str] = []
    for stem in stems:
        pa, pb = os.path.join(dir_a, f"{stem}.pt"), os.path.join(dir_b, f"{stem}.pt")
        if not os.path.exists(pb):
            mismatches.append(f"{stem}: missing from {dir_b}")
            continue
        a, b = dict(_leaves(ckpt.load(pa))), dict(_leaves(ckpt.load(pb)))
        if set(a) != set(b):
            mismatches.append(f"{stem}: key sets differ ({sorted(set(a) ^ set(b))})")
            continue
        for k in sorted(a):
            va, vb = a[k], b[k]
            if isinstance(va, torch.Tensor):
                if not isinstance(vb, torch.Tensor) or va.shape != vb.shape \
                        or va.dtype != vb.dtype:
                    mismatches.append(f"{stem}[{k}]: shape/dtype {tuple(va.shape)}/{va.dtype} "
                                      f"vs {tuple(getattr(vb, 'shape', ()))}/"
                                      f"{getattr(vb, 'dtype', type(vb))}")
                elif _raw(va) != _raw(vb):
                    mismatches.append(f"{stem}[{k}]: bytes differ")
            elif va != vb:
                mismatches.append(f"{stem}[{k}]: {va!r} vs {vb!r}")
    return mismatches


def _raw(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
