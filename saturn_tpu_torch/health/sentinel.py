"""Numeric-health sentinel: screening every step's loss of every interval.

Counterpart of ``saturn_tpu/health/sentinel.py``. A technique's ``execute``
already reads the interval's whole per-step loss vector back in its one
host sync (``parallel/spmd_base.py``); the sentinel folds that vector in
float32 on the host (``isfinite`` plus an EWMA spike score) into the JAX
package's fixed-shape 6-float report, with no extra sync and no per-step
launch. The JAX fold is a jitted ``lax.scan`` on the device; the report is
the same (``tests/test_torch_health.py``). A fault raises a
:class:`NumericFaultError` before the interval's checkpoint is written, so
a NaN at step 3 of an interval never reaches a checkpoint.

Fault taxonomy (the ``cause`` on :class:`NumericFaultError`):

- ``nonfinite`` — any step's loss is NaN/Inf (always checked);
- ``loss_spike`` — a finite loss exceeded ``spike_factor x`` the running
  EWMA after ``warmup_steps`` folded steps (off by default:
  ``spike_factor <= 0`` disables the score — divergence thresholds are
  workload policy, non-finiteness is not).

The EWMA carry ``[ewma, steps]`` is kept between intervals on
``task._sentinel_carry`` and only advanced when the interval was healthy:
a faulted interval's carry is discarded with the rest of its state, so the
retry folds from exactly the pre-fault statistics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

#: ``cause`` values (also the fold's kind codes 1 / 2).
CAUSE_NONFINITE = "nonfinite"
CAUSE_SPIKE = "loss_spike"
_KIND_TO_CAUSE = {1: CAUSE_NONFINITE, 2: CAUSE_SPIKE}

#: Report vector layout (shape ``(6,)`` float32).
REP_EWMA = 0          # post-interval EWMA (healthy steps only)
REP_STEPS = 1         # total healthy steps folded, across intervals
REP_BAD_COUNT = 2     # bad steps in THIS interval
REP_FIRST_BAD = 3     # interval-relative offset of the first bad step (-1)
REP_FIRST_KIND = 4    # kind code of the first bad step (0 = none)
REP_LAST_LOSS = 5     # the interval's final loss (the old bare readback)


class NumericFaultError(RuntimeError):
    """An interval's losses failed the sentinel's numeric screen.

    Raised from the technique's ``execute`` BEFORE the interval's checkpoint
    write and before its state is kept live — a faulted interval never
    becomes durable state, so the last checkpoint stays the rollback target.
    Structured fields drive the guardian's per-cause policy and the
    quarantine skip-list.
    """

    def __init__(
        self,
        job: str,
        window: int,
        cause: str,
        step: Optional[int] = None,
        loss: Optional[float] = None,
        batch_indices: Tuple[int, ...] = (),
        bad_count: int = 0,
    ):
        self.job = job
        self.window = window
        self.cause = cause
        self.step = step
        self.loss = loss
        self.batch_indices = tuple(int(i) for i in batch_indices)
        self.bad_count = int(bad_count)
        super().__init__(
            f"numeric fault in job {job}: {cause} at window {window} "
            f"(interval step {step}, loss {loss!r}, "
            f"{self.bad_count} bad step(s), "
            f"dataset batches {list(self.batch_indices)})"
        )


@dataclass(frozen=True)
class SentinelConfig:
    """Sentinel policy knobs (resolved once per interval).

    ``spike_factor <= 0`` disables the EWMA spike score; non-finiteness is
    always screened while ``enabled``.
    """

    enabled: bool = True
    spike_factor: float = 0.0
    ewma_alpha: float = 0.3
    warmup_steps: int = 8

    @classmethod
    def from_env(cls) -> "SentinelConfig":
        """``SATURN_TPU_SENTINEL`` (0/off disables),
        ``SATURN_TPU_SENTINEL_SPIKE`` (factor, 0 = off),
        ``SATURN_TPU_SENTINEL_ALPHA``, ``SATURN_TPU_SENTINEL_WARMUP``."""
        raw = os.environ.get("SATURN_TPU_SENTINEL", "1").strip().lower()
        enabled = raw not in ("0", "off", "false", "no")
        return cls(
            enabled=enabled,
            spike_factor=float(
                os.environ.get("SATURN_TPU_SENTINEL_SPIKE", "0") or 0.0
            ),
            ewma_alpha=float(
                os.environ.get("SATURN_TPU_SENTINEL_ALPHA", "0.3") or 0.3
            ),
            warmup_steps=int(
                os.environ.get("SATURN_TPU_SENTINEL_WARMUP", "8") or 8
            ),
        )


def get_config() -> SentinelConfig:
    """The sentinel's policy, read from the environment at each interval."""
    return SentinelConfig.from_env()


def carry_init() -> np.ndarray:
    """Fresh EWMA carry ``[ewma, steps]``."""
    return np.zeros(2, dtype=np.float32)


def fold(carry: Any, losses: Any, cfg: SentinelConfig) -> np.ndarray:
    """Fold the interval's flattened per-step loss vector into the (6,)
    float32 report, step by step in float32 (the JAX fold's arithmetic).
    ``carry`` is the (2,) carry ``[ewma, steps]``."""
    f32 = np.float32
    carry = np.asarray(carry, dtype=f32).reshape(2)
    losses = np.asarray(losses, dtype=f32).reshape(-1)
    alpha, beta = f32(cfg.ewma_alpha), f32(1.0 - cfg.ewma_alpha)
    spike_factor, warmup = f32(cfg.spike_factor), f32(cfg.warmup_steps)
    ewma, steps = carry[0], carry[1]
    bad, first_off, first_kind = f32(0.0), f32(-1.0), f32(0.0)
    for idx, x in enumerate(losses):
        finite = bool(np.isfinite(x))
        spike = (cfg.spike_factor > 0.0 and finite and steps >= warmup
                 and ewma > 0.0 and x > spike_factor * ewma)
        kind = f32(1.0) if not finite else f32(2.0) if spike else f32(0.0)
        if kind > 0.0:
            if bad == 0.0:
                first_off, first_kind = f32(idx), kind
            bad += f32(1.0)
        else:
            # only healthy steps advance the running statistics: a bad step
            # must not drag the EWMA toward the value that tripped it
            ewma = alpha * x + beta * ewma if steps > 0.0 else x
            steps += f32(1.0)
    last = losses[-1] if losses.size else f32(np.nan)
    return np.array([ewma, steps, bad, first_off, first_kind, last], dtype=f32)


def inspect(report: np.ndarray) -> Optional[Tuple[str, int, int]]:
    """Host-side report decode: ``(cause, first_bad_offset, bad_count)`` on
    a fault, ``None`` when the interval is numerically healthy."""
    bad = int(report[REP_BAD_COUNT])
    if bad <= 0:
        return None
    cause = _KIND_TO_CAUSE.get(int(report[REP_FIRST_KIND]), CAUSE_NONFINITE)
    return cause, int(report[REP_FIRST_BAD]), bad


def poison_overrides(
    plan: Dict[str, Any],
    n: int,
    dataset_index_of: Callable[[int], int],
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode a fault injector's numeric plan into ``(positions, values)``
    to overwrite in the interval's OBSERVED loss vector.

    ``plan["steps"]`` keys interval-relative step offsets; ``plan["batches"]``
    keys dataset indices (persistent poisoning — the fault follows the batch
    through rollbacks and cursor moves, which is what makes the quarantine
    path deterministic). Injection happens at the observation level only:
    the train state itself is never corrupted, so the post-rollback retry's
    trajectory is genuinely the fault-free one.
    """
    if not plan:
        return None
    steps = plan.get("steps") or {}
    batches = plan.get("batches") or {}
    pos, vals = [], []
    for j in range(int(n)):
        v = steps.get(j)
        if v is None and batches:
            v = batches.get(dataset_index_of(j))
        if v is not None:
            pos.append(j)
            vals.append(v)
    if not pos:
        return None
    return (
        np.asarray(pos, dtype=np.int32),
        np.asarray(vals, dtype=np.float32),
    )
