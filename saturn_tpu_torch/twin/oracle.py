"""A static cost and memory oracle: priors in place of execution.

Counterpart of ``saturn_tpu/twin/oracle.py``, the same seeded analytic
model draw for draw. The twin runs no trials, so every strategy comes from
it:

- **cost**: a per-family Amdahl and communication roofline,
  ``pbt(g) = serial + parallel / g + comm * log2(g)``, with a DCN penalty on
  the communication term once a block spans slices; deterministic from
  ``(seed, family)``.
- **memory**: ``peak(g) = 3 * model_bytes / g + activation_bytes`` (params,
  grads and optimizer state sharded, activations replicated); a size whose
  peak overflows the virtual devices' memory gets no strategy, before
  admission sees the task.

Its strategies carry ``static_prior=True``, so twin plans are auditable as
built on priors, and the simulated realized feedback clears the flag
through ``apply_realized_feedback``, the orchestrator's path.

:class:`VirtualTechnique` must never execute (``twin/engine.py`` advances
the clock instead), and ``technique_names=["twin-virtual"]`` leaves the
admission controller's roster empty, so no trial sweep can start.
"""

from __future__ import annotations

import math
import random
import zlib
from typing import Dict, List, Optional, Sequence

from saturn_tpu_torch.core.strategy import Strategy

#: ``core.task.Task.EWMA_ALPHA``: realized feedback folds the same way.
EWMA_ALPHA = 0.7


class VirtualTechnique:
    """An executor stub: it makes ``Strategy.feasible`` true and raises if
    anything tries to run it."""

    name = "twin-virtual"
    technique = None

    def execute(self, *a, **k):
        raise RuntimeError("VirtualTechnique.execute called: the twin runs everything "
                           "through VirtualEngine, never a real dispatch")

    def search(self, *a, **k):
        raise RuntimeError("VirtualTechnique has no profiling sweep")


class TwinTask:
    """A duck-typed task: what admission, the solver, the replanner and the
    engine's forecast read, and nothing that needs a device. Its realized
    feedback surface (``note_realized_per_batch`` and a no-argument
    ``apply_realized_feedback``) is the real task's, so
    ``orchestrator.fold_realized_feedback`` takes it unmodified."""

    EWMA_ALPHA = EWMA_ALPHA

    def __init__(self, name: str, total_batches: int, family: int = 0,
                 hints: Optional[dict] = None):
        self.name = name
        self.total_batches = int(total_batches)
        self.current_batch = 0
        self.epoch_length = 1000
        self.family = family
        self.hints = dict(hints or {})
        self.chip_range = None
        self.strategies: Dict[int, Strategy] = {}
        self.selected_strategy: Optional[Strategy] = None
        self._pending_realized = None

    def feasible_strategies(self) -> Dict[int, Strategy]:
        return {g: s for g, s in self.strategies.items() if s.feasible}

    def select_strategy(self, g: int) -> None:
        self.selected_strategy = self.strategies[g]

    def reconfigure(self, n: int) -> None:
        self.current_batch = (self.current_batch + n) % self.epoch_length

    # ------------------------------------------------- realized feedback
    def note_realized_per_batch(self, per_batch_s: float) -> None:
        if self.selected_strategy is not None and per_batch_s > 0.0:
            self._pending_realized = (self.selected_strategy, per_batch_s)

    def apply_realized_feedback(self):
        pending = self._pending_realized
        self._pending_realized = None
        if pending is None:
            return None
        strat, realized = pending
        if not strat.feasible:
            return None
        old = strat.per_batch_time
        strat.per_batch_time = (self.EWMA_ALPHA * realized + (1.0 - self.EWMA_ALPHA) * old
                                if old > 0.0 else realized)
        strat.runtime = strat.per_batch_time * self.total_batches
        # simulated evidence landed: the prior did its cold-start job
        strat.static_prior = False
        strat.interpolated = False
        return (old, strat.per_batch_time)


def family_of(name: str, n_families: int) -> int:
    """A stable task name -> family hash (CRC32; ``hash()`` is salted per
    process and would break determinism across runs)."""
    return zlib.crc32(name.encode("utf-8")) % max(1, n_families)


class StaticOracle:
    """The seeded per-family cost and memory model, and the task factory.

    ``flat_per_batch_s`` switches to trace-replay mode: every strategy gets
    that constant per-batch time with ``static_prior=False``, as the
    profiled tasks of a replayed real run had."""

    def __init__(self, fleet, seed: int = 0, n_families: int = 16,
                 flat_per_batch_s: Optional[float] = None, dcn_penalty: float = 4.0):
        self.fleet = fleet
        self.seed = seed
        self.n_families = max(1, n_families)
        self.flat_per_batch_s = flat_per_batch_s
        self.dcn_penalty = dcn_penalty
        self.technique = VirtualTechnique()
        self._profiles: Dict[int, dict] = {}

    # ------------------------------------------------------------ the model
    def profile(self, family: int) -> dict:
        prof = self._profiles.get(family)
        if prof is None:
            rng = random.Random((self.seed << 20) ^ (family * 2654435761 % (1 << 31)))
            prof = {
                "serial_s": rng.uniform(0.02, 0.10),
                "parallel_s": rng.uniform(0.5, 4.0),
                "comm_s": rng.uniform(0.002, 0.012),
                "model_bytes": int(rng.uniform(0.5, 8.0) * (1 << 30)),
                "activation_bytes": int(rng.uniform(0.1, 1.0) * (1 << 30)),
            }
            self._profiles[family] = prof
        return prof

    def per_batch_time(self, family: int, g: int) -> float:
        if self.flat_per_batch_s is not None:
            return self.flat_per_batch_s
        p = self.profile(family)
        comm = p["comm_s"] * math.log2(g) if g > 1 else 0.0
        if g > self.fleet.chips:
            comm *= self.dcn_penalty  # the block spans slices: DCN, not ICI
        return p["serial_s"] + p["parallel_s"] / g + comm

    def peak_bytes(self, family: int, g: int) -> int:
        p = self.profile(family)
        return 3 * p["model_bytes"] // g + p["activation_bytes"]

    def fits(self, family: int, g: int) -> bool:
        if self.flat_per_batch_s is not None:
            return True  # trace mode: the real run admitted these already
        hbm = min(d.hbm_bytes for d in self.fleet.devices)
        return self.peak_bytes(family, g) <= hbm

    # --------------------------------------------------------- task factory
    def candidate_sizes(self, capacity: int) -> List[int]:
        out, g = [], 1
        while g <= capacity:
            out.append(g)
            g *= 2
        return out

    def strategize(self, task: TwinTask, sizes: Optional[Sequence[int]] = None) -> TwinTask:
        """Fill ``task.strategies`` with prior-built strategies at every size
        that fits the memory gate (a size projected over it is no option)."""
        capacity = self.fleet.topology().capacity
        for g in (sizes or self.candidate_sizes(capacity)):
            g = int(g)
            if g < 1 or g > capacity or not self.fits(task.family, g):
                continue
            pbt = self.per_batch_time(task.family, g)
            prior = self.flat_per_batch_s is None
            task.strategies[g] = Strategy(self.technique, g, {}, pbt * task.total_batches,
                                          pbt, static_prior=prior, interpolated=prior)
        return task

    def make_task(self, name: str, total_batches: int, family: Optional[int] = None,
                  sizes: Optional[Sequence[int]] = None) -> TwinTask:
        if family is None:
            family = family_of(name, self.n_families)
        return self.strategize(TwinTask(name, total_batches, family=family), sizes=sizes)

    def task_provider(self):
        """A ``task_provider(payload) -> task`` closure, the contract of the
        gateway's rebuild and of crash recovery: the payload is the
        journaled submission."""

        def provide(payload: dict) -> TwinTask:
            spec = payload.get("spec") or {}
            return self.make_task(payload["task"],
                                  total_batches=int(payload.get("remaining_batches") or 1),
                                  family=spec.get("family"), sizes=spec.get("sizes"))

        return provide
