"""VirtualEngine: the engine's surface with simulated execution.

Counterpart of ``saturn_tpu/twin/engine.py``. The real engine
(``executor/engine.py``) is two things: the forecast arithmetic (which tasks
run this interval, for how many batches) and a gang launch that spends
device time. The twin keeps the first, :func:`forecast` and
:func:`rollback_forecast` re-exported as they are, and replaces the second
with bookkeeping on the virtual clock:

- mid-interval fault events land on the health monitor at once (in virtual
  time an interval is atomic: "during the interval" means "before its work
  retires");
- a task whose block lost a device gets a
  :class:`~saturn_tpu_torch.resilience.faults.PreemptedError` in the errors,
  which the service loop requeues without using a retry;
- ``FaultInjector.crashes`` answers the transient-crash queries as the real
  engine asks them;
- a straggler's slowdown inflates the realized per-batch time fed back
  through ``note_realized_per_batch`` and ``health.note_step``, so the EWMA
  correction, straggler detection and degrade replans run on production
  code, driven by simulated observations.

A block's monitor indices come from its positions
(``resilience.health.block_indices``), as everywhere in the port; the JAX
twin maps its device objects by identity.

No threads, no techniques, no sleeps: an interval's execution is a pure
function of (plan, health, faults) and takes no wall time while it stands
for ``interval`` simulated seconds.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

# re-exported: the twin must never fork the budget arithmetic
from saturn_tpu_torch.executor.engine import forecast, rollback_forecast  # noqa: F401
from saturn_tpu_torch.resilience.faults import PreemptedError
from saturn_tpu_torch.resilience.health import block_indices


class VirtualEngine:
    """The service loop's ``engine.execute`` call, simulated."""

    def __init__(self, health=None, faults=None):
        self.health = health
        self.faults = faults

    def execute(self, run_tasks, batches: Dict[str, int], interval: float, plan, topo, *,
                interval_index: int = 0,
                on_task_start: Optional[Callable[[str], None]] = None,
                on_task_done: Optional[Callable[[str, int], None]] = None,
                **_ignored) -> Dict[str, Exception]:
        """Simulate one interval; returns ``{task_name: error}`` as the real
        engine does (empty: everything retired).

        Tasks go in (planned start, name) order, a deterministic
        serialization of the gang schedule. ``on_task_done`` fires only for
        a task that retired its whole budget, the real engine's
        all-or-nothing interval contract."""
        health, faults = self.health, self.faults
        errors: Dict[str, Exception] = {}
        # mid-interval chaos fires before any work retires (module doc)
        if faults is not None and health is not None:
            faults.apply_due(interval_index, health, mid_interval=True)
        for task in sorted(run_tasks, key=lambda t: (plan.assignments[t.name].start, t.name)):
            a = plan.assignments[task.name]
            if on_task_start is not None:
                on_task_start(task.name)
            if faults is not None and faults.crashes(task.name, interval_index):
                errors[task.name] = RuntimeError(
                    f"injected transient crash: {task.name} interval {interval_index}")
                continue
            idx = []
            if health is not None:
                idx = block_indices(topo, a.block)
                if idx and health.any_lost(idx):
                    errors[task.name] = PreemptedError(
                        f"{task.name}: block {a.block} lost a device during interval "
                        f"{interval_index}")
                    continue
            strat = task.strategies[a.apportionment]
            slow = health.max_slowdown(idx) if (health and idx) else 1.0
            realized = strat.per_batch_time * slow
            task.select_strategy(a.apportionment)
            note = getattr(task, "note_realized_per_batch", None)
            if note is not None:
                note(realized)
            if health is not None and idx:
                # the monitor folds injected slowdowns itself: feed it the
                # nominal time, as a real technique's timer would
                health.note_step(idx, strat.per_batch_time)
            if on_task_done is not None:
                on_task_done(task.name, batches.get(task.name, 0))
        return errors
