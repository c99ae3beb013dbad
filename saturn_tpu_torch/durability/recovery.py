"""Journal replay into the batch orchestrator's recovery state, and the
reconciliation of journaled checkpoints against the disk.

Counterpart of the batch half of ``saturn_tpu/durability/recovery.py``:
``orchestrate(resume_dir=...)`` replays the journal into per-task progress,
terminal verdicts, the last committed plan, the published checkpoints and
the health guardian's skip-lists. Only committed records count (the
journal's ``recover`` has already rolled torn tails back), so work that ran
and was not committed runs again: running work twice is safe, counting it
twice is not. The online service's half (``ServiceRecovery``,
``replay_service_state``, ``build_restore_records``) comes with the
service.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from saturn_tpu_torch.durability import journal as jmod

logger = logging.getLogger("saturn_tpu_torch")


@dataclass
class BatchRecovery:
    """Per-task durable progress for ``orchestrate(resume_dir=...)``."""

    progress: Dict[str, int] = field(default_factory=dict)
    completed: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)
    plan: Optional[dict] = None
    checkpoints: Dict[str, List[str]] = field(default_factory=dict)
    last_seq: int = 0
    n_records: int = 0
    quarantined: Dict[str, List[int]] = field(default_factory=dict)
    detached: List[str] = field(default_factory=list)


def fold_health_record(kind: str, d: Dict[str, Any], quarantined: Dict[str, List[int]],
                       detached: List[str]) -> bool:
    """Fold one ``health_*`` record into recovery state: ``health_quarantine``
    adds dataset indices to the task's sorted skip-list,
    ``health_unquarantine`` removes them (all of them with ``indices=None``),
    ``health_detach`` marks the task out of co-schedule groups. Returns
    whether the record was a health record."""
    task = d.get("task", "")
    if kind == "health_quarantine":
        cur = set(quarantined.get(task, ()))
        cur.update(int(i) for i in d.get("indices", ()))
        quarantined[task] = sorted(cur)
    elif kind == "health_unquarantine":
        indices = d.get("indices")
        if indices is None:
            quarantined.pop(task, None)
        else:
            cur = set(quarantined.get(task, ())) - {int(i) for i in indices}
            if cur:
                quarantined[task] = sorted(cur)
            else:
                quarantined.pop(task, None)
    elif kind == "health_detach":
        if task not in detached:
            detached.append(task)
    else:
        return False
    return True


def replay_batch_state(root: str) -> BatchRecovery:
    """Fold the journal's durable records into per-task progress (the sum
    of ``task_progress`` batches), completions, failures, the last
    ``plan_commit``, the ``ckpt_published`` paths and the health state."""
    state = BatchRecovery()
    for rec in jmod.replay(root):
        kind, d = rec["kind"], rec.get("data", {})
        state.n_records += 1
        state.last_seq = rec["seq"]
        if kind == "task_progress":
            name = d.get("task", "")
            state.progress[name] = state.progress.get(name, 0) + int(d.get("batches", 0))
        elif kind == "task_completed":
            if d["task"] not in state.completed:
                state.completed.append(d["task"])
        elif kind == "task_failed":
            state.failed[d["task"]] = d.get("error", "journaled failure")
        elif kind == "plan_commit":
            if d.get("plan") is not None:
                state.plan = d["plan"]
        elif kind == "ckpt_published":
            task = d.get("task") or d.get("path", "")
            state.checkpoints.setdefault(task, []).append(d.get("path", ""))
        else:
            fold_health_record(kind, d, state.quarantined, state.detached)
    return state


def reconcile_checkpoints(checkpoints: Dict[str, List[str]]) -> Dict[str, Optional[str]]:
    """Check journaled checkpoint publications against the disk.

    For each task, newest publication first: a missing file is skipped, one
    that fails ``checkpoint.verify`` is quarantined to a ``.corrupt``
    sidecar, and the newest sound one wins. Returns ``{task: path or
    None}``. The port writes each task's checkpoint to one path, so a
    quarantined newest file leaves the task with no checkpoint."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    out: Dict[str, Optional[str]] = {}
    for task, paths in checkpoints.items():
        out[task] = None
        for path in reversed(paths):
            if not os.path.exists(path):
                continue
            if ckpt.verify(path):
                out[task] = path
                break
            sidecar = ckpt.quarantine(path)
            logger.warning("recovery: checkpoint %s of %s failed verification; "
                           "quarantined to %s", path, task, sidecar)
    return out
