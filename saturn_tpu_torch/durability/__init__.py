"""Crash-safe durability: the write-ahead journal and recovery.

Counterpart of ``saturn_tpu/durability/__init__.py``:

- :mod:`~saturn_tpu_torch.durability.journal`: an append-only JSONL
  write-ahead journal, each record CRC-checked and sequence-numbered, with
  fsync'd group commits and atomic segment rotation; a torn or corrupt
  tail is quarantined to a ``.corrupt`` sidecar when the journal is
  opened. It writes the JAX package's format byte for byte.
- :mod:`~saturn_tpu_torch.durability.recovery`: replays the journal into
  the batch orchestrator's per-task progress or the online service's job
  registry, and reconciles journaled checkpoints against the disk.

``orchestrate(resume_dir=...)`` and ``SaturnService(durability_dir=...)``
journal their runs there and resume from them; the kill-replay harness is
:mod:`saturn_tpu_torch.resilience.crash`.
"""

from saturn_tpu_torch.durability.journal import (
    Journal,
    JournalCorruptError,
    recover,
    replay,
    replay_reconciled,
)
from saturn_tpu_torch.durability.recovery import (
    BatchRecovery,
    JobReplay,
    RecoveredTaskStub,
    ServiceRecovery,
    audit_plan_commits,
    build_restore_records,
    fold_health_record,
    follow_checkpoints,
    reconcile_checkpoints,
    replay_batch_state,
    replay_service_state,
)

__all__ = [
    "Journal",
    "JournalCorruptError",
    "recover",
    "replay",
    "replay_reconciled",
    "BatchRecovery",
    "JobReplay",
    "RecoveredTaskStub",
    "ServiceRecovery",
    "audit_plan_commits",
    "build_restore_records",
    "fold_health_record",
    "follow_checkpoints",
    "reconcile_checkpoints",
    "replay_batch_state",
    "replay_service_state",
]
