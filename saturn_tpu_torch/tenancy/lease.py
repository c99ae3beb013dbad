"""Epoch-fenced lease of the gateway replicas that share one journal.

Counterpart of ``saturn_tpu/tenancy/lease.py``. N gateway replicas front
one :class:`~saturn_tpu_torch.service.SaturnService` (one queue, one
journal, one dedup table). Exactly-once admission across a failover needs
one invariant more than the journaled dedup table: a replica deposed in
the middle of a request must not record a dedup entry or acknowledge a
submission after its successor took over.

- One replica holds the lease at a time; holding it authorizes recording
  new admissions. ``ensure(owner)`` acquires (the **epoch** goes up by
  one) when the lease is free, expired past ``ttl_s`` or its holder was
  marked dead, renews when ``owner`` holds it, and raises
  :class:`LeaseHeld` otherwise (the gateway answers ``GW_RETRY_AFTER``).
- ``check(owner, epoch)`` is the fence at the admission's commit point: a
  deposed replica gets False and refuses with ``GW_STALE_EPOCH``.
- Every acquisition journals ``gateway_lease`` ``{epoch, owner,
  prev_owner}``; recovery folds the highest epoch, and a lease seeded
  with it never issues a fenced epoch again.

The record is decided under the lock and written after it is released
(no fsync under a lock), so two acquisitions may be journaled out of
order; recovery takes the highest epoch. The lock is a plain
``threading.RLock``: the JAX package names it into its concurrency
sanitizer, which the port does not have (``ROADMAP.md``, queue 3).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["LeaseHeld", "ReplicaLease"]


class LeaseHeld(RuntimeError):
    """A live peer holds the lease; retry after ``retry_after_s``."""

    def __init__(self, holder: str, retry_after_s: float) -> None:
        super().__init__(f"lease held by {holder!r}")
        self.holder = holder
        self.retry_after_s = retry_after_s


class ReplicaLease:
    """The in-process lease shared by the gateway replicas of one service
    (replicas are accept loops over one journal); its epoch sequence is
    journaled, so fencing survives a restart."""

    def __init__(self, journal: Any = None, *, ttl_s: float = 2.0, epoch: int = 0,
                 owner: Optional[str] = None) -> None:
        self._lock = threading.RLock()
        #: journal of the ``gateway_lease`` records (the gateway wires the
        #: service's when None)
        self.journal = journal
        self.ttl_s = float(ttl_s)
        self._epoch = int(epoch)
        self._owner = owner
        self._renewed_at: Optional[float] = None
        self._dead: set = set()
        #: acquisitions in this process, [(epoch, owner, prev_owner)]
        self.history: List[Tuple[int, str, Optional[str]]] = []

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def owner(self) -> Optional[str]:
        with self._lock:
            return self._owner

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self._epoch, "owner": self._owner, "ttl_s": self.ttl_s,
                    "dead": sorted(self._dead), "acquisitions": len(self.history)}

    def ensure(self, owner: str) -> int:
        """Hold or take the lease for ``owner``; returns the epoch to present
        to :meth:`check` at the commit point."""
        now = time.monotonic()
        record = None
        with self._lock:
            if self._owner == owner:
                self._renewed_at = now
                epoch = self._epoch
            else:
                holder = self._owner
                expired = self._renewed_at is None or now - self._renewed_at >= self.ttl_s
                if holder is not None and holder not in self._dead and not expired:
                    remaining = self.ttl_s - (now - (self._renewed_at or now))
                    raise LeaseHeld(holder, max(0.01, remaining))
                self._epoch += 1
                self._owner = owner
                self._renewed_at = now
                self._dead.discard(owner)
                epoch = self._epoch
                record = (epoch, owner, holder)
                self.history.append(record)
        if record is not None and self.journal is not None:
            self.journal.log("gateway_lease", epoch=record[0], owner=record[1],
                             prev_owner=record[2])
        return epoch

    def check(self, owner: str, epoch: int) -> bool:
        """The fence: is ``owner``'s ``epoch`` still the current lease?"""
        with self._lock:
            return self._owner == owner and self._epoch == int(epoch)

    def mark_dead(self, owner: str) -> None:
        """Declare ``owner`` gone so a peer takes over without waiting out
        the ttl. The epoch moves only with the successor's acquisition,
        which is what fences the dead replica's stragglers."""
        with self._lock:
            self._dead.add(owner)

    def release(self, owner: str) -> None:
        """Drop the lease if ``owner`` holds it (a clean drain's handoff)."""
        with self._lock:
            if self._owner == owner:
                self._owner = None
                self._renewed_at = None
