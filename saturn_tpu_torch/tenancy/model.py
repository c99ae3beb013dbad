"""Tenant identity, quotas and the weighted fair-share ledger.

Counterpart of ``saturn_tpu/tenancy/model.py``, which imports no JAX; the
port keeps its own copy. A *tenant* is the billing and fairness principal
a submission runs under: every ``JobRequest`` carries an optional
``tenant`` (``None`` folds to :data:`DEFAULT_TENANT`), and one
:class:`TenantLedger`, shared by the admission controller and the
pressure shedder, answers three questions about it:

- **quota**: may this tenant hold another admitted job, and has it
  chip-seconds left?
- **fair share**: given who is live now, is the tenant over its weighted
  slice of the fleet, and how is its next job's solver weight scaled?
- **ledger**: what has it admitted, shed and burned so far?

Chip-second charges are journaled as ``tenant_charge`` records, so a
budget survives a crash exactly once (recovery folds the records and
:meth:`TenantLedger.restore` puts the totals back). The JAX package's lock
names its concurrency sanitizer; here it is a plain ``threading.RLock``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

__all__ = [
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantLedger",
]

#: The tenant a submission without one is accounted under.
DEFAULT_TENANT = "default"

#: Fair-share multipliers are clamped to this band, so that an over- or
#: under-share tenant nudges the solver's weights without overriding
#: priorities and deadlines.
_FAIR_SHARE_CLAMP = (0.25, 4.0)


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant limits; ``None`` is unlimited.

    ``max_live_jobs`` caps the tenant's admitted jobs (admission DEFERs
    past it); ``chip_seconds`` is a cumulative burn budget (admission
    REJECTs once it is spent); ``max_inflight`` is the network gateway's
    submission window (the port has no gateway yet: ``ROADMAP.md``, queue
    1 item 8); ``weight`` is the fair-share weight (2.0 is entitled to
    twice a 1.0 tenant's slice); ``retry_after_s`` rides a tenant's sheds.
    """

    max_live_jobs: Optional[int] = None
    chip_seconds: Optional[float] = None
    max_inflight: Optional[int] = None
    weight: float = 1.0
    retry_after_s: Optional[float] = None


class TenantLedger:
    """Quota book and fair-share arithmetic for every known tenant.
    Thread-safe; its lock may be held while appending to the journal (the
    order ``tenancy`` -> ``journal``, as ``queue`` -> ``journal``)."""

    def __init__(self, quotas: Optional[Mapping[str, TenantQuota]] = None, *,
                 default: Optional[TenantQuota] = None) -> None:
        self._lock = threading.RLock()
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self._default = default if default is not None else TenantQuota()
        self._charged: Dict[str, float] = {}   # tenant -> chip-seconds burned
        self._admitted: Dict[str, int] = {}    # tenant -> jobs admitted
        self._shed: Dict[str, int] = {}        # tenant -> jobs shed
        #: the journal of ``tenant_charge`` records (the service sets it)
        self.journal = None

    # -- quota lookup ---------------------------------------------------
    @staticmethod
    def resolve(tenant: Optional[str]) -> str:
        """A missing tenant is the default one."""
        return tenant if tenant else DEFAULT_TENANT

    def quota(self, tenant: Optional[str]) -> TenantQuota:
        with self._lock:
            return self._quotas.get(self.resolve(tenant), self._default)

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[self.resolve(tenant)] = quota

    def tenants(self) -> list:
        """Every tenant with a quota or any ledger activity, sorted."""
        with self._lock:
            return sorted(set(self._quotas) | set(self._charged) | set(self._admitted)
                          | set(self._shed))

    # -- the ledger -----------------------------------------------------
    def charge(self, tenant: Optional[str], chip_s: float, *,
               job: Optional[str] = None) -> float:
        """Burn ``chip_s`` chip-seconds against the tenant's budget and
        return its total. Appends a ``tenant_charge`` record (durable at
        the caller's next group commit, as ``task_progress`` is)."""
        t = self.resolve(tenant)
        with self._lock:
            total = self._charged.get(t, 0.0) + float(chip_s)
            self._charged[t] = total
            if self.journal is not None:
                self.journal.append("tenant_charge", tenant=t, chip_s=round(float(chip_s), 6),
                                    job=job)
        return total

    def charged(self, tenant: Optional[str]) -> float:
        with self._lock:
            return self._charged.get(self.resolve(tenant), 0.0)

    def budget_exhausted(self, tenant: Optional[str]) -> bool:
        t = self.resolve(tenant)
        with self._lock:
            q = self._quotas.get(t, self._default)
            if q.chip_seconds is None:
                return False
            return self._charged.get(t, 0.0) >= q.chip_seconds

    def note_admit(self, tenant: Optional[str]) -> None:
        t = self.resolve(tenant)
        with self._lock:
            self._admitted[t] = self._admitted.get(t, 0) + 1

    def note_shed(self, tenant: Optional[str]) -> None:
        t = self.resolve(tenant)
        with self._lock:
            self._shed[t] = self._shed.get(t, 0) + 1

    # -- fair share -----------------------------------------------------
    def fair_target(self, tenant: Optional[str], live_by_tenant: Mapping[str, int]) -> float:
        """The tenant's weighted share of the live job count, over the
        tenants live now plus the one asked about: ``total_live * w_t /
        sum(w_active)``."""
        t = self.resolve(tenant)
        with self._lock:
            active = {self.resolve(k) for k, n in live_by_tenant.items() if n > 0}
            active.add(t)
            total = sum(int(n) for n in live_by_tenant.values() if n > 0)
            wsum = sum(self._quotas.get(a, self._default).weight for a in active)
            w = self._quotas.get(t, self._default).weight
        if wsum <= 0.0:
            return float(total)
        return total * (w / wsum)

    def over_fair_share(self, tenant: Optional[str], live_by_tenant: Mapping[str, int]) -> bool:
        """Whether the tenant holds more than its weighted slice of the live
        jobs (the pressure shedder takes such tenants' jobs first)."""
        t = self.resolve(tenant)
        live = int(live_by_tenant.get(t, 0))
        if live <= 0:
            return False
        return live > self.fair_target(t, live_by_tenant)

    def fair_share_multiplier(self, tenant: Optional[str],
                              live_by_tenant: Mapping[str, int]) -> float:
        """The factor on the admission weight of the tenant's next job,
        ``(target + 1) / (live + 1)``, clamped to ``_FAIR_SHARE_CLAMP``."""
        t = self.resolve(tenant)
        live = int(live_by_tenant.get(t, 0))
        target = self.fair_target(t, live_by_tenant)
        lo, hi = _FAIR_SHARE_CLAMP
        return max(lo, min(hi, (target + 1.0) / (live + 1.0)))

    def over_share_tenants(self, live_by_tenant: Mapping[str, int]) -> set:
        """The tenants over their weighted slice now."""
        return {self.resolve(t) for t, n in live_by_tenant.items()
                if n > 0 and self.over_fair_share(t, live_by_tenant)}

    # -- recovery -------------------------------------------------------
    def restore(self, charges: Mapping[str, float]) -> None:
        """Put back the chip-seconds folded from ``tenant_charge`` records.
        Replaces the counters: the fold of the whole journal is the truth."""
        with self._lock:
            for t, v in charges.items():
                self._charged[self.resolve(t)] = float(v)

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able view per tenant."""
        with self._lock:
            out: Dict[str, Any] = {}
            names = set(self._quotas) | set(self._charged) | set(self._admitted) | set(self._shed)
            for t in sorted(names):
                q = self._quotas.get(t, self._default)
                out[t] = {
                    "admitted": self._admitted.get(t, 0),
                    "shed": self._shed.get(t, 0),
                    "charged_chip_s": round(self._charged.get(t, 0.0), 6),
                    "chip_seconds_budget": q.chip_seconds,
                    "max_live_jobs": q.max_live_jobs,
                    "max_inflight": q.max_inflight,
                    "weight": q.weight,
                }
            return out
