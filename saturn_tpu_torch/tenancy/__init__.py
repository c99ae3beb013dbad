"""Tenancy: tenant identity, quotas, the fair-share ledger and the replica
lease.

Counterpart of ``saturn_tpu/tenancy/__init__.py`` without the
compile-ahead pool (``compile_ahead``, ``ROADMAP.md`` queue 1 item 8b):
the online service's admission controller, pressure shedder and gateway
read the :class:`TenantLedger` (``model``); gateway replicas over one
journal share an epoch-fenced :class:`ReplicaLease` (``lease``).
"""

from saturn_tpu_torch.tenancy.lease import LeaseHeld, ReplicaLease
from saturn_tpu_torch.tenancy.model import DEFAULT_TENANT, TenantLedger, TenantQuota

__all__ = [
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantLedger",
    "ReplicaLease",
    "LeaseHeld",
]
