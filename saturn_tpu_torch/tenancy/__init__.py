"""Tenancy: tenant identity, quotas, the fair-share ledger, the replica
lease and the compile-ahead pool.

Counterpart of ``saturn_tpu/tenancy/__init__.py``: the online service's
admission controller, pressure shedder and gateway read the
:class:`TenantLedger` (``model``); gateway replicas over one journal share
an epoch-fenced :class:`ReplicaLease` (``lease``); the service hands an
admitted job's builds to the :class:`CompileAheadPool` (``compile_ahead``).
"""

from saturn_tpu_torch.tenancy.compile_ahead import CompileAheadPool
from saturn_tpu_torch.tenancy.lease import LeaseHeld, ReplicaLease
from saturn_tpu_torch.tenancy.model import DEFAULT_TENANT, TenantLedger, TenantQuota

__all__ = [
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantLedger",
    "ReplicaLease",
    "LeaseHeld",
    "CompileAheadPool",
]
