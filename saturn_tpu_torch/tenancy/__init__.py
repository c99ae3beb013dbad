"""Tenancy: tenant identity, quotas and the fair-share ledger.

Counterpart of ``saturn_tpu/tenancy/__init__.py``, its ``model`` only:
the online service's admission controller and pressure shedder read the
:class:`TenantLedger`. The replica lease (``lease``) and the
compile-ahead pool (``compile_ahead``) go with the network gateway
(``ROADMAP.md``, queue 1 item 8).
"""

from saturn_tpu_torch.tenancy.model import DEFAULT_TENANT, TenantLedger, TenantQuota

__all__ = [
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantLedger",
]
