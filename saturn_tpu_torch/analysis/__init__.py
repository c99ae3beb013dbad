"""Static plan verification: the adoption gate every plan passes.

Counterpart of ``saturn_tpu/analysis/__init__.py``, for the plan verifier
only (``plan_verifier``, its journal audit included); the JAX package's
program lints and sharding / memory / concurrency passes have no
counterpart here yet.
"""

from __future__ import annotations

from saturn_tpu_torch.analysis.diagnostics import (  # noqa: F401
    AnalysisReport,
    Diagnostic,
    PlanVerificationError,
)
from saturn_tpu_torch.analysis.plan_verifier import (  # noqa: F401
    audit_journal,
    check_launch_invariants,
    verify_or_raise,
    verify_plan,
)

__all__ = [
    "AnalysisReport",
    "Diagnostic",
    "PlanVerificationError",
    "audit_journal",
    "check_launch_invariants",
    "verify_or_raise",
    "verify_plan",
]
