"""Structured diagnostics of the plan verifier.

Counterpart of ``saturn_tpu/analysis/diagnostics.py``, with the codes of
the checks the port carries (the JAX package's co-schedule and fusion
checks wait for those features):

========== ========= ===========================================================
code       severity  meaning
========== ========= ===========================================================
SAT-P001   error     device race: blocks overlap with no ordering path between
                     the two tasks
SAT-P002   error     dependency cycle — the gang launch would deadlock
SAT-P003   error     a task depends on a member of its own co-schedule or fusion group
SAT-P010   warning   dependency names a task with no assignment in the plan
SAT-P011   warning   co-schedule group names a task with no assignment
SAT-P012   warning   co-schedule group has fewer than two assigned members
SAT-P013   warning   task appears in two co-schedule groups
SAT-P014   warning   fusion group names a task with no assignment
SAT-P015   warning   fusion group has fewer than two assigned members
SAT-P016   warning   task appears in two fusion groups
SAT-P020   error     assignment block exceeds the topology's buddy capacity
SAT-P021   error     assignment apportionment differs from its block size
SAT-P022   error     task has no feasible strategy at the assigned apportionment
SAT-P023   warning   co-schedule group members do not share one block
SAT-P024   warning   co-scheduled task has no measured host fraction or bubble
SAT-P025   error     fusion group members do not hold identical (size, block, start)
SAT-P026   warning   fused task has no measured fused_per_batch_time
SAT-P030   error     negative start time or negative runtime
SAT-P031   error     task starts before a task it depends on
SAT-P032   warning   recorded makespan is below the last assignment's end time
SAT-P033   warning   deadline arithmetic: start + runtime overruns the deadline
SAT-J000   info      the journal holds no plan_commit record
SAT-J001   error     a replayed plan_commit record fails static verification
SAT-J002   error     the journal is unreadable, or a plan_commit is undecodable
========== ========= ===========================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: severity levels, weakest to strongest
SEVERITIES = ("info", "warning", "error")


@dataclass(frozen=True)
class Diagnostic:
    """One finding. ``counterexample`` is the minimal witness (the two task
    names and their device ranges for a race, the cycle's nodes), small
    JSON-serializable data."""

    code: str
    severity: str
    message: str
    counterexample: Optional[Dict[str, Any]] = None
    category: str = "plan"


@dataclass
class AnalysisReport:
    """All diagnostics of one verification."""

    subject: str = "plan"
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def extend(self, diags: List[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostic was emitted."""
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]


class PlanVerificationError(RuntimeError):
    """A gated plan path received a plan the verifier rejects; carries the
    full report for callers that quarantine rather than crash."""

    def __init__(self, report: AnalysisReport, source: str = "plan") -> None:
        self.report = report
        self.source = source
        first = report.errors[0] if report.errors else None
        detail = first.message if first else "verification failed"
        super().__init__(
            f"static plan verification failed for {source}: {detail} "
            f"({len(report.errors)} error(s); codes: "
            f"{sorted({d.code for d in report.errors})})"
        )


def make(code: str, severity: str, message: str,
         counterexample: Optional[Dict[str, Any]] = None,
         category: str = "plan") -> Diagnostic:
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}")
    return Diagnostic(code=code, severity=severity, message=message,
                      counterexample=counterexample, category=category)
