"""Trace loading and fidelity comparison: journals of real runs feed the twin.

Counterpart of ``saturn_tpu/twin/trace.py``. :func:`load_trace` folds a
durability journal written by a ``SaturnService`` run into an arrival
trace and the run's admission verdict mix. A journal of several
incarnations (a service that was killed and restarted) is merged by
``durability.journal.replay_reconciled``, the stable ``(seq, incarnation)``
merge, so it replays as one trace. It reads only ``job_submitted``,
``job_admission``, ``recovery`` and ``segment_open`` records and only the
JAX package's fields of them, so a journal of either package folds the
same way: the port's extra fields (``job_admission.ckpt_path``,
``job_state.cancel_requested``) and ``task_progress`` records are passed
over.

:func:`fidelity_compare` checks the twin against the real run: its tier
shares, verdict mix and makespan must agree with the journal's within
:data:`DEFAULT_BAND`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from saturn_tpu_torch.durability import journal as jmod
from saturn_tpu_torch.utils.metrics import read_events

#: The fidelity band (the JAX package's):
#: - per-tier solver share, absolute delta <= 0.25 (the tier is a race
#:   against real CPU time on both sides; shares, not sequences, must agree)
#: - admission verdict share, absolute delta <= 0.10 (the same decision
#:   code; only the arrival interleaving differs)
#: - makespan ratio within [0.3, 3.0] (the twin quantizes work to interval
#:   boundaries; the real run pays wire, host and scheduling time)
DEFAULT_BAND = {
    "tier_share_delta": 0.25,
    "verdict_share_delta": 0.10,
    "makespan_ratio": (0.3, 3.0),
}


@dataclass(frozen=True)
class TraceJob:
    """One replayable submission of a journaled run."""

    job_id: str
    name: str
    at_s: float                      # arrival offset from the trace's start
    priority: float = 0.0
    deadline_s: Optional[float] = None
    total_batches: int = 1
    spec: Optional[dict] = None
    dedup_key: Optional[str] = None


@dataclass
class TwinTrace:
    """A journal folded for the twin."""

    jobs: List[TraceJob] = field(default_factory=list)
    admission_mix: Dict[str, int] = field(default_factory=dict)
    incarnations: int = 1
    span_s: float = 0.0              # first to last submission offset

    @property
    def verdict_shares(self) -> Dict[str, float]:
        total = sum(self.admission_mix.values())
        if total == 0:
            return {}
        return {k: v / total for k, v in sorted(self.admission_mix.items())}


def load_trace(durability_dir: str) -> TwinTrace:
    """Fold a journal directory into a :class:`TwinTrace`.

    Arrival offsets are each ``job_submitted`` record's commit timestamp
    less the first one's: the submission is durable before the client's
    acknowledgement, so it is an honest clock of arrival order."""
    trace = TwinTrace()
    first_ts: Optional[float] = None
    last_ts: float = 0.0
    for rec in jmod.replay_reconciled(durability_dir):
        kind, d = rec.get("kind"), rec.get("data", {})
        if kind == "segment_open":
            continue
        if kind == "recovery":
            trace.incarnations += 1
            continue
        if kind == "job_submitted":
            ts = float(rec.get("ts", 0.0))
            if first_ts is None:
                first_ts = ts
            last_ts = ts
            trace.jobs.append(TraceJob(
                job_id=d.get("job", ""), name=d["task"], at_s=ts - first_ts,
                priority=float(d.get("priority") or 0.0), deadline_s=d.get("deadline_s"),
                total_batches=int(d.get("total_batches") or 1), spec=d.get("spec"),
                dedup_key=d.get("dedup_key")))
        elif kind == "job_admission":
            dec = d.get("decision", "unknown")
            trace.admission_mix[dec] = trace.admission_mix.get(dec, 0) + 1
    if first_ts is not None:
        trace.span_s = last_ts - first_ts
    return trace


def tier_shares(metrics_path: str) -> Dict[str, float]:
    """Each tier's share of the ``solver_tier`` events of a metrics file
    (keyed by the tier number as a string)."""
    counts: Dict[str, int] = {}
    for e in read_events(metrics_path, kind="solver_tier"):
        t = str(e.get("tier"))
        counts[t] = counts.get(t, 0) + 1
    total = sum(counts.values())
    if total == 0:
        return {}
    return {t: n / total for t, n in sorted(counts.items())}


def _share_deltas(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: round(abs(a.get(k, 0.0) - b.get(k, 0.0)), 6) for k in sorted(set(a) | set(b))}


def fidelity_compare(twin: dict, real: dict, band: Optional[dict] = None) -> dict:
    """Compare a twin campaign with the journaled real run.

    Both sides are dicts of ``tier_shares`` (tier -> share),
    ``verdict_shares`` (decision -> share) and ``makespan_s``. Returns the
    deltas, the band they were held to, and ``within_band``. Distributions
    empty on both sides compare equal (delta 0); one side empty shows as
    the whole share."""
    band = dict(DEFAULT_BAND, **(band or {}))
    tier_deltas = _share_deltas(twin.get("tier_shares", {}), real.get("tier_shares", {}))
    verdict_deltas = _share_deltas(twin.get("verdict_shares", {}),
                                   real.get("verdict_shares", {}))
    tm, rm = twin.get("makespan_s", 0.0), real.get("makespan_s", 0.0)
    ratio = (tm / rm) if rm > 0 else (1.0 if tm == 0 else float("inf"))
    lo, hi = band["makespan_ratio"]
    ok = (all(dv <= band["tier_share_delta"] for dv in tier_deltas.values())
          and all(dv <= band["verdict_share_delta"] for dv in verdict_deltas.values())
          and lo <= ratio <= hi)
    return {
        "tier_share_deltas": tier_deltas,
        "verdict_share_deltas": verdict_deltas,
        "makespan_ratio": round(ratio, 4),
        "band": {
            "tier_share_delta": band["tier_share_delta"],
            "verdict_share_delta": band["verdict_share_delta"],
            "makespan_ratio": list(band["makespan_ratio"]),
        },
        "within_band": ok,
    }
