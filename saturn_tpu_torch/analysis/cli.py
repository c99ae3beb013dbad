"""``python -m saturn_tpu_torch.analysis``: the operator's view of a run.

Counterpart of ``saturn_tpu/analysis/cli.py``, for its ``twin`` subcommand
only; the journal, health, gateway, tenancy and analyzer views are in
``ROADMAP.md`` queue 1 item 8c.

- ``twin DIR``: a digital-twin campaign directory (``twin/runner.py``):
  makespan, solver tier shares, admission verdict mix, gateway and
  pressure sheds and evictions, and, against ``--trace`` (optionally with
  ``--real-metrics``), the fidelity deltas to a journaled real run.
  ``--run synth|storm|replay|whatif`` first runs a fresh deterministic
  campaign into DIR (``storm``: seeded preemption, crash and straggler
  chaos; ``replay``: a real journal's arrivals through the twin;
  ``whatif``: the base campaign against one more slice and against 2x
  deadlines). Exit 1 on a failed campaign, a solver deadline miss or a
  fidelity outside its band; 2 on a usage error.

``--json`` prints one machine-readable object, the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def _twin_shares(counts: dict) -> dict:
    total = sum(counts.values())
    if total == 0:
        return {}
    return {k: round(v / total, 6) for k, v in sorted(counts.items())}


def _twin_journal_makespan(trace_dir: str, fallback: float) -> float:
    """First submission to last terminal ``job_state`` record, in journal
    time: the span the journaled run witnessed. The submission span when
    there is no terminal record."""
    from saturn_tpu_torch.durability import journal as jmod

    first: Optional[float] = None
    last: Optional[float] = None
    for rec in jmod.replay_reconciled(trace_dir):
        kind = rec.get("kind")
        ts = float(rec.get("ts", 0.0))
        if kind == "job_submitted" and first is None:
            first = ts
        elif (kind == "job_state"
              and rec.get("data", {}).get("state") in ("DONE", "FAILED", "EVICTED")):
            last = ts
    if first is None or last is None or last <= first:
        return fallback
    return last - first


def _twin_fidelity(summary: dict, trace_dir: str, real_metrics: Optional[str]) -> dict:
    """A campaign summary's fidelity deltas to a journaled real run.

    Without ``--real-metrics`` the real side has no ``solver_tier`` events,
    so the tier comparison is skipped (both sides empty) rather than failed.
    The real makespan is the journal's own span (first submission to last
    terminal state)."""
    from saturn_tpu_torch.twin.trace import fidelity_compare, load_trace, tier_shares

    trace = load_trace(trace_dir)
    real = {
        "tier_shares": tier_shares(real_metrics) if real_metrics else {},
        "verdict_shares": trace.verdict_shares,
        "makespan_s": _twin_journal_makespan(trace_dir, trace.span_s),
    }
    twin = {
        "tier_shares": ((summary.get("tier_shares")
                         or _twin_shares(summary.get("tier_counts", {})))
                        if real_metrics else {}),
        "verdict_shares": (summary.get("verdict_shares")
                           or _twin_shares(summary.get("admission", {}))),
        "makespan_s": float(summary.get("makespan_s", 0.0)),
    }
    out = fidelity_compare(twin, real)
    out["reference"] = {
        "trace_dir": trace_dir,
        "real_metrics": real_metrics,
        "real_makespan_s": round(real["makespan_s"], 6),
    }
    return out


def _twin_report_whatif(path: str, verdict: dict, as_json: bool) -> int:
    comparison = verdict.get("comparison", {})
    misses = sum(int(row.get("deadline_misses", 0)) for row in comparison.values())
    if as_json:
        print(json.dumps({"whatif": comparison, "deadline_misses": misses}, sort_keys=True))
        return 1 if misses else 0
    print(f"{path}: capacity what-if ({len(comparison)} scenario(s))")
    for name in ("base", "add-slice", "relax-deadlines"):
        row = comparison.get(name)
        if row is None:
            continue
        print(f"  {name}: completed {row['completed']}, failed {row['failed']}, "
              f"evicted {row['evicted']}, shed {row['shed_total']}, "
              f"pressure sheds {row['pressure_sheds']}, misses {row['deadline_misses']}, "
              f"makespan {row['makespan_s']:.3f} sim s")
    if misses:
        print(f"DEADLINE MISSES: {misses} across scenarios")
        return 1
    return 0


def _cmd_twin(args: argparse.Namespace) -> int:
    path = args.path
    if args.run is not None:
        from saturn_tpu_torch.twin.runner import CampaignConfig, run_campaign, run_what_if

        if args.run == "replay" and not args.trace:
            print("--run replay requires --trace DIR (a durability journal from a real run)",
                  file=sys.stderr)
            return 2
        cfg = CampaignConfig(
            n_jobs=args.jobs, n_slices=args.slices, chips_per_slice=args.chips,
            interval_s=args.interval, solve_deadline_s=args.solve_deadline,
            deadline_s=args.deadline, max_inflight=args.max_inflight, seed=args.seed,
            storm=(args.run == "storm"),
            trace_dir=(args.trace if args.run == "replay" else None))
        if args.run == "whatif":
            return _twin_report_whatif(path, run_what_if(cfg, path), args.json)
        run_campaign(cfg, path)

    whatif_path = os.path.join(path, "whatif.json")
    summary_path = os.path.join(path, "summary.json")
    ledger_path = os.path.join(path, "ledger.json")
    try:
        if not os.path.exists(summary_path) and os.path.exists(whatif_path):
            with open(whatif_path) as fh:
                return _twin_report_whatif(path, json.load(fh), args.json)
        source = summary_path if os.path.exists(summary_path) else ledger_path
        with open(source) as fh:
            summary = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"cannot read twin campaign at {path!r}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    fidelity = None
    if args.trace:
        try:
            fidelity = _twin_fidelity(summary, args.trace, args.real_metrics)
        except (OSError, ValueError, KeyError) as e:
            print(f"cannot compute fidelity vs {args.trace!r}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2

    tier_counts = summary.get("tier_counts", {})
    tier_sh = summary.get("tier_shares") or _twin_shares(tier_counts)
    admission = summary.get("admission", {})
    verdict_sh = summary.get("verdict_shares") or _twin_shares(admission)
    misses = int(summary.get("deadline_misses", 0))
    status = summary.get("status", "?")
    payload = {
        "status": status,
        "intervals": summary.get("intervals"),
        "makespan_sim_s": summary.get("makespan_s"),
        "submitted": summary.get("submitted"),
        "duplicates": summary.get("duplicates"),
        "completed": summary.get("completed"),
        "failed": summary.get("failed"),
        "evicted": summary.get("evicted"),
        "admission": admission,
        "verdict_shares": verdict_sh,
        "solves": summary.get("solves"),
        "tier_counts": tier_counts,
        "tier_shares": tier_sh,
        "deadline_misses": misses,
        "gateway_sheds": summary.get("gateway_sheds", {}),
        "shed_total": summary.get("shed_total"),
        "pressure_sheds": summary.get("pressure_sheds"),
        "preemption_requeues": summary.get("preemption_requeues"),
        "retries": summary.get("retries"),
        "crashes": summary.get("crashes"),
        "topology_changes": summary.get("topology_changes"),
    }
    if fidelity is not None:
        payload["fidelity"] = fidelity
    bad = (status != "ok" or misses > 0
           or (fidelity is not None and not fidelity["within_band"]))
    if args.json:
        print(json.dumps(payload, sort_keys=True))
        return 1 if bad else 0

    print(f"{path}: twin campaign {status} — {summary.get('intervals', 0)} interval(s), "
          f"makespan {float(summary.get('makespan_s', 0.0)):.3f} sim s")
    print(f"  jobs: {summary.get('submitted', 0)} submitted "
          f"(+{summary.get('duplicates', 0)} dedup hit(s)), "
          f"{summary.get('completed', 0)} completed, {summary.get('failed', 0)} failed, "
          f"{summary.get('evicted', 0)} evicted")
    if admission:
        print("  admission: " + ", ".join(
            f"{k} x{v} ({100 * verdict_sh.get(k, 0.0):.1f}%)"
            for k, v in sorted(admission.items())))
    if tier_counts:
        from saturn_tpu_torch.solver.anytime import TIER_NAMES

        print(f"  solver: {summary.get('solves', 0)} re-solve(s); " + ", ".join(
            f"tier {t} ({TIER_NAMES.get(int(t), t)}) x{n} ({100 * tier_sh.get(t, 0.0):.1f}%)"
            for t, n in sorted(tier_counts.items())))
    sheds = summary.get("gateway_sheds", {})
    print(f"  sheds: gateway {summary.get('shed_total', 0)}"
          + (" [" + ", ".join(f"{k} x{v}" for k, v in sorted(sheds.items())) + "]"
             if sheds else "")
          + f", pressure {summary.get('pressure_sheds', 0)}")
    if summary.get("topology_changes") or summary.get("crashes"):
        print(f"  chaos: {summary.get('topology_changes', 0)} topology change(s), "
              f"{summary.get('crashes', 0)} crash(es), "
              f"{summary.get('preemption_requeues', 0)} preemption requeue(s), "
              f"{summary.get('retries', 0)} retry(ies)")
    if fidelity is not None:
        t_max = max(fidelity["tier_share_deltas"].values(), default=0.0)
        v_max = max(fidelity["verdict_share_deltas"].values(), default=0.0)
        tag = "within band" if fidelity["within_band"] else "OUT OF BAND"
        print(f"  fidelity vs {args.trace}: {tag} (tier dmax {t_max:.4f}, verdict dmax "
              f"{v_max:.4f}, makespan ratio {fidelity['makespan_ratio']:.4f})")
    if misses:
        print(f"DEADLINE MISSES: {misses} re-solve(s) ran past the budget")
    return 1 if bad else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m saturn_tpu_torch.analysis",
        description="operator views of the port's runs (the digital twin's campaigns)")
    parser.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    sub = parser.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser(
        "twin",
        help="inspect (or --run) a digital-twin campaign dir: makespan, tier shares, "
             "admission mix, shed/evict counts, fidelity deltas vs a journaled real run")
    w.add_argument("path", metavar="DIR",
                   help="campaign directory (summary.json / ledger.json / whatif.json)")
    w.add_argument("--run", choices=("synth", "storm", "replay", "whatif"), default=None,
                   help="execute a fresh campaign into DIR first")
    w.add_argument("--trace", metavar="DIR", default=None,
                   help="durability journal of a real run: the arrival source for --run "
                        "replay, the fidelity reference otherwise")
    w.add_argument("--real-metrics", metavar="PATH", default=None, dest="real_metrics",
                   help="the real run's metrics JSONL (enables the solver-tier-share "
                        "fidelity check)")
    w.add_argument("--jobs", type=int, default=200, help="synthesized jobs (default 200)")
    w.add_argument("--slices", type=int, default=4, help="virtual slices (default 4)")
    w.add_argument("--chips", type=int, default=8, help="chips per slice (default 8)")
    w.add_argument("--interval", type=float, default=60.0,
                   help="simulated seconds per interval (default 60)")
    w.add_argument("--solve-deadline", type=float, default=2.0, dest="solve_deadline",
                   help="REAL seconds of solver budget (default 2.0)")
    w.add_argument("--deadline", type=float, default=None,
                   help="per-job deadline in simulated seconds")
    w.add_argument("--max-inflight", type=int, default=64, dest="max_inflight",
                   help="gateway inflight window (default 64)")
    w.add_argument("--seed", type=int, default=7, help="campaign seed (default 7)")
    w.set_defaults(fn=_cmd_twin)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
