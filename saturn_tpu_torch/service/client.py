"""The in-process client and the ``python -m saturn_tpu_torch.service`` CLI.

Counterpart of ``saturn_tpu/service/client.py``. The client is a thin layer
over the service's queue: ``submit`` enqueues a :class:`JobRequest`,
``status`` / ``wait`` read the job's lifecycle record, ``cancel`` asks for
eviction. The CLI needs no live service: it reads the JSONL metrics
stream that a service writes (``utils.metrics.tail_events``), folds the
``job_*`` events into a queue view and prints it, so an operator can
watch a run, or read it after, from another process.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from saturn_tpu_torch.service.queue import JobRequest


class ServiceClient:
    """submit / status / wait / cancel against a running SaturnService."""

    def __init__(self, service):
        self._service = service

    def submit(self, task, priority: float = 0.0, deadline_s: Optional[float] = None,
               max_retries: int = 1, spec: Optional[dict] = None) -> str:
        """Enqueue a task; returns the job id. ``spec`` is a JSON-able
        rebuild payload: on a durable service it is journaled with the
        submission and handed to ``task_provider(spec)`` after a crash. On
        a durable service ``submit`` returns once the submission is
        fsync'd to the journal."""
        rec = self._service.queue.submit(JobRequest(
            task=task, priority=priority, deadline_s=deadline_s, max_retries=max_retries,
            spec=spec))
        return rec.job_id

    def status(self, job_id: str) -> dict:
        """A snapshot of the job's lifecycle record."""
        return self._service.queue.get(job_id).snapshot()

    def wait(self, job_id: str, timeout: Optional[float] = None) -> dict:
        """Block until the job is DONE, FAILED or EVICTED; ``TimeoutError``
        after ``timeout``."""
        return self._service.queue.wait(job_id, timeout).snapshot()

    def cancel(self, job_id: str) -> bool:
        """Ask for eviction; False if the job is terminal already."""
        return self._service.queue.cancel(job_id)


# ------------------------------------------------------------------- CLI
_LIFECYCLE_KINDS = (
    "job_submitted", "job_admitted", "job_scheduled", "job_completed",
    "job_failed", "job_evicted", "queue_depth",
)


def _fold(rec: dict, jobs: dict) -> None:
    kind, job = rec.get("kind"), rec.get("job")
    if not job:
        return
    j = jobs.setdefault(job, {"job": job, "task": rec.get("task"), "state": "QUEUED",
                              "detail": ""})
    if kind == "job_admitted":
        dec = rec.get("decision", "admit")
        if dec == "admit":
            j["state"] = "ADMITTED"
            j["detail"] = "warm" if rec.get("warm") else f"{rec.get('trials_run', 0)} trials"
        elif dec == "defer":
            j["state"] = "DEFERRED"
            j["detail"] = rec.get("reason", "")
        else:
            j["state"] = "REJECTED"
            j["detail"] = rec.get("reason", "")
    elif kind == "job_scheduled":
        j["state"] = "SCHEDULED"
        start = rec.get("start_s")
        j["detail"] = f"start +{start:.1f}s" if start is not None else ""
    elif kind == "job_completed":
        j["state"] = "DONE"
        wait = rec.get("wait_s")
        j["detail"] = f"wait {wait:.2f}s" if wait is not None else ""
    elif kind == "job_failed":
        j["state"] = "FAILED"
        j["detail"] = rec.get("error", "")
    elif kind == "job_evicted":
        j["state"] = "EVICTED"
        j["detail"] = rec.get("reason", "")


def _render(jobs: dict, depth) -> str:
    lines = [f"{'JOB':<22} {'TASK':<14} {'STATE':<10} DETAIL"]
    for j in jobs.values():
        lines.append(f"{j['job']:<22} {str(j['task']):<14} {j['state']:<10} {j['detail']}")
    if depth is not None:
        lines.append(f"queue depth: {depth.get('depth')} waiting, {depth.get('live')} live, "
                     f"{depth.get('active')} in plan")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m saturn_tpu_torch.service",
        description="Tail a saturn_tpu_torch service's JSONL metrics stream as a live queue "
                    "view.")
    p.add_argument("metrics_path", help="JSONL file the service writes "
                                        "(SaturnService(metrics_path=...))")
    p.add_argument("--follow", "-f", action="store_true",
                   help="keep tailing for new events (Ctrl-C to stop)")
    p.add_argument("--events", action="store_true",
                   help="print raw lifecycle events instead of the table")
    args = p.parse_args(argv)

    from saturn_tpu_torch.utils.metrics import tail_events

    jobs: dict = {}
    depth = None
    try:
        for rec in tail_events(args.metrics_path, follow=args.follow):
            if rec.get("kind") not in _LIFECYCLE_KINDS:
                continue
            if args.events:
                print({k: v for k, v in rec.items() if k != "ts"})
                continue
            if rec["kind"] == "queue_depth":
                depth = rec
            else:
                _fold(rec, jobs)
            if args.follow:
                print(f"-- {rec['kind']}: {rec.get('job') or ''} {rec.get('task') or ''}")
    except KeyboardInterrupt:
        pass
    if not args.events:
        print(_render(jobs, depth))
    return 0


if __name__ == "__main__":
    sys.exit(main())
