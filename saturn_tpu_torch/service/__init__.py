"""Online job service: the always-on face of the batch orchestrator.

Counterpart of ``saturn_tpu/service/__init__.py``. ``orchestrate``
solves SPASE for a fixed batch of tasks; this package runs the same
machinery (the interval loop, the profile cache, the anytime solver, the
elastic replanner, the durability journal) as a long-running scheduler
that takes work over time:

- :mod:`~saturn_tpu_torch.service.queue`: the thread-safe submission queue,
  :class:`JobRequest` and the job lifecycle
  (QUEUED → PROFILING → SCHEDULED → RUNNING → DONE / FAILED / EVICTED);
- :mod:`~saturn_tpu_torch.service.admission`: profiles arrivals through the
  profile cache (a warm arrival admits with zero trials), rejects or
  defers work that cannot fit, computes the solver's priority / deadline
  weights;
- :mod:`~saturn_tpu_torch.service.server`: the service loop;
- :mod:`~saturn_tpu_torch.service.client`: the in-process client
  (``submit / status / wait / cancel``) and the ``python -m
  saturn_tpu_torch.service`` CLI over the metrics stream;
- :mod:`~saturn_tpu_torch.service.gateway`: the JSONL-over-TCP front door,
  :class:`GatewayServer` (idempotent submission, per-request deadlines,
  inflight windows, replicas, graceful drain) and the retrying
  :class:`GatewayClient` with the in-process client's surface.
"""

from saturn_tpu_torch.service.admission import AdmissionController, AdmissionDecision
from saturn_tpu_torch.service.client import ServiceClient
from saturn_tpu_torch.service.gateway import GatewayClient, GatewayError, GatewayServer
from saturn_tpu_torch.service.queue import JobRecord, JobRequest, JobState, SubmissionQueue
from saturn_tpu_torch.service.server import SaturnService

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "JobRecord",
    "JobRequest",
    "JobState",
    "SaturnService",
    "ServiceClient",
    "SubmissionQueue",
]
