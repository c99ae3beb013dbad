"""saturn_tpu_torch: the multi-model training orchestrator on PyTorch + CUDA.

The PyTorch / NVIDIA H100 port of ``saturn_tpu``, beside it in this
repository: the same four-call API — ``library.register`` a technique,
build ``Task``s, ``search`` (profile task x block size x technique), then
``orchestrate`` (solve the SPASE MILP and run the plan in intervals with
checkpoint / resume); ``serve`` starts the always-on service that takes
jobs over time. Its entry points run on the card unless the caller passes
an explicit CPU topology. It imports nothing of ``saturn_tpu`` or JAX.
"""

from saturn_tpu_torch.core.strategy import Strategy, Techniques
from saturn_tpu_torch.core.task import HParams, Task
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.core.modelspec import ModelSpec
from saturn_tpu_torch import library

__version__ = "0.1.0"

__all__ = [
    "Task",
    "HParams",
    "Strategy",
    "Techniques",
    "BaseTechnique",
    "ModelSpec",
    "library",
    "search",
    "orchestrate",
    "serve",
]


def search(tasks, technique_names=None, log=False, topology=None, **kw):
    """Profile every (task x block size x technique) combination."""
    from saturn_tpu_torch.trial_runner.evaluator import search as _search

    return _search(
        tasks, technique_names=technique_names, log=log, topology=topology, **kw
    )


def orchestrate(
    task_list,
    log=False,
    interval=1000.0,
    topology=None,
    threshold=0.0,
    solver_time_limit=None,
    failure_policy="raise",
    max_task_retries=1,
    metrics_path=None,
    trace_dir=None,
    fault_injector=None,
    health_monitor=None,
    recovery_policy="pause-resolve-resume",
    replan_degrade_factor=2.0,
    resume_dir=None,
    health_guardian=None,
    crash_barrier=None,
    fusion=True,
):
    """Solve the SPASE problem and run the batch to completion (the
    signature of ``saturn_tpu.orchestrate``)."""
    from saturn_tpu_torch.executor.orchestrator import orchestrate as _orch

    return _orch(
        task_list,
        log=log,
        interval=interval,
        topology=topology,
        threshold=threshold,
        solver_time_limit=solver_time_limit,
        failure_policy=failure_policy,
        max_task_retries=max_task_retries,
        metrics_path=metrics_path,
        trace_dir=trace_dir,
        fault_injector=fault_injector,
        health_monitor=health_monitor,
        recovery_policy=recovery_policy,
        replan_degrade_factor=replan_degrade_factor,
        resume_dir=resume_dir,
        health_guardian=health_guardian,
        crash_barrier=crash_barrier,
        fusion=fusion,
    )


def serve(topology=None, **kw):
    """Start an online job service (``saturn_tpu_torch.service.SaturnService``)
    and return (service, client): the always-on counterpart of
    ``orchestrate``. Jobs are submitted over time, admission profiles them
    through the profile cache, and each interval boundary re-solves
    incrementally (the signature of ``saturn_tpu.serve``)."""
    from saturn_tpu_torch.service import SaturnService, ServiceClient

    svc = SaturnService(topology=topology, **kw).start()
    return svc, ServiceClient(svc)
