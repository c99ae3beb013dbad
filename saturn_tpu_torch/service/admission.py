"""Admission control: profile arrivals, gate them on fit, weight the objective.

Counterpart of ``saturn_tpu/service/admission.py``. Profiling goes through
the trial runner with the persistent profile cache first, so a *warm*
arrival (a model, data and optimizer fingerprint seen before, at any
priority) admits with **zero** trials, while a cold one pays the sweep once.
A requeued job (a preemption round trip) skips profiling: its strategies
are already on the task.

Fit: a job with no feasible strategy that fits the current topology is
REJECTED on a full-capacity topology (it never will fit) and DEFERRED on a
degraded one (a grow may admit it).

Weights: an admitted job's solver weight is

    w = 2^priority * (1 + est_runtime / max(deadline_slack, est_runtime))

exponential in priority, so integer priority classes dominate, with a
deadline boost capped at 2x. ``solver.milp`` folds the weights into its
objective as a weighted start-time tiebreak.

Tenancy (with a ``TenantLedger``): before any profiling, a tenant over its
``max_live_jobs`` DEFERs and one whose ``chip_seconds`` are spent is
REJECTED; an admitted job's weight is scaled by its tenant's fair-share
multiplier.

Two gates of the JAX package have no counterpart (``ROADMAP.md``, queue 3):

- its zero-trial memory verdict is memlens' compiled peak; the port asks
  each technique's static screen (``SPMDTechnique._static_screen``: the
  fp32 params, grads and optimizer moments against 92 % of the device) on
  every grid point, and a job passes wherever the screen cannot tell;
- it can admit on shardflow's static priors; the port has none, so an
  unprofiled job runs the trial sweep (JAX's own fallback when its prior
  fails).
"""

from __future__ import annotations

import logging
import time
import timeit
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.service.queue import JobRecord, JobState, SubmissionQueue
from saturn_tpu_torch.utils import metrics

logger = logging.getLogger("saturn_tpu_torch")

ADMIT = "admit"
REJECT = "reject"
DEFER = "defer"

# revisit_on hints of DEFER decisions: the event that can change the verdict
REVISIT_INTERVAL = "interval"  # the tenant's own completions free a slot
REVISIT_GROW = "grow"          # a grow restores the missing capacity
REVISIT_DEFRAG = "defrag"      # capacity exists; pinned memory must compact


@dataclass
class AdmissionDecision:
    action: str                  # ADMIT | REJECT | DEFER
    reason: str = ""
    trials_run: int = 0          # trials the profiling sweep ran
    weight: float = 0.0          # solver objective weight (ADMIT only)
    latency_s: float = 0.0       # wall seconds of the admission
    static_prior: bool = False   # the JAX package's shardflow priors: never here
    revisit_on: str = ""         # DEFER only: see REVISIT_*


def _min_feasible_runtime(task) -> float:
    feas = task.feasible_strategies()
    return min(s.runtime for s in feas.values()) if feas else 0.0


def compute_weight(priority: float, deadline_slack_s: Optional[float],
                   est_runtime_s: float) -> float:
    """Priority / deadline weight for the solver objective (module doc)."""
    w = 2.0 ** float(priority)
    if deadline_slack_s is not None:
        est = max(est_runtime_s, 1e-9)
        w *= 1.0 + est / max(deadline_slack_s, est)
    return w


class AdmissionController:
    """Profiles and gates arrivals for the service. Only the service loop
    calls it."""

    def __init__(self, topology: SliceTopology, queue: SubmissionQueue,
                 technique_names: Optional[List[str]] = None, profile_cache: Any = None,
                 prune: bool = True, parallel_trials: Optional[int] = None):
        self.base_capacity = topology.capacity
        self.technique_names = technique_names
        self.profile_cache = profile_cache
        self.prune = prune
        self.parallel_trials = parallel_trials
        self.queue = queue
        #: the write-ahead journal (the durable service sets it): every
        #: decision is a buffered ``job_admission`` record
        self.journal = None
        #: the TenantLedger (quota gates, fair-share weights), or None
        self.tenancy = None
        #: ``gate(task, topology) -> verdict dict or None`` after the fit
        #: check passes (the grow coordinator's): ``{"fits": False, ...}``
        #: DEFERs with ``revisit_on="defrag"``; None is no verdict
        self.occupancy_gate: Optional[Callable] = None
        #: the DEFER pool: job_id -> {task, tenant, reason, revisit_on,
        #: deferred_at, count}; an entry leaves at the job's next ADMIT or
        #: REJECT
        self.deferred: Dict[str, dict] = {}
        #: tenant -> jobs admitted in the current drain pass (the queue
        #: counts a job admitted only once it is SCHEDULED, after the solve)
        self._pass_admitted: dict = {}
        self._screens: Optional[Dict[str, Any]] = None  # technique name -> instance

    def begin_pass(self) -> None:
        """Start a drain pass (resets the in-pass admission tally)."""
        self._pass_admitted.clear()

    def admit(self, rec: JobRecord, topology: SliceTopology) -> AdmissionDecision:
        """Profile (if needed) and decide one arrival. Moves the record
        QUEUED -> PROFILING; the caller applies the decision (SCHEDULED on
        admit after the solve, QUEUED on defer, FAILED on reject)."""
        t0 = timeit.default_timer()
        self.queue.mark(rec, JobState.PROFILING)
        task = rec.task

        if self.tenancy is not None:
            dec = self._tenant_gate(rec, t0)
            if dec is not None:
                self._note(rec, dec)
                return dec

        mem = self._screen_verdict(task, topology)
        if mem is not None and not mem["fits"]:
            degraded = topology.capacity < self.base_capacity
            dec = AdmissionDecision(
                DEFER if degraded else REJECT,
                reason=(f"static screen: the train state of every config needs at least "
                        f"{mem['min_peak_bytes']} B per device, over the headroom of "
                        f"{mem['capacity_bytes']} B ({mem['checked']} grid points, zero "
                        f"trials)"),
                latency_s=timeit.default_timer() - t0,
                revisit_on=REVISIT_GROW if degraded else "")
            self._note(rec, dec)
            return dec

        trials = 0
        if not task.feasible_strategies():
            # cold (or never seen): the sweep; a warm fingerprint is all cache hits
            from saturn_tpu_torch.trial_runner import evaluator

            try:
                stats = evaluator.search([task], technique_names=self.technique_names,
                                         topology=topology, profile_cache=self.profile_cache,
                                         prune=self.prune,
                                         parallel_trials=self.parallel_trials)
            except Exception as e:
                dec = AdmissionDecision(REJECT, reason=f"profiling failed: {e!r}",
                                        latency_s=timeit.default_timer() - t0)
                self._note(rec, dec)
                return dec
            trials = int((stats or {}).get("trials_run", 0))
        rec.trials_run += trials

        fits = any(g <= topology.capacity for g in task.feasible_strategies())
        if not fits and rec.requeues > 0:
            # a preempted job was running: synthesize a fitting strategy from
            # its measured points, as the replanner does on a shrink
            from saturn_tpu_torch.resilience.replan import ElasticReplanner

            added = ElasticReplanner()._synthesize(task, topology.capacity)
            if added:
                logger.info("admission: synthesized size(s) %s for requeued %s on the "
                            "%d-device topology", added, rec.job_id, topology.capacity)
            fits = any(g <= topology.capacity for g in task.feasible_strategies())
        if not fits:
            degraded = topology.capacity < self.base_capacity
            dec = AdmissionDecision(
                DEFER if degraded else REJECT,
                reason=(f"no feasible strategy fits the degraded mesh "
                        f"({topology.capacity}/{self.base_capacity} chips)" if degraded else
                        f"no feasible strategy fits the mesh ({topology.capacity} chips)"),
                trials_run=trials, latency_s=timeit.default_timer() - t0,
                revisit_on=REVISIT_GROW if degraded else "")
            self._note(rec, dec)
            return dec

        if self.occupancy_gate is not None:
            try:
                occ = self.occupancy_gate(task, topology)
            except Exception as e:
                logger.debug("admission: occupancy gate skipped: %r", e)
                occ = None
            if occ is not None and not occ.get("fits", True):
                dec = AdmissionDecision(
                    DEFER,
                    reason=(f"occupancy: pinned live state leaves {occ.get('free_bytes', 0)} B "
                            f"free on every fitting block, need {occ.get('need_bytes', 0)} B "
                            "— a defrag wave can compact it"),
                    trials_run=trials, latency_s=timeit.default_timer() - t0,
                    revisit_on=REVISIT_DEFRAG)
                self._note(rec, dec)
                return dec

        slack = rec.deadline_at - time.monotonic() if rec.deadline_at is not None else None
        weight = compute_weight(rec.request.priority, slack, _min_feasible_runtime(task))
        if self.tenancy is not None:
            weight *= self.tenancy.fair_share_multiplier(rec.tenant,
                                                         self.queue.live_by_tenant())
        rec.weight = weight
        # scheduling-only hints: the replanner's eviction policies order by
        # hints["priority"]; the profile cache's signature leaves both out
        hints = getattr(task, "hints", None)
        if isinstance(hints, dict):
            hints["priority"] = float(rec.request.priority)
            if rec.request.deadline_s is not None:
                hints["deadline"] = float(rec.request.deadline_s)
        dec = AdmissionDecision(ADMIT, reason="ok", trials_run=trials, weight=weight,
                                latency_s=timeit.default_timer() - t0)
        if self.tenancy is not None:
            self.tenancy.note_admit(rec.tenant)
            self._pass_admitted[rec.tenant] = self._pass_admitted.get(rec.tenant, 0) + 1
        self._note(rec, dec)
        return dec

    # -------------------------------------------------------------- tenancy
    def _tenant_gate(self, rec: JobRecord, t0: float):
        """The tenant's quota verdict, or None to go on: spent chip-seconds
        REJECT (a budget never refills), a full ``max_live_jobs`` DEFERs
        (counting admitted jobs, not queued ones)."""
        tenant = rec.tenant
        quota = self.tenancy.quota(tenant)
        if self.tenancy.budget_exhausted(tenant):
            return AdmissionDecision(
                REJECT,
                reason=(f"tenant {tenant!r} chip-seconds budget exhausted "
                        f"({self.tenancy.charged(tenant):.1f}s burned of "
                        f"{quota.chip_seconds:.1f}s)"),
                latency_s=timeit.default_timer() - t0)
        if quota.max_live_jobs is not None:
            admitted = self.queue.admitted_tenant(tenant) + self._pass_admitted.get(tenant, 0)
            if admitted >= quota.max_live_jobs:
                return AdmissionDecision(
                    DEFER,
                    reason=(f"tenant {tenant!r} has {admitted} admitted job(s), at its "
                            f"max_live_jobs quota {quota.max_live_jobs}"),
                    latency_s=timeit.default_timer() - t0, revisit_on=REVISIT_INTERVAL)
        return None

    # -------------------------------------------------------- static screen
    def _screen_verdict(self, task, topology: SliceTopology) -> Optional[dict]:
        """The static screen's zero-trial memory verdict over this
        controller's techniques, every valid size and every config of their
        grids: ``{"fits": False, ...}`` only when the screen refuses every
        point; None where it cannot tell (a technique without a screen, no
        device memory size, any error)."""
        try:
            if self._screens is None:
                from saturn_tpu_torch.parallel import BUILTIN_TECHNIQUES

                names = self.technique_names or sorted(BUILTIN_TECHNIQUES)
                self._screens = {n: BUILTIN_TECHNIQUES[n]() for n in names
                                 if n in BUILTIN_TECHNIQUES}
            if not self._screens:
                return None
            from saturn_tpu_torch.parallel.spmd_base import MEMORY_HEADROOM
            from saturn_tpu_torch.utils import timing

            checked, need = 0, None
            cap = 0
            for size in topology.valid_sizes():
                devices = topology.block_devices(topology.blocks(size)[0])
                cap = timing.device_memory_bytes(devices[0])
                if cap <= 0:
                    return None
                for tech in self._screens.values():
                    if not hasattr(tech, "_static_screen") or getattr(tech, "host_state", False):
                        return None  # a host-resident state is not screened
                    for config in tech.candidate_configs(task, size):
                        checked += 1
                        if tech._static_screen(task, devices, config):
                            return {"fits": True}
                        b = tech.state_bytes(task, config)
                        need = b if need is None else min(need, b)
            if not checked:
                return None
            return {"fits": False, "min_peak_bytes": int(need),
                    "capacity_bytes": int(MEMORY_HEADROOM * cap), "checked": checked}
        except Exception as e:
            logger.debug("admission: static screen skipped: %r", e)
            return None

    def _note(self, rec: JobRecord, dec: AdmissionDecision) -> None:
        if self.journal is not None:
            # the port's record also names the job's checkpoint, so that a
            # restart finds a checkpoint whose publication died uncommitted
            # (durability/recovery.follow_checkpoints)
            extra = {}
            path = getattr(rec.task, "ckpt_path", None)
            if isinstance(path, str):
                extra["ckpt_path"] = path
            self.journal.append("job_admission", job=rec.job_id, task=rec.name,
                                decision=dec.action, reason=dec.reason,
                                trials_run=dec.trials_run, weight=round(dec.weight, 6),
                                static_prior=dec.static_prior, tenant=rec.tenant, **extra)
        self._note_deferred(rec, dec)
        metrics.event("job_admitted", job=rec.job_id, task=rec.name, decision=dec.action,
                      reason=dec.reason, trials_run=dec.trials_run, warm=dec.trials_run == 0,
                      weight=round(dec.weight, 6), latency_s=round(dec.latency_s, 6),
                      static_prior=dec.static_prior)
        logger.info("admission: %s %s (%s; %d trials, weight %.3f, %.3fs)", rec.job_id,
                    dec.action, dec.reason or "ok", dec.trials_run, dec.weight, dec.latency_s)

    def _note_deferred(self, rec: JobRecord, dec: AdmissionDecision) -> None:
        """Keep the DEFER pool, and journal a ``job_deferred`` record on a
        job's first defer or when its reason class (``revisit_on``) changes."""
        if dec.action != DEFER:
            self.deferred.pop(rec.job_id, None)
            return
        prev = self.deferred.get(rec.job_id)
        entry = {
            "task": rec.name,
            "tenant": rec.tenant,
            "reason": dec.reason,
            "revisit_on": dec.revisit_on,
            "deferred_at": prev["deferred_at"] if prev else time.time(),
            "count": (prev["count"] + 1) if prev else 1,
        }
        self.deferred[rec.job_id] = entry
        if (prev is None or prev["revisit_on"] != dec.revisit_on) and self.journal is not None:
            self.journal.append("job_deferred", job=rec.job_id, task=rec.name,
                                tenant=rec.tenant, reason=dec.reason,
                                revisit_on=dec.revisit_on, at=round(entry["deferred_at"], 6))
