"""The campaign runner: the real control plane, a virtual fleet, a simulated
clock.

Counterpart of ``saturn_tpu/twin/runner.py``, step for step.
:class:`TwinCampaign` is the twin's event loop, a mirror of
``service.server.SaturnService._run_loop`` (the same steps in the same
order) calling the port's production code:

- arrivals enter through the real ``GatewayServer`` admission path
  (``_op_submit``: the draining check, the request's deadline, the dedup
  table, the pressure-shrunk inflight window, the ``task_provider``
  rebuild); the server is built and never started, so no socket exists and
  frames are handed to it directly;
- admission verdicts come from the real ``AdmissionController``;
- every re-solve is the real ``anytime.anytime_resolve`` tier ladder, racing
  the real CPU clock against its deadline (``VirtualClock.patch`` leaves
  ``perf_counter`` alone on purpose);
- deadline-pressure shedding is the real ``project_pressure_shed``;
- topology changes run the real ``_handle_topology_change`` and
  ``ElasticReplanner``, fed by the real ``FleetHealthMonitor`` and
  ``FaultInjector`` from the virtual fleet's seeded failure schedules;
- only the leaves are substituted: :class:`~saturn_tpu_torch.twin.engine.
  VirtualEngine` for device time, :class:`~saturn_tpu_torch.twin.oracle.
  StaticOracle` for trial sweeps, and a :class:`~saturn_tpu_torch.twin.
  clock.VirtualClock` under ``time.time`` / ``monotonic`` / ``sleep``, so a
  day of traffic runs in seconds.

What a campaign writes into its directory:

- ``events.jsonl``: the deterministic event log (virtual timestamps and
  decisions only, no wall-clock field). The same config and seed (and
  trace) give the same bytes, in this package and in the JAX one.
- ``ledger.json``: the final verdict ledger (admission mix, solver tier
  counts, completion, failure and eviction totals). Deterministic.
- ``summary.json``: the ledger, the shares and the real ``wall_s`` (the one
  field that is not deterministic).
- ``journal/``: a real write-ahead journal in the service's format, so a
  campaign is itself a replayable trace.
- ``metrics.jsonl``: ordinary telemetry (``solver_tier`` events carry real
  ``wall_s``; not deterministic). ``CampaignConfig(metrics=False)`` turns
  it off.
"""

from __future__ import annotations

import json
import os
import time
import timeit
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from saturn_tpu_torch.twin.arrivals import arrival_stream
from saturn_tpu_torch.twin.clock import VirtualClock
from saturn_tpu_torch.twin.engine import VirtualEngine, forecast, rollback_forecast
from saturn_tpu_torch.twin.fleet import SliceSpec, VirtualFleet
from saturn_tpu_torch.twin.oracle import StaticOracle


@dataclass
class CampaignConfig:
    """Everything a campaign is a deterministic function of."""

    # ---- workload (synthesized unless ``trace_dir`` is set)
    n_jobs: int = 200
    total_batches: int = 3
    deadline_s: Optional[float] = None   # per-job deadline (pressure shed)
    max_retries: int = 1
    base_rate_hz: float = 12.0
    burst_rate_hz: float = 80.0
    trace_dir: Optional[str] = None      # replay a journaled real run
    # ---- virtual fleet
    n_slices: int = 4
    chips_per_slice: int = 8
    hbm_gib: float = 16.0
    # ---- control plane
    interval_s: float = 60.0             # SIMULATED seconds per interval
    solve_deadline_s: float = 2.0        # REAL seconds: the solver's race
    threshold: float = 0.0
    max_inflight: int = 64
    session: Optional[str] = None        # exercise the per-session window
    pressure_policy: str = "evict-lowest-priority"
    recovery_policy: str = "pause-resolve-resume"
    replan_degrade_factor: float = 2.0
    # ---- oracle
    n_families: int = 16
    flat_per_batch_s: Optional[float] = None  # trace-replay cost mode
    # ---- chaos (both schedules are pure functions of the fleet and seed)
    p_preempt: float = 0.0               # per-slice renewal reclaim probability
    outage_intervals: int = 2
    storm: bool = False                  # seeded_schedule chaos storm
    storm_p_preempt: float = 0.15
    storm_p_crash: float = 0.1
    storm_p_straggler: float = 0.05
    dedup_every: int = 0                 # > 0: every Nth job resubmits its
    #                                      predecessor's dedup key (a retry
    #                                      storm through the dedup table)
    tenant_mix: Optional[Dict[str, float]] = None  # tenant -> arrival weight
    #                                      (tenant-tagged arrivals, from a
    #                                      separate RNG stream)
    # ---- run control
    seed: int = 7
    max_intervals: int = 1000
    compact_every: int = 32              # queue.compact() cadence
    metrics: bool = True
    journal_plan_max_tasks: int = 1024   # no plan JSON above this size

    def describe(self) -> dict:
        return asdict(self)


@dataclass
class _Counters:
    submitted: int = 0
    duplicates: int = 0
    completed: int = 0
    failed: int = 0
    evicted: int = 0
    preemption_requeues: int = 0
    retries: int = 0
    crashes: int = 0
    topology_changes: int = 0
    backlog_drained: int = 0
    pressure_sheds: int = 0
    solves: int = 0
    deadline_misses: int = 0
    verdicts: Dict[str, int] = field(default_factory=dict)
    tiers: Dict[str, int] = field(default_factory=dict)
    gateway_sheds: Dict[str, int] = field(default_factory=dict)
    tenant_submitted: Dict[str, int] = field(default_factory=dict)
    tenant_sheds: Dict[str, int] = field(default_factory=dict)


def _shares(counts: Dict[str, int]) -> Dict[str, float]:
    total = sum(counts.values())
    if total == 0:
        return {}
    return {k: round(v / total, 6) for k, v in sorted(counts.items())}


class TwinCampaign:
    """One deterministic run of the control plane against a virtual fleet.

    Build it with a config and an output directory, then :meth:`run`:
    everything time-dependent is built inside the virtual clock's patch, so
    journals and event logs carry simulated timestamps."""

    def __init__(self, cfg: CampaignConfig, out_dir: str):
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.clock = VirtualClock()
        spec = SliceSpec(chips=cfg.chips_per_slice, hbm_gib=cfg.hbm_gib,
                         p_preempt=cfg.p_preempt, outage_intervals=cfg.outage_intervals)
        self.fleet = VirtualFleet(cfg.n_slices, spec)
        self.oracle = StaticOracle(self.fleet, seed=cfg.seed, n_families=cfg.n_families,
                                   flat_per_batch_s=cfg.flat_per_batch_s)
        self._arrivals = self._build_arrivals()
        self._next_arrival = 0
        self.counters = _Counters()
        self._events: List[str] = []
        self._intervals = 0
        self.summary: Optional[dict] = None
        # what GatewayServer, its window and the pressure check read off a
        # SaturnService, read off this campaign
        self.interval = cfg.interval_s
        self.task_provider = self.oracle.task_provider()
        self.last_pressure_shed: Optional[float] = None
        self.recovered_dedup: Dict[str, str] = {}
        self.journal = None
        self.queue = None
        self.tenancy = None  # tenant-tagged arrivals, no quotas

    # ----------------------------------------------------------- arrivals
    def _build_arrivals(self) -> List[Tuple[float, dict]]:
        """The (at_s, submit frame) list, ascending: a pure function of the
        config."""
        cfg = self.cfg
        out: List[Tuple[float, dict]] = []
        if cfg.trace_dir is not None:
            from saturn_tpu_torch.twin.trace import load_trace

            for j in load_trace(cfg.trace_dir).jobs:
                out.append((j.at_s, {
                    "op": "submit",
                    "job": {"name": j.name, "total_batches": j.total_batches,
                            "priority": j.priority, "deadline_s": j.deadline_s,
                            "max_retries": cfg.max_retries, "spec": j.spec},
                    "dedup_key": j.dedup_key,
                }))
            out.sort(key=lambda p: p[0])
            return out
        trace = arrival_stream(cfg.n_jobs, base_rate_hz=cfg.base_rate_hz,
                               burst_rate_hz=cfg.burst_rate_hz, seed=cfg.seed,
                               tenant_mix=cfg.tenant_mix)
        for arr in trace:
            name = f"twin-{arr.index:06d}"
            key = name
            if cfg.dedup_every > 0 and arr.index > 0 and arr.index % cfg.dedup_every == 0:
                # a retry storm: this submission repeats the previous job's
                # key and must collapse to a dedup hit
                key = f"twin-{arr.index - 1:06d}"
            out.append((arr.at_s, {
                "op": "submit",
                "job": {"name": name, "total_batches": cfg.total_batches,
                        "priority": arr.priority, "deadline_s": cfg.deadline_s,
                        "max_retries": cfg.max_retries, "spec": None, "tenant": arr.tenant},
                "dedup_key": key,
            }))
        return out

    # ------------------------------------------------------------- logging
    def _event(self, kind: str, **fields) -> None:
        """One line of the deterministic log: virtual time and decision
        fields only, never a real-clock quantity."""
        rec = {"t": round(self.clock.now(), 6), "kind": kind}
        rec.update(fields)
        self._events.append(json.dumps(rec, sort_keys=True))

    def _observe_job(self, event: str, rec, **fields) -> None:
        """The queue's observer, into the write-ahead journal: the JAX twin's
        record mapping, so campaign journals replay through the recovery
        and trace tools of either package."""
        jnl = self.journal
        if jnl is None:
            return
        if event == "submitted":
            jnl.log("job_submitted", job=rec.job_id, task=rec.name,
                    priority=rec.request.priority, deadline_s=rec.request.deadline_s,
                    max_retries=rec.request.max_retries,
                    total_batches=getattr(rec.task, "total_batches", None),
                    spec=rec.request.spec, dedup_key=rec.request.dedup_key)
        elif event == "state":
            jnl.append("job_state", job=rec.job_id, state=rec.state.value,
                       attempts=rec.attempts, requeues=rec.requeues, error=rec.error)

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        from saturn_tpu_torch.utils import metrics

        t_wall = timeit.default_timer()
        metrics_path = os.path.join(self.out_dir, "metrics.jsonl") if self.cfg.metrics else None
        with self.clock.patch():
            with metrics.scoped(metrics_path):
                self._setup()
                try:
                    status = self._loop()
                finally:
                    self.journal.close()
        wall_s = timeit.default_timer() - t_wall
        return self._finish(status, wall_s, metrics_path)

    def _setup(self) -> None:
        """Build the control plane under the patched clock, so every journal
        and queue timestamp is simulated time."""
        from saturn_tpu_torch.durability.journal import Journal
        from saturn_tpu_torch.resilience.faults import FaultInjector
        from saturn_tpu_torch.resilience.grow import GrowCoordinator
        from saturn_tpu_torch.resilience.health import FleetHealthMonitor
        from saturn_tpu_torch.resilience.replan import ElasticReplanner
        from saturn_tpu_torch.service.admission import AdmissionController
        from saturn_tpu_torch.service.gateway.server import GatewayServer
        from saturn_tpu_torch.service.queue import SubmissionQueue

        cfg = self.cfg
        self.topology = self.fleet.topology()
        self._base_topo = self.topology
        # a simulator pays no fsync per record; the bytes are the same
        self.journal = Journal(os.path.join(self.out_dir, "journal"), sync=False)
        self.queue = SubmissionQueue(observer=self._observe_job)
        # "twin-virtual" is no registered technique: the admission roster is
        # empty, no screen or sweep runs, and tasks arrive priced by the oracle
        self.admission = AdmissionController(self.topology, self.queue,
                                             technique_names=["twin-virtual"])
        self.admission.journal = self.journal
        # the real grow coordinator: grow events journal and the DEFER
        # backlog drains with attribution (virtual tasks pin no memory, so
        # no occupancy gate and no defrag wave)
        self.grow = GrowCoordinator(journal=self.journal)
        self.health = FleetHealthMonitor.for_topology(self.topology)
        self.replanner = ElasticReplanner(policy=cfg.recovery_policy,
                                          degrade_factor=cfg.replan_degrade_factor)
        schedule = []
        if cfg.storm:
            schedule = self.fleet.storm_schedule(
                cfg.seed, cfg.max_intervals, p_preempt=cfg.storm_p_preempt,
                p_crash=cfg.storm_p_crash, p_straggler=cfg.storm_p_straggler,
                outage_intervals=cfg.outage_intervals)
        elif cfg.p_preempt > 0.0:
            schedule = self.fleet.failure_schedule(cfg.seed, cfg.max_intervals)
        self.faults = FaultInjector(schedule) if schedule else None
        self.engine = VirtualEngine(self.health, self.faults)
        # the real gateway, never started: frames go straight into
        # _op_submit (dedup, window, shed and the task rebuild run for real)
        self.gateway = GatewayServer(self, max_inflight=cfg.max_inflight)

    # ------------------------------------------------------ arrival inject
    def _inject_until(self, horizon: float) -> None:
        """Submit every arrival due at or before ``horizon``, the clock
        advanced to each arrival's instant (the gateway takes
        ``time.monotonic()`` as the time a frame arrived)."""
        from saturn_tpu_torch.service.gateway.protocol import GatewayError

        c = self.counters
        while self._next_arrival < len(self._arrivals):
            at_s, frame = self._arrivals[self._next_arrival]
            if at_s > horizon:
                break
            self._next_arrival += 1
            self.clock.advance_to(max(self.clock.now(), at_s))
            arrival = time.monotonic()
            tenant = frame["job"].get("tenant")
            try:
                out = self.gateway._op_submit(dict(frame), self.cfg.session, arrival)
            except GatewayError as e:
                c.gateway_sheds[e.code] = c.gateway_sheds.get(e.code, 0) + 1
                if tenant is not None:
                    c.tenant_sheds[tenant] = c.tenant_sheds.get(tenant, 0) + 1
                self._event("gateway_shed", name=frame["job"]["name"], code=e.code,
                            tenant=tenant)
                continue
            if out.get("duplicate"):
                c.duplicates += 1
                self._event("dedup_hit", name=frame["job"]["name"], job=out["job_id"])
            else:
                c.submitted += 1
                if tenant is not None:
                    c.tenant_submitted[tenant] = c.tenant_submitted.get(tenant, 0) + 1

    def _arrivals_left(self) -> bool:
        return self._next_arrival < len(self._arrivals)

    # ------------------------------------------------------------ the loop
    def _loop(self) -> str:
        """The service loop; the step numbers are ``SaturnService._run_loop``'s."""
        from saturn_tpu_torch import analysis
        from saturn_tpu_torch.executor.orchestrator import (_handle_topology_change,
                                                            fold_realized_feedback)
        from saturn_tpu_torch.resilience.faults import PreemptedError
        from saturn_tpu_torch.service.admission import ADMIT, DEFER, compute_weight
        from saturn_tpu_torch.service.queue import JobRecord, JobState
        from saturn_tpu_torch.service.server import project_pressure_shed
        from saturn_tpu_torch.solver import anytime
        from saturn_tpu_torch.utils import metrics

        cfg = self.cfg
        c = self.counters
        jnl = self.journal
        topo = self.topology
        plan = None
        jobs: Dict[str, JobRecord] = {}
        interval_index = 0

        # arrivals strictly before the first interval boundary seed the run
        self._inject_until(0.0)
        while True:
            if not jobs and self.queue.depth() == 0:
                if not self._arrivals_left():
                    break
                # idle: jump to the next arrival (the real loop waits on the
                # queue's condition)
                next_at = self._arrivals[self._next_arrival][0]
                self.clock.advance_to(max(self.clock.now(), next_at))
                self._inject_until(self.clock.now())
                continue
            if interval_index >= cfg.max_intervals:
                self._intervals = interval_index
                return "max-intervals"

            # 1. health poll / topology change
            grew = False
            if self.faults is not None:
                self.faults.apply_due(interval_index, self.health)
            change = self.health.poll()
            if change is not None and change.kind in ("shrink", "grow"):
                c.topology_changes += 1
                evicted_names: dict = {}
                tasks = [r.task for r in jobs.values()]
                tasks, topo, plan = _handle_topology_change(
                    tasks, self._base_topo, self.health, self.replanner, change, plan,
                    cfg.solve_deadline_s, evicted_names)
                for name in sorted(evicted_names):
                    rec = jobs.pop(name, None)
                    if rec is not None:
                        self.queue.mark(rec, JobState.EVICTED, error=evicted_names[name])
                        c.evicted += 1
                        self._event("job_evicted", task=name, reason="topology-change")
                jnl.append("topology_change", **change.to_fields())
                self._event("topology_change", change=change.kind, lost=list(change.lost),
                            gained=list(change.gained))
                if change.kind == "grow":
                    # the recovery half: journal the grow (the twin has no
                    # guardian backoffs to end)
                    grew = True
                    self.grow.note_grow(change, interval_index,
                                        n_deferred=len(self.admission.deferred),
                                        capacity=topo.capacity)
                    self._event("grow_event", gained=list(change.gained),
                                n_deferred=len(self.admission.deferred))
            elif change is not None:  # degrade: advisory
                metrics.event("topology_change", **change.to_fields())
                self._event("topology_change", change=change.kind,
                            stragglers=list(change.stragglers))

            # 2. drain arrivals through admission (the real controller)
            deferred_before = set(self.admission.deferred)
            newly_admitted: List[JobRecord] = []
            for rec in self.queue.drain():
                dec = self.admission.admit(rec, topo)
                c.verdicts[dec.action] = c.verdicts.get(dec.action, 0) + 1
                self._event("admission", job=rec.job_id, task=rec.name, decision=dec.action)
                if dec.action == ADMIT:
                    jobs[rec.name] = rec
                    newly_admitted.append(rec)
                elif dec.action == DEFER:
                    self.queue.requeue(rec)
                else:  # REJECT
                    self.queue.mark(rec, JobState.FAILED, error=dec.reason)
                    c.failed += 1
            drained = sorted(deferred_before & {r.job_id for r in newly_admitted})
            if drained:
                trigger = "grow" if grew else "interval"
                self.grow.note_drained(drained, interval_index, trigger=trigger)
                c.backlog_drained += len(drained)
                self._event("backlog_drain", jobs=drained, trigger=trigger)

            # 3. (no cancel sweep: the twin has no interactive clients)

            # 4. admission pressure: the service's projection
            shed, proj, limit = project_pressure_shed(jobs, topo, plan, cfg.pressure_policy)
            if shed:
                self.last_pressure_shed = time.monotonic()
            for rec in shed:
                jobs.pop(rec.name, None)
                self.queue.mark(rec, JobState.EVICTED, error="admission-pressure")
                c.evicted += 1
                c.pressure_sheds += 1
                self._event("pressure_shed", task=rec.name, projection=round(proj, 6),
                            limit=round(limit, 6))

            if not jobs:
                plan = None
                interval_index += 1
                boundary = self.clock.now() + cfg.interval_s
                self._inject_until(boundary)
                self.clock.advance_to(boundary)
                continue

            # 5. incremental re-solve: the real tier ladder racing the real
            #    CPU clock (perf_counter is not patched) against the deadline
            tasks = [r.task for r in jobs.values()]
            now_v = time.monotonic()
            weights = {}
            for r in jobs.values():
                slack = r.deadline_at - now_v if r.deadline_at is not None else None
                feas = r.task.feasible_strategies()
                est = min((s.runtime for s in feas.values()), default=0.0)
                r.weight = compute_weight(r.request.priority, slack, est)
                weights[r.name] = r.weight
            candidate = anytime.anytime_resolve(
                tasks, topo, plan, cfg.interval_s, cfg.threshold,
                deadline=cfg.solve_deadline_s, weights=weights, source="twin", seed=cfg.seed)
            try:
                analysis.verify_or_raise(candidate, topology=topo, tasks=tasks,
                                         source="twin-re-solve")
            except analysis.PlanVerificationError as e:
                codes = sorted({d.code for d in e.report.errors})
                jnl.log("plan_quarantine", interval=interval_index, source="twin-re-solve",
                        codes=codes)
                self._event("plan_quarantine", codes=codes)
                if plan is None:
                    raise
            else:
                plan = candidate
            rep = getattr(plan, "anytime", None)
            if rep is not None:
                c.solves += 1
                t = str(rep.tier)
                c.tiers[t] = c.tiers.get(t, 0) + 1
                if rep.deadline_missed:
                    c.deadline_misses += 1
                self._event("solve", interval=interval_index, tier=rep.tier,
                            tier_name=rep.tier_name, outcome=rep.outcome, n_tasks=len(tasks),
                            makespan=round(plan.makespan, 6))
            # a plan of 100k tasks per interval would dominate the journal:
            # above the limit, commit the decision without its payload
            jnl.append("plan_commit", interval=interval_index, makespan=plan.makespan,
                       plan=(plan.to_json()
                             if len(plan.assignments) <= cfg.journal_plan_max_tasks else None))
            jnl.commit()
            for rec in newly_admitted:
                if rec.name in jobs:
                    self.queue.mark(rec, JobState.SCHEDULED)

            # 6. forecast and run one interval on the virtual engine
            run_tasks, batches, completed = forecast(tasks, cfg.interval_s, plan)
            errors: Dict[str, Exception] = {}
            if run_tasks:
                errors = self.engine.execute(
                    run_tasks, batches, cfg.interval_s, plan, topo,
                    interval_index=interval_index, on_task_start=self._on_start(jobs),
                    on_task_done=self._on_done(jobs))

            # the interval's simulated time passes here; arrivals due during
            # it reach the gateway at their own instants
            boundary = self.clock.now() + cfg.interval_s
            self._inject_until(boundary)
            self.clock.advance_to(boundary)

            # 7. estimate feedback (the real EWMA fold)
            fold_realized_feedback(run_tasks)

            preempted = {n: e for n, e in errors.items() if isinstance(e, PreemptedError)}
            failed = {n: e for n, e in errors.items() if n not in preempted}

            # 8. preemptions requeue through the queue, no retry used
            for name in sorted(preempted):
                rec = jobs.pop(name)
                rollback_forecast(rec.task, batches.get(name, 0))
                self.queue.requeue(rec)
                c.preemption_requeues += 1
                self._event("task_preempted", task=name)
            completed = [t for t in completed if t.name not in preempted]

            # 9. other failures: retry within the budget, else FAILED
            for name, err in sorted(failed.items()):
                rec = jobs[name]
                rec.attempts += 1
                c.crashes += 1
                if rec.attempts <= rec.request.max_retries:
                    rollback_forecast(rec.task, batches.get(name, 0))
                    c.retries += 1
                    self._event("task_retry", task=name, attempt=rec.attempts)
                else:
                    jobs.pop(name)
                    self.queue.mark(rec, JobState.FAILED, error=repr(err))
                    c.failed += 1
                    self._event("job_failed", job=rec.job_id, task=name)
            completed = [t for t in completed if t.name not in failed]

            # 10. retire completions
            for t in completed:
                rec = jobs.pop(t.name)
                self.queue.mark(rec, JobState.DONE)
                c.completed += 1
                self._event("job_completed", job=rec.job_id, task=t.name,
                            requeues=rec.requeues, attempts=rec.attempts)

            jnl.commit()
            metrics.flush()
            interval_index += 1
            if cfg.compact_every > 0 and interval_index % cfg.compact_every == 0:
                self.queue.compact()
        self._intervals = interval_index
        return "ok"

    def _on_start(self, jobs):
        from saturn_tpu_torch.service.queue import JobState

        def on_start(name: str) -> None:
            rec = jobs.get(name)
            if rec is not None and rec.state is JobState.SCHEDULED:
                self.queue.mark(rec, JobState.RUNNING)

        return on_start

    def _on_done(self, jobs):
        jnl = self.journal
        ids = {name: rec.job_id for name, rec in jobs.items()}

        def on_done(name: str, batches: int) -> None:
            if batches > 0:
                jnl.append("task_progress", task=name, job=ids.get(name),
                           batches=int(batches))

        return on_done

    # -------------------------------------------------------------- outputs
    def _finish(self, status: str, wall_s: float, metrics_path: Optional[str]) -> dict:
        c = self.counters
        with open(os.path.join(self.out_dir, "events.jsonl"), "w") as fh:
            fh.write("\n".join(self._events))
            if self._events:
                fh.write("\n")
        ledger = {
            "status": status,
            "n_arrivals": len(self._arrivals),
            "submitted": c.submitted,
            "duplicates": c.duplicates,
            "gateway_sheds": dict(sorted(c.gateway_sheds.items())),
            "shed_total": sum(c.gateway_sheds.values()),
            "admission": dict(sorted(c.verdicts.items())),
            "tier_counts": dict(sorted(c.tiers.items())),
            "solves": c.solves,
            "deadline_misses": c.deadline_misses,
            "completed": c.completed,
            "failed": c.failed,
            "evicted": c.evicted,
            "preemption_requeues": c.preemption_requeues,
            "retries": c.retries,
            "crashes": c.crashes,
            "topology_changes": c.topology_changes,
            "backlog_drained": c.backlog_drained,
            "pressure_sheds": c.pressure_sheds,
            "intervals": self._intervals,
            "makespan_s": round(self.clock.now(), 6),
        }
        if c.tenant_submitted or c.tenant_sheds:
            ledger["tenant_submitted"] = dict(sorted(c.tenant_submitted.items()))
            ledger["tenant_sheds"] = dict(sorted(c.tenant_sheds.items()))
        with open(os.path.join(self.out_dir, "ledger.json"), "w") as fh:
            json.dump(ledger, fh, indent=1, sort_keys=True)
            fh.write("\n")
        summary = dict(ledger)
        summary.update({
            "config": self.cfg.describe(),
            "fleet": self.fleet.describe(),
            "tier_shares": _shares(c.tiers),
            "verdict_shares": _shares(c.verdicts),
            "wall_s": round(wall_s, 3),   # real seconds: not deterministic
            "sim_speedup": round(self.clock.now() / wall_s, 2) if wall_s > 0 else None,
            "out_dir": self.out_dir,
            "metrics_path": metrics_path,
        })
        with open(os.path.join(self.out_dir, "summary.json"), "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        self.summary = summary
        return summary


def run_campaign(cfg: CampaignConfig, out_dir: str) -> dict:
    """Build and run one campaign; returns (and writes) its summary."""
    return TwinCampaign(cfg, out_dir).run()


def run_what_if(base: CampaignConfig, out_dir: str) -> dict:
    """Capacity planning: the base campaign against (a) one more virtual
    slice and (b) every job's deadline relaxed 2x. The same seed gives the
    same arrivals, so a verdict's delta belongs to the knob alone."""
    scenarios = {
        "base": base,
        "add-slice": replace(base, n_slices=base.n_slices + 1),
        "relax-deadlines": replace(base, deadline_s=(base.deadline_s * 2.0
                                                     if base.deadline_s is not None else None)),
    }
    results = {name: run_campaign(cfg, os.path.join(out_dir, name))
               for name, cfg in scenarios.items()}
    keys = ("completed", "failed", "evicted", "shed_total", "deadline_misses", "makespan_s",
            "pressure_sheds")
    comparison = {name: {k: res[k] for k in keys} for name, res in results.items()}
    verdict = {"comparison": comparison, "out_dir": out_dir}
    with open(os.path.join(out_dir, "whatif.json"), "w") as fh:
        json.dump(verdict, fh, indent=1, sort_keys=True)
        fh.write("\n")
    verdict["results"] = results
    return verdict
