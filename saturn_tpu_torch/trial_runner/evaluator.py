"""Trial runner: profile every (task x block size x technique) combination.

Counterpart of ``saturn_tpu/trial_runner/evaluator.py``: keep the fastest
feasible technique per size, seed unsearched sizes with an infeasible dummy,
scale per-batch time to total runtime. Trials run one after another, and
the persistent profile cache (``utils/profile_cache.py``, on by default) is
consulted for each grid point just before its trial would run, so the first
task of a signature profiles it and the others with the same signature in
the same sweep are cache hits (the JAX package looks every point up before
any trial runs, so within one fresh sweep it profiles each of them). The
JAX package's anchor-size pruning and static memory pruning are later
items; asking for them raises. After the grid, the sweep proposes fusion
groups (``parallel.fused.fusion_candidates``) and measures each one's
stacked lockstep step (``profile_fused_group``), which the solver prices
fusion on. A fused trial that raises for any reason other than running out
of device memory ends the sweep, as a solo trial does (the JAX package
skips such a group).
"""

from __future__ import annotations

import logging
import random
import time
import timeit
from typing import Any, Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch import library as lib
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.utils import compile_cache, metrics, trace
from saturn_tpu_torch.utils import profile_cache as pcache

logger = logging.getLogger("saturn_tpu_torch")

DUMMY_RUNTIME = 1e6  # runtime of the infeasible placeholder strategy

#: The JAX package prunes to anchor sizes from this many sizes up.
PRUNE_MIN_GRID = 4


def _fit_scaling_model(points: Sequence[Tuple[int, float]]):
    """Least-squares Amdahl fit ``t(g) = a + b / g`` over measured (size,
    per-batch seconds) points (the JAX package's; the elastic replanner
    synthesizes sizes never profiled from it). A degenerate fit clamps to
    the pure-serial or pure-parallel edge instead of going negative."""
    import numpy as np

    g = np.asarray([p[0] for p in points], dtype=float)
    t = np.asarray([p[1] for p in points], dtype=float)
    A = np.stack([np.ones_like(g), 1.0 / g], axis=1)
    try:
        (a, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    except np.linalg.LinAlgError:
        a, b = float(t.mean()), 0.0
    if a < 0.0 or b < 0.0:
        if b < 0.0:  # time growing with devices is noise: the flat (serial) model
            a, b = float(t.mean()), 0.0
        else:
            a, b = 0.0, float((t * g).mean())
    return lambda size: a + b / float(size)


def search(
    tasks: Sequence,
    technique_names: Optional[List[str]] = None,
    log: bool = False,
    topology: Optional[SliceTopology] = None,
    metrics_path: Optional[str] = None,
    trace_dir: Optional[str] = None,
    parallel_trials: Optional[int] = None,
    profile_cache: Any = None,
    prune: bool = True,
    compile_cache_dir: Optional[str] = None,
    trial_retries: int = 2,
    retry_backoff_s: float = 0.05,
    fusion: bool = True,
) -> Dict[str, int]:
    """Fill ``task.strategies`` for every task in place; returns
    ``{"trials_run", "cache_hits", "pruned", "fused_groups"}`` (``pruned``
    is 0: pruning is a later item; ``fused_groups`` counts the fusion groups
    whose stacked step was measured).

    ``technique_names=None`` uses the whole library (registering the default
    library if nothing is registered). ``profile_cache``: ``None`` uses the
    environment's persistent cache (on by default;
    ``SATURN_TPU_PROFILE_CACHE=0`` disables it), ``False`` turns caching off
    for this sweep, a path uses that directory. A cache hit costs no trial.
    ``metrics_path`` appends JSONL events (``trial``, ``profile_cache``,
    ``trial_retry``). ``trace_dir`` records the sweep in a torch.profiler
    trace there (``utils/trace.py``). ``compile_cache_dir`` keeps the
    port's compiled kernels and native libraries in that directory for this
    process and any later one pointed at it (``utils/compile_cache.py``,
    the same as ``SATURN_TPU_COMPILE_CACHE_DIR``). A technique whose
    ``search`` raises is retried ``trial_retries`` times with exponential
    backoff; the last failure propagates to the caller (a config that runs
    out of device memory is infeasible, not a failure).
    ``parallel_trials > 1`` and ``prune`` on a grid of ``PRUNE_MIN_GRID``
    sizes or more raise. ``fusion=False`` measures no fusion group (the JAX
    package always does; the port's option keeps a sweep solo).
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    if compile_cache_dir:
        compile_cache.enable(compile_cache_dir)
    if parallel_trials not in (None, 1):
        raise NotImplementedError("search(parallel_trials>1): trials run one at a time")
    topo = topology if topology is not None else SliceTopology()
    if prune and len(topo.valid_sizes()) >= PRUNE_MIN_GRID:
        raise NotImplementedError(
            "anchor-size pruning is a later item of the PyTorch port; pass prune=False"
        )
    cache = pcache.resolve(profile_cache)
    with metrics.scoped(metrics_path), trace.profile_trace(trace_dir):
        return _search_inner(tasks, technique_names, topo, cache,
                             trial_retries, retry_backoff_s, fusion)


def _search_inner(tasks, technique_names, topo, cache, trial_retries,
                  retry_backoff_s, fusion=True) -> Dict[str, int]:
    if technique_names is None and not lib.registered_names():
        lib.register_default_library()
    classes = lib.retrieve(technique_names)
    if not isinstance(classes, list):
        classes = [classes]
    techniques = [(getattr(cls, "name", cls.__name__), cls()) for cls in classes]
    # ``is not None``: an empty ProfileCache is falsy (it has a __len__)
    topo_sig = pcache.topology_signature(topo) if cache is not None else ""
    runtime = pcache.runtime_signature() if cache is not None else None

    def install(task, g: int, tech, params, per_batch: float, key,
                host_fraction: float = 0.0, peak_bytes=None) -> None:
        total = per_batch * task.total_batches
        cur = task.strategies.get(g)
        if cur is None or not cur.feasible or total < cur.runtime:
            task.strategies[g] = Strategy(
                executor=tech, apportionment=g, params=params,
                runtime=total, per_batch_time=per_batch, cache_key=key,
                cache_dir=cache.root if key is not None else None,
                host_fraction=float(host_fraction or 0.0), peak_bytes=peak_bytes,
            )

    trials = hits = 0
    for task in tasks:
        sizes = topo.valid_sizes()
        if task.chip_range is not None:
            sizes = [s for s in sizes if s in task.chip_range]
        task_sig = pcache.task_signature(task) if cache is not None else None
        for name, tech in techniques:
            for g in sorted(sizes, reverse=True):
                key = (pcache.fingerprint(task_sig, name, g, topo_sig, runtime)
                       if cache is not None else None)
                entry = cache.get(key) if cache is not None else None
                if entry is not None:
                    hits += 1
                    metrics.event("profile_cache", hit=True, task=task.name, size=g,
                                  technique=name, feasible=entry["feasible"],
                                  source=entry.get("source", "trial"))
                    logger.info("trial (%s, g=%d, %s): profile-cache hit (%s)",
                                task.name, g, name, entry.get("source", "trial"))
                    if entry["feasible"]:
                        install(task, g, tech, entry["params"], entry["per_batch_time"], key,
                                entry.get("host_fraction", 0.0), entry.get("peak_bytes"))
                    continue
                if cache is not None:
                    metrics.event("profile_cache", hit=False, task=task.name, size=g,
                                  technique=name)
                devices = topo.blocks(g)[0].devices_of(topo.devices)
                trials += 1
                t0 = timeit.default_timer()
                params = per_batch = None
                for attempt in range(max(0, trial_retries) + 1):
                    try:
                        params, per_batch = tech.search(task, devices, trials)
                        break
                    except Exception as e:
                        if attempt >= trial_retries:
                            raise
                        delay = retry_backoff_s * (2 ** attempt)
                        delay *= 1.0 + random.Random(
                            f"{task.name}:{g}:{name}:{attempt}").random()
                        metrics.event("trial_retry", task=task.name, size=g,
                                      technique=name, attempt=attempt + 1,
                                      backoff_s=round(delay, 6), error=repr(e))
                        logger.warning("trial (%s, g=%d, %s) raised on attempt %d: %r",
                                       task.name, g, name, attempt + 1, e)
                        time.sleep(delay)
                dt = timeit.default_timer() - t0
                if params is None or per_batch is None:
                    # on one device the verdict is the measured peak memory;
                    # a multi-device block is not carried yet, which is not
                    # a result to keep
                    memory = len(devices) == 1
                    logger.info("trial (%s, g=%d, %s): infeasible", task.name, g, name)
                    metrics.event("trial", task=task.name, size=g, technique=name,
                                  feasible=False, memory_infeasible=memory)
                    if cache is not None and memory:
                        cache.put(key, technique=name, size=g, feasible=False,
                                  memory_infeasible=True)
                    continue
                total = per_batch * task.total_batches
                reporter = getattr(tech, "trial_report", None)
                report = reporter(task.name, g) if reporter else {}
                hf = float(report.get("host_fraction", 0.0))
                peak = report.get("peak_bytes")
                logger.info("trial (%s, g=%d, %s): %.4fs/batch, est total %.1fs, host "
                            "fraction %.4f (trial took %.1fs)", task.name, g, name,
                            per_batch, total, hf, dt)
                metrics.event("trial", task=task.name, size=g, technique=name,
                              feasible=True, per_batch_s=per_batch, est_total_s=total,
                              params=params, host_fraction=round(hf, 4))
                if cache is not None:
                    cache.put(key, technique=name, size=g, feasible=True,
                              params=params, per_batch_time=per_batch, host_fraction=hf,
                              peak_bytes=peak)
                install(task, g, tech, params, per_batch, key, hf, peak)
        for g in topo.valid_sizes():
            if g not in task.strategies:
                task.strategies[g] = Strategy(None, g, None, DUMMY_RUNTIME)
    if trials or hits:
        logger.info("trial runner: sweep complete — %d trials run, %d cache hits",
                    trials, hits)
    fused_groups = 0
    from saturn_tpu_torch.parallel import fused

    by_name = {t.name: t for t in tasks}
    for names in fused.fusion_candidates(list(tasks)) if fusion else ():
        group = [by_name[n] for n in names]
        # a stack is device-resident: a member whose best is a host state
        # (offload) does not fuse
        if any(1 not in t.feasible_strategies()
               or getattr(t.strategies[1].executor, "host_state", False) for t in group):
            continue
        if any(v > 0 for v in profile_fused_group(group, topology=topo).values()):
            fused_groups += 1
    if fused_groups:
        logger.info("trial runner: %d fused group(s) measured", fused_groups)
    return {"trials_run": trials, "cache_hits": hits, "pruned": 0,
            "fused_groups": fused_groups}


def profile_fused_group(
    tasks: Sequence,
    sizes: Optional[Sequence[int]] = None,
    topology: Optional[SliceTopology] = None,
    metrics_path: Optional[str] = None,
) -> Dict[int, float]:
    """Measure the fused stack of ``tasks`` and price its lockstep step.

    At each size where every member holds a feasible strategy (only one
    device is carried: size 1), time the stacked program on fresh member
    states as ``execute`` dispatches it (``parallel.fused.time_stacked``:
    windows of K on the card, CUDA graphs) and write the seconds per
    lockstep step into every member's ``Strategy.fused_per_batch_time``
    there. A size that runs out of device memory stays unpriced (never
    fused); any other failure raises. Neither checkpoints nor moves a
    cursor. Returns ``{size: seconds per lockstep step}``. Raises
    ``ValueError`` for an unfusable group (fingerprints that differ or are
    None, fewer than two members)."""
    import torch

    from saturn_tpu_torch.parallel import fused

    members = list(tasks)
    if len(members) < 2:
        raise ValueError("a fused group needs at least 2 members")
    fps = {fused.fusion_fingerprint(t) for t in members}
    if len(fps) != 1 or None in fps:
        raise ValueError("tasks are not fusable: fusion fingerprints differ or are None "
                         f"({[t.name for t in members]})")
    topo = topology if topology is not None else SliceTopology()
    if sizes is None:
        candidates = [g for g in topo.valid_sizes()
                      if all(g in t.strategies and t.strategies[g].feasible for t in members)]
    else:
        valid = set(topo.valid_sizes())
        candidates = [int(g) for g in sizes if int(g) in valid]
    measured: Dict[int, float] = {}
    names = [t.name for t in members]
    with metrics.scoped(metrics_path):
        for g in candidates:
            if g != 1:
                continue  # a stack runs on one device (``fused.usable_devices``)
            devices = topo.blocks(g)[0].devices_of(topo.devices)
            strat = members[0].strategies[g]
            try:
                per_step, info = fused.time_stacked(members, devices, inner=strat.executor,
                                                    config=dict(strat.params or {}))
            except torch.cuda.OutOfMemoryError as e:
                import traceback

                traceback.clear_frames(e.__traceback__)
                logger.info("fused trial (%s, g=%d): out of device memory", "+".join(names), g)
                metrics.event("trial_fused", tasks=names, size=g, n_members=len(members),
                              feasible=False, error=repr(e))
                continue
            for m in members:
                s = m.strategies.get(g)
                if s is not None and s.feasible:
                    s.fused_per_batch_time = per_step
            measured[g] = per_step
            logger.info("fused trial (%s, g=%d, N=%d): %.4fs/lockstep step (K=%d), peak "
                        "%.2f GiB", "+".join(names), g, len(members), per_step, info["k"],
                        info["peak_bytes"] / 2**30)
            metrics.event("trial_fused", tasks=names, size=g, n_members=len(members),
                          feasible=True, per_step_s=per_step, k=info["k"],
                          peak_bytes=info["peak_bytes"])
    return measured
