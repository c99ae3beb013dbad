"""Trial runner: profile every (task x block size x technique) combination.

Counterpart of ``saturn_tpu/trial_runner/evaluator.py``: keep the fastest
feasible technique per size, seed unsearched sizes with an infeasible dummy,
scale per-batch time to total runtime. Trials run one after another, and
the persistent profile cache (``utils/profile_cache.py``, on by default) is
consulted for each grid point just before its trial would run, so the first
task of a signature profiles it and the others with the same signature in
the same sweep are cache hits (the JAX package looks every point up before
any trial runs, so within one fresh sweep it profiles each of them). The
JAX package's anchor-size pruning, static memory pruning and fused-group
trials are later items; asking for them raises.
"""

from __future__ import annotations

import logging
import random
import time
import timeit
from typing import Any, Dict, List, Optional, Sequence

from saturn_tpu_torch import library as lib
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.utils import metrics
from saturn_tpu_torch.utils import profile_cache as pcache

logger = logging.getLogger("saturn_tpu_torch")

DUMMY_RUNTIME = 1e6  # runtime of the infeasible placeholder strategy

#: The JAX package prunes to anchor sizes from this many sizes up.
PRUNE_MIN_GRID = 4


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
) -> Dict[str, int]:
    """Fill ``task.strategies`` for every task in place; returns
    ``{"trials_run", "cache_hits", "pruned"}`` (``pruned`` is 0: pruning is
    a later item).

    ``technique_names=None`` uses the whole library (registering the default
    library if nothing is registered). ``profile_cache``: ``None`` uses the
    environment's persistent cache (on by default;
    ``SATURN_TPU_PROFILE_CACHE=0`` disables it), ``False`` turns caching off
    for this sweep, a path uses that directory. A cache hit costs no trial.
    ``metrics_path`` appends JSONL events (``trial``, ``profile_cache``,
    ``trial_retry``). A technique whose ``search`` raises is retried
    ``trial_retries`` times with exponential backoff; the last failure
    propagates to the caller (a config that runs out of device memory is
    infeasible, not a failure). ``trace_dir``, ``compile_cache_dir``,
    ``parallel_trials > 1`` and ``prune`` on a grid of ``PRUNE_MIN_GRID``
    sizes or more raise.
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    for name, value in (("trace_dir", trace_dir), ("compile_cache_dir", compile_cache_dir)):
        if value is not None:
            raise NotImplementedError(f"search({name}=...): a later item of the PyTorch port")
    if parallel_trials not in (None, 1):
        raise NotImplementedError("search(parallel_trials>1): trials run one at a time")
    topo = topology if topology is not None else SliceTopology()
    if prune and len(topo.valid_sizes()) >= PRUNE_MIN_GRID:
        raise NotImplementedError(
            "anchor-size pruning is a later item of the PyTorch port; pass prune=False"
        )
    cache = pcache.resolve(profile_cache)
    with metrics.scoped(metrics_path):
        return _search_inner(tasks, technique_names, topo, cache,
                             trial_retries, retry_backoff_s)


def _search_inner(tasks, technique_names, topo, cache, trial_retries,
                  retry_backoff_s) -> Dict[str, int]:
    if technique_names is None and not lib.registered_names():
        lib.register_default_library()
    classes = lib.retrieve(technique_names)
    if not isinstance(classes, list):
        classes = [classes]
    techniques = [(getattr(cls, "name", cls.__name__), cls()) for cls in classes]
    # ``is not None``: an empty ProfileCache is falsy (it has a __len__)
    topo_sig = pcache.topology_signature(topo) if cache is not None else ""
    runtime = pcache.runtime_signature() if cache is not None else None

    def install(task, g: int, tech, params, per_batch: float, key) -> None:
        total = per_batch * task.total_batches
        cur = task.strategies.get(g)
        if cur is None or not cur.feasible or total < cur.runtime:
            task.strategies[g] = Strategy(
                executor=tech, apportionment=g, params=params,
                runtime=total, per_batch_time=per_batch, cache_key=key,
                cache_dir=cache.root if key is not None else None,
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
                        install(task, g, tech, entry["params"], entry["per_batch_time"], key)
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
                logger.info("trial (%s, g=%d, %s): %.4fs/batch, est total %.1fs "
                            "(trial took %.1fs)", task.name, g, name, per_batch, total, dt)
                metrics.event("trial", task=task.name, size=g, technique=name,
                              feasible=True, per_batch_s=per_batch, est_total_s=total,
                              params=params)
                if cache is not None:
                    cache.put(key, technique=name, size=g, feasible=True,
                              params=params, per_batch_time=per_batch)
                install(task, g, tech, params, per_batch, key)
        for g in topo.valid_sizes():
            if g not in task.strategies:
                task.strategies[g] = Strategy(None, g, None, DUMMY_RUNTIME)
    if trials or hits:
        logger.info("trial runner: sweep complete — %d trials run, %d cache hits",
                    trials, hits)
    return {"trials_run": trials, "cache_hits": hits, "pruned": 0}
