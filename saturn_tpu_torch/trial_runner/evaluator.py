"""Trial runner: profile every (task x block size x technique) combination.

Counterpart of ``saturn_tpu/trial_runner/evaluator.py``: keep the fastest
feasible technique per size, seed unsearched sizes with an infeasible dummy,
scale per-batch time to total runtime. Trials run one after another. The
JAX package's persistent profile cache, anchor-size pruning, static memory
pruning and fused-group trials are later items; asking for them raises.
"""

from __future__ import annotations

import logging
import random
import time
import timeit
from typing import Dict, List, Optional, Sequence

from saturn_tpu_torch import library as lib
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy

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
    profile_cache=None,
    prune: bool = True,
    compile_cache_dir: Optional[str] = None,
    trial_retries: int = 2,
    retry_backoff_s: float = 0.05,
) -> Dict[str, int]:
    """Fill ``task.strategies`` for every task in place; returns
    ``{"trials_run": n}``.

    ``technique_names=None`` uses the whole library (registering the default
    library if nothing is registered). A technique whose ``search`` raises
    is retried ``trial_retries`` times with exponential backoff; the last
    failure propagates to the caller (a config that runs out of device
    memory is infeasible, not a failure). ``profile_cache=None`` means no cache (the
    port has none yet); a path raises, as do ``metrics_path``,
    ``trace_dir``, ``compile_cache_dir``, ``parallel_trials > 1`` and
    ``prune`` on a grid of ``PRUNE_MIN_GRID`` sizes or more.
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    for name, value in (("metrics_path", metrics_path), ("trace_dir", trace_dir),
                        ("compile_cache_dir", compile_cache_dir)):
        if value is not None:
            raise NotImplementedError(f"search({name}=...): a later item of the PyTorch port")
    if profile_cache not in (None, False):
        raise NotImplementedError("search(profile_cache=...): a later item of the PyTorch port")
    if parallel_trials not in (None, 1):
        raise NotImplementedError("search(parallel_trials>1): trials run one at a time")
    topo = topology if topology is not None else SliceTopology()
    if prune and len(topo.valid_sizes()) >= PRUNE_MIN_GRID:
        raise NotImplementedError(
            "anchor-size pruning is a later item of the PyTorch port; pass prune=False"
        )
    if technique_names is None and not lib.registered_names():
        lib.register_default_library()
    classes = lib.retrieve(technique_names)
    if not isinstance(classes, list):
        classes = [classes]
    techniques = [(getattr(cls, "name", cls.__name__), cls()) for cls in classes]

    trials = 0
    for task in tasks:
        sizes = topo.valid_sizes()
        if task.chip_range is not None:
            sizes = [s for s in sizes if s in task.chip_range]
        for name, tech in techniques:
            for g in sorted(sizes, reverse=True):
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
                        logger.warning("trial (%s, g=%d, %s) raised on attempt %d: %r",
                                       task.name, g, name, attempt + 1, e)
                        delay = retry_backoff_s * (2 ** attempt)
                        time.sleep(delay * (1.0 + random.Random(
                            f"{task.name}:{g}:{name}:{attempt}").random()))
                dt = timeit.default_timer() - t0
                if params is None or per_batch is None:
                    logger.info("trial (%s, g=%d, %s): infeasible", task.name, g, name)
                    continue
                total = per_batch * task.total_batches
                logger.info("trial (%s, g=%d, %s): %.4fs/batch, est total %.1fs "
                            "(trial took %.1fs)", task.name, g, name, per_batch, total, dt)
                cur = task.strategies.get(g)
                if cur is None or not cur.feasible or total < cur.runtime:
                    task.strategies[g] = Strategy(
                        executor=tech, apportionment=g, params=params,
                        runtime=total, per_batch_time=per_batch,
                    )
        for g in topo.valid_sizes():
            if g not in task.strategies:
                task.strategies[g] = Strategy(None, g, None, DUMMY_RUNTIME)
    return {"trials_run": trials}
