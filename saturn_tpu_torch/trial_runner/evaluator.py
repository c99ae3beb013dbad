"""Trial runner: profile every (task x block size x technique) combination.

Counterpart of ``saturn_tpu/trial_runner/evaluator.py``: keep the fastest
feasible technique per size, seed unsearched sizes with an infeasible dummy,
scale per-batch time to total runtime. The sweep is the JAX package's, lane
for lane: one lane per (task, technique); the persistent profile cache
(``utils/profile_cache.py``, on by default) is consulted for every grid
point first; on a grid of ``PRUNE_MIN_GRID`` sizes or more only the anchor
sizes (the smallest, the largest and one midpoint, ``_anchor_sizes``) are
trialled and the others are filled from the Amdahl fit ``t(g) = a + b / g``
over the lane's measured points (``_fit_scaling_model``), as strategies
flagged ``interpolated``; sizes run largest first, a size class at a time,
and a memory verdict at size g prunes the lane's smaller sizes
(``memory_monotone``). Within a size class, ``parallel_trials`` trials run
at once on disjoint blocks, each on its own thread.

Where the port differs (``ROADMAP.md`` queue 3):

- a grid point is looked up in the cache again just before its trial runs,
  so the first task of a signature profiles it and the others with the
  same signature in the same sweep are cache hits (the JAX package looks
  every point up only before any trial runs);
- JAX's memlens pre-prune is the technique's static screen
  (``SPMDTechnique._static_screen``), run inside its ``search``: a grid
  point it refuses draws nothing and is a memory verdict;
- ``parallel_trials`` defaults to 4 only where the blocks hold distinct
  CUDA devices, else 1 (trials that share a card would time each other;
  the JAX package gives 4 off the CPU);
- the memory floor prunes only on a pool whose positions name distinct
  devices (where positions share a card, a larger block holds more
  replicas on it, not fewer bytes each);
- a trial that raises for any reason other than running out of device
  memory ends the sweep after its retries (the JAX package marks it
  infeasible).

After the grid, the sweep proposes fusion groups
(``parallel.fused.fusion_candidates``) and measures each one's stacked
lockstep step (``profile_fused_group``), which the solver prices fusion on.
A fused trial that raises for any reason other than running out of device
memory ends the sweep, as a solo trial does (the JAX package skips such a
group).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
import timeit
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch import library as lib
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.utils import compile_cache, metrics, trace
from saturn_tpu_torch.utils import profile_cache as pcache

logger = logging.getLogger("saturn_tpu_torch")

DUMMY_RUNTIME = 1e6  # runtime of the infeasible placeholder strategy

#: Anchor-size pruning engages only when a (task, technique) lane has at
#: least this many valid sizes; below it the anchors are the whole grid.
PRUNE_MIN_GRID = 4


def _default_parallelism(topo: SliceTopology) -> int:
    """Concurrent trials of one size class: 4 where the pool's positions are
    distinct CUDA devices, else 1 (the CPU, and positions that share a card,
    whose trials would time each other)."""
    cuda = all(getattr(d, "type", None) == "cuda" for d in topo.devices)
    return 4 if cuda and not topo.shared else 1


def _anchor_sizes(sizes: Sequence[int]) -> set:
    """The smallest, the largest and one midpoint of the valid sizes: the
    three points an Amdahl fit needs, and the ends of the grid."""
    ss = sorted(sizes)
    return {ss[0], ss[-1], ss[len(ss) // 2]}


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


class _Lane:
    """The sweep state of one (task, technique): which sizes are resolved,
    and how."""

    __slots__ = ("task", "name", "tech", "sizes", "keys", "done", "to_run", "to_fill",
                 "infeasible_floor")

    def __init__(self, task, name, tech, sizes):
        self.task, self.name, self.tech = task, name, tech
        self.sizes = sorted(sizes)
        self.keys: Dict[int, Optional[str]] = {}
        # size -> (feasible, params, per_batch_time, source)
        self.done: Dict[int, tuple] = {}
        self.to_run: List[int] = []
        self.to_fill: List[int] = []
        # the largest size found memory-infeasible: every smaller one needs
        # at least as much per device and is pruned without a trial
        self.infeasible_floor: Optional[int] = None

    def pruned(self, g: int) -> bool:
        return self.infeasible_floor is not None and g < self.infeasible_floor


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
    counts the planned trials the memory floor skipped, ``fused_groups``
    the fusion groups whose stacked step was measured; the interpolated
    sizes are logged and reported as ``trial_interpolated`` events).

    ``technique_names=None`` uses the whole library (registering the default
    library if nothing is registered). ``profile_cache``: ``None`` uses the
    environment's persistent cache (on by default;
    ``SATURN_TPU_PROFILE_CACHE=0`` disables it), ``False`` turns caching off
    for this sweep, a path uses that directory. A cache hit costs no trial.
    ``prune`` toggles anchor-size pruning and the memory floor.
    ``parallel_trials`` caps the trials of one size that run at once on
    disjoint blocks (default ``_default_parallelism``). ``metrics_path``
    appends JSONL events (``trial``, ``profile_cache``, ``trial_retry``,
    ``trial_pruned``, ``trial_interpolated``). ``trace_dir`` records the
    sweep in a torch.profiler trace there (``utils/trace.py``).
    ``compile_cache_dir`` keeps the port's compiled kernels and native
    libraries in that directory for this process and any later one pointed
    at it (``utils/compile_cache.py``, the same as
    ``SATURN_TPU_COMPILE_CACHE_DIR``). A technique whose ``search`` raises
    is retried ``trial_retries`` times with exponential backoff; the last
    failure propagates to the caller (a config that runs out of device
    memory is infeasible, not a failure). ``fusion=False`` measures no
    fusion group (the JAX package always does; the port's option keeps a
    sweep solo).
    """
    if log:
        logging.basicConfig(level=logging.INFO)
    if compile_cache_dir:
        compile_cache.enable(compile_cache_dir)
    topo = topology if topology is not None else SliceTopology()
    cache = pcache.resolve(profile_cache)
    with metrics.scoped(metrics_path), trace.profile_trace(trace_dir):
        return _search_inner(tasks, technique_names, topo, cache, trial_retries,
                             retry_backoff_s, fusion, parallel_trials, prune)


def _search_inner(tasks, technique_names, topo, cache, trial_retries,
                  retry_backoff_s, fusion=True, parallel_trials=None,
                  prune=True) -> Dict[str, int]:
    if technique_names is None and not lib.registered_names():
        lib.register_default_library()
    classes = lib.retrieve(technique_names)
    if not isinstance(classes, list):
        classes = [classes]
    techniques = [(getattr(cls, "name", cls.__name__), cls()) for cls in classes]
    # ``is not None``: an empty ProfileCache is falsy (it has a __len__)
    topo_sig = pcache.topology_signature(topo) if cache is not None else ""
    runtime = pcache.runtime_signature() if cache is not None else None
    lock = threading.Lock()

    lanes: List[_Lane] = []
    for task in tasks:
        sizes = topo.valid_sizes()
        if task.chip_range is not None:
            sizes = [s for s in sizes if s in task.chip_range]
        task_sig = pcache.task_signature(task) if cache is not None else None
        for name, tech in techniques:
            lane = _Lane(task, name, tech, sizes)
            if task_sig is not None:
                for g in lane.sizes:
                    lane.keys[g] = pcache.fingerprint(task_sig, name, g, topo_sig, runtime)
            lanes.append(lane)

    def install(lane: _Lane, g: int, params, per_batch: float, source: str,
                host_fraction: float = 0.0, peak_bytes=None) -> None:
        """The fastest feasible technique per size wins: measured, cached
        and interpolated entries all compete. An interpolated entry has no
        measured host fraction (0.0: never co-scheduled on a guess)."""
        task = lane.task
        total = per_batch * task.total_batches
        key = lane.keys.get(g)
        with lock:
            lane.done[g] = (True, params, per_batch, source)
            cur = task.strategies.get(g)
            if cur is None or not cur.feasible or total < cur.runtime:
                task.strategies[g] = Strategy(
                    executor=lane.tech, apportionment=g, params=params,
                    runtime=total, per_batch_time=per_batch,
                    interpolated=source == "interpolated", cache_key=key,
                    cache_dir=cache.root if key is not None else None,
                    host_fraction=float(host_fraction or 0.0), peak_bytes=peak_bytes,
                )

    monotone_pool = not topo.shared

    def note_memory_floor(lane: _Lane, g: int) -> None:
        if prune and monotone_pool and getattr(lane.tech, "memory_monotone", False):
            with lock:
                if lane.infeasible_floor is None or g > lane.infeasible_floor:
                    lane.infeasible_floor = g

    counts = {"trials": 0, "hits": 0, "pruned": 0}

    def hit(lane: _Lane, g: int) -> bool:
        """Resolve (lane, g) from the cache; whether it was there."""
        key = lane.keys.get(g)
        entry = cache.get(key) if key is not None else None
        if entry is None:
            return False
        with lock:
            counts["hits"] += 1
        task, name = lane.task, lane.name
        metrics.event("profile_cache", hit=True, task=task.name, size=g, technique=name,
                      feasible=entry["feasible"], source=entry.get("source", "trial"))
        logger.info("trial (%s, g=%d, %s): profile-cache hit (%s)", task.name, g, name,
                    entry.get("source", "trial"))
        if entry["feasible"]:
            install(lane, g, entry["params"], entry["per_batch_time"], "cache",
                    entry.get("host_fraction", 0.0), entry.get("peak_bytes"))
        else:
            with lock:
                lane.done[g] = (False, None, None, entry.get("source", "trial"))
            if entry.get("memory_infeasible"):
                note_memory_floor(lane, g)
        return True

    # ------------------------------------------------------------ cache pass
    for lane in lanes:
        for g in lane.sizes:
            hit(lane, g)

    # -------------------------------------------------------- pruning split
    for lane in lanes:
        missing = [g for g in lane.sizes if g not in lane.done]
        if prune and len(lane.sizes) >= PRUNE_MIN_GRID:
            anchors = _anchor_sizes(lane.sizes)
            lane.to_run = [g for g in missing if g in anchors]
            lane.to_fill = [g for g in missing if g not in anchors]
        else:
            lane.to_run = missing

    def run_trial(tid: int, lane: _Lane, g: int, block) -> None:
        task, name, tech = lane.task, lane.name, lane.tech
        # a lane of the same signature may have cached this point in this sweep
        if hit(lane, g):
            return
        if cache is not None:
            metrics.event("profile_cache", hit=False, task=task.name, size=g,
                          technique=name)
        devices = block.devices_of(topo.devices)
        with lock:
            counts["trials"] += 1
        t0 = timeit.default_timer()
        params = per_batch = None
        for attempt in range(max(0, trial_retries) + 1):
            try:
                params, per_batch = tech.search(task, devices, tid)
                break
            except Exception as e:
                if attempt >= trial_retries:
                    raise
                delay = retry_backoff_s * (2 ** attempt)
                delay *= 1.0 + random.Random(f"{task.name}:{g}:{name}:{attempt}").random()
                metrics.event("trial_retry", task=task.name, size=g, technique=name,
                              attempt=attempt + 1, backoff_s=round(delay, 6), error=repr(e))
                logger.warning("trial (%s, g=%d, %s) raised on attempt %d: %r",
                               task.name, g, name, attempt + 1, e)
                time.sleep(delay)
        dt = timeit.default_timer() - t0
        key = lane.keys.get(g)
        if params is None or per_batch is None:
            # the technique's verdict (an SPMD technique's ``search_report``);
            # a technique that reports none is memory-bound on one device
            reporter = getattr(tech, "search_report", None)
            report = reporter(task.name, g) if reporter else None
            memory = (bool(report.get("memory_infeasible")) if report is not None
                      else len(devices) == 1)
            logger.info("trial (%s, g=%d, %s): infeasible%s", task.name, g, name,
                        " (memory)" if memory else "")
            metrics.event("trial", task=task.name, size=g, technique=name,
                          feasible=False, memory_infeasible=memory)
            with lock:
                lane.done[g] = (False, None, None, "trial")
            if memory:
                note_memory_floor(lane, g)
            if key is not None:
                cache.put(key, technique=name, size=g, feasible=False,
                          memory_infeasible=memory)
            return
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
        if key is not None:
            cache.put(key, technique=name, size=g, feasible=True, params=params,
                      per_batch_time=per_batch, host_fraction=hf, peak_bytes=peak)
        install(lane, g, params, per_batch, "trial", hf, peak)

    def prune_point(lane: _Lane, g: int, reason: str, planned: bool) -> None:
        with lock:
            counts["pruned"] += int(planned)  # a planned trial that will not run
            lane.done[g] = (False, None, None, "pruned")
        metrics.event("trial_pruned", task=lane.task.name, size=g, technique=lane.name,
                      reason=reason)
        logger.info("trial (%s, g=%d, %s): pruned (%s)", lane.task.name, g, lane.name,
                    reason)

    # ------------------------------------------------------------ trial pass
    # size classes largest first, a barrier between them: a memory verdict
    # at size g prunes the smaller sizes before they run
    workers = parallel_trials if parallel_trials is not None else _default_parallelism(topo)
    tids = iter(range(1, 1 << 30))
    for g in sorted({g for lane in lanes for g in lane.to_run}, reverse=True):
        items: List[_Lane] = []
        for lane in lanes:
            if g not in lane.to_run:
                continue
            if lane.pruned(g):
                prune_point(lane, g, "memory_monotone", planned=True)
            else:
                items.append(lane)
        if not items:
            continue
        blocks = topo.blocks(g)
        n_workers = min(max(1, int(workers)), len(blocks), len(items))
        if n_workers <= 1:
            for lane in items:
                run_trial(next(tids), lane, g, blocks[0])
            continue
        # concurrent trials of one size on disjoint blocks, each holding a
        # block from a free list while it runs
        free: queue.Queue = queue.Queue()
        for b in blocks[:n_workers]:
            free.put(b)
        with lock:
            item_tids = [next(tids) for _ in items]

        def with_block(lane, tid):
            block = free.get()
            try:
                run_trial(tid, lane, g, block)
            finally:
                free.put(block)

        with ThreadPoolExecutor(max_workers=n_workers,
                                thread_name_prefix=f"trial-g{g}") as pool:
            futures = [pool.submit(with_block, lane, tid)
                       for lane, tid in zip(items, item_tids)]
            for f in futures:
                f.result()

    # ------------------------------------------------------- cost-model fill
    # the lane's other sizes from the Amdahl fit over its measured feasible
    # points; below a memory floor they stay infeasible, and feasibility is
    # trusted only from the smallest measured feasible size up
    n_interp = 0
    for lane in lanes:
        if not lane.to_fill:
            continue
        pts = [(g, pbt) for g, (feasible, _p, pbt, source) in lane.done.items()
               if feasible and source != "interpolated"]
        model = _fit_scaling_model(pts) if len(pts) >= 2 else None
        for g in lane.to_fill:
            if lane.pruned(g):
                prune_point(lane, g, "memory_monotone", planned=False)
                continue
            if model is None or g < min(p[0] for p in pts):
                continue
            per_batch = max(float(model(g)), 1e-9)
            nearest = min(pts, key=lambda p: abs(p[0] - g))[0]
            params = dict(lane.done[nearest][1] or {})
            install(lane, g, params, per_batch, "interpolated")
            n_interp += 1
            metrics.event("trial_interpolated", task=lane.task.name, size=g,
                          technique=lane.name, per_batch_s=per_batch, anchor_size=nearest)
            logger.info("trial (%s, g=%d, %s): %.4fs/batch from the fit (anchor size %d)",
                        lane.task.name, g, lane.name, per_batch, nearest)

    trials, hits = counts["trials"], counts["hits"]
    if trials or hits:
        logger.info("trial runner: sweep complete — %d trials run, %d cache hits, %d pruned, "
                    "%d interpolated", trials, hits, counts["pruned"], n_interp)
    for task in tasks:
        for g in topo.valid_sizes():
            if g not in task.strategies:
                task.strategies[g] = Strategy(None, g, None, DUMMY_RUNTIME)
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
    return {"trials_run": trials, "cache_hits": hits, "pruned": counts["pruned"],
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
