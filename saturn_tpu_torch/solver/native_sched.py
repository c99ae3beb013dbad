"""ctypes binding for the native SPASE scheduler (``native/spase.cpp``).

Counterpart of ``saturn_tpu/solver/native_sched.py``: the same option set
the MILP enumerates (feasible strategies x aligned blocks) goes to the C++
list scheduler with local search, and its answer comes back as the same
``Plan``. The plan is validated here: one whose tasks overlap on a device
or leave the pool is rejected (``None``), and the caller takes the greedy
plan instead, so a native bug can never produce an unsound schedule. Unlike
the JAX package, a library that does not build or load raises
(``native.load``).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Dict, List, Tuple

from saturn_tpu_torch import native
from saturn_tpu_torch.core.mesh import Block, SliceTopology

log = logging.getLogger("saturn_tpu_torch")

_FN = None
_FN_LOCK = threading.Lock()


def _fn():
    """The typed ``spase_solve_v2`` symbol, resolved once."""
    global _FN
    with _FN_LOCK:
        if _FN is None:
            f = native.load("spase").spase_solve_v2
            ip = ctypes.POINTER(ctypes.c_int)
            dp = ctypes.POINTER(ctypes.c_double)
            f.argtypes = [
                ctypes.c_int, ip, ip, ip, dp,
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_uint64, ip, ip, dp, dp,
            ]
            f.restype = ctypes.c_int
            _FN = f
        return _FN


def solve_native(
    task_list: List,
    topology: SliceTopology,
    time_limit: float = 1.0,
    ordering_slack: float = 1.0,
    seed: int = 0,
    warm=None,
):
    """Schedule through libspase; returns a ``Plan``, or None when the
    native plan fails validation.

    ``warm`` (a previous ``Plan``) seeds the native search with each task's
    previous (size, block) choice. ``time_limit=0`` returns the
    constructor's plan (longest first, min-finish slot), the better of the
    cold and the warm one."""
    from saturn_tpu_torch.solver.milp import Assignment, Plan

    counts, offs, sizes, rts = [], [], [], []
    per_task: List[List[Tuple[int, Block, float]]] = []
    for t in task_list:
        opts = []
        for size, strat in sorted(t.feasible_strategies().items()):
            if size > topology.capacity:
                continue
            for blk in topology.blocks(size):
                opts.append((size, blk, strat.runtime))
        if not opts:
            raise ValueError(
                f"task {t.name}: no strategy fits topology capacity {topology.capacity}"
            )
        per_task.append(opts)
        counts.append(len(opts))
        for s, b, rt in opts:
            offs.append(b.offset)
            sizes.append(s)
            rts.append(rt)

    n = len(task_list)
    c_counts = (ctypes.c_int * n)(*counts)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    c_sizes = (ctypes.c_int * len(sizes))(*sizes)
    c_rts = (ctypes.c_double * len(rts))(*rts)
    c_chosen = (ctypes.c_int * n)()
    c_starts = (ctypes.c_double * n)()
    c_mk = ctypes.c_double()

    c_warm = None
    if warm is not None:
        widx = [-1] * n
        for i, t in enumerate(task_list):
            a = warm.assignments.get(t.name)
            if a is None:
                continue
            for oi, (s, b, _) in enumerate(per_task[i]):
                if s == a.apportionment and b.offset == a.block.offset:
                    widx[i] = oi
                    break
        if any(w >= 0 for w in widx):
            c_warm = (ctypes.c_int * n)(*widx)

    rc = _fn()(
        n, c_counts, c_offs, c_sizes, c_rts, topology.capacity,
        float(time_limit), float(ordering_slack), seed,
        c_warm, c_chosen, c_starts, ctypes.byref(c_mk),
    )
    if rc != 0:
        raise RuntimeError(f"libspase rejected its input (code {rc})")

    assignments: Dict[str, Assignment] = {}
    for i, t in enumerate(task_list):
        size, blk, rt = per_task[i][c_chosen[i]]
        assignments[t.name] = Assignment(
            apportionment=size, block=blk, start=float(c_starts[i]), runtime=rt
        )
    plan = Plan(assignments=assignments, makespan=float(c_mk.value))
    if not _valid(plan, topology, ordering_slack):
        log.warning("libspase plan failed validation — taking the greedy plan")
        return None
    plan.compute_dependencies()
    return plan


def _valid(plan, topology: SliceTopology, slack: float) -> bool:
    """Tasks sharing any device must be separated by >= slack (the same
    separation the MILP's ordering constraints enforce)."""
    items = list(plan.assignments.values())
    for i, a in enumerate(items):
        if a.start < -1e-9 or a.block.end > topology.capacity:
            return False
        for b in items[i + 1 :]:
            if not a.block.overlaps(b.block):
                continue
            if (a.start + a.runtime + slack <= b.start + 1e-6) or (
                b.start + b.runtime + slack <= a.start + 1e-6
            ):
                continue
            return False
    return True
