"""Kernel launch counts that stay exact under CUDA graph capture.

Each kernel wrapper (``ops/flash.py``, ``ops/ce.py``) counts its launches
in its module's ``LAUNCHES``. A launch into a stream that is being captured
into a CUDA graph runs nothing: it is recorded for the graph instead, and
every replay of the graph (``parallel/spmd_base.py``) adds what was recorded,
since that is where those kernels run.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

#: capture stream handle -> the (counts, name) of each launch captured there
_RECORDERS: Dict[int, List[Tuple[Dict[str, int], str]]] = {}
_LOCK = threading.Lock()


def count(counts: Dict[str, int], name: str, stream: int) -> None:
    """One launch of ``name`` into ``stream`` (a ``cudaStream_t`` handle)."""
    with _LOCK:
        rec = _RECORDERS.get(stream)
        if rec is not None:
            rec.append((counts, name))
        else:
            counts[name] += 1


@contextmanager
def recording(stream: int):
    """Record, instead of count, the launches into ``stream`` while the
    block runs; yields the list they are recorded in."""
    rec: List[Tuple[Dict[str, int], str]] = []
    with _LOCK:
        _RECORDERS[stream] = rec
    try:
        yield rec
    finally:
        with _LOCK:
            del _RECORDERS[stream]


def replay(recorded: List[Tuple[Dict[str, int], str]]) -> None:
    """Count the launches of one replay of a graph that recorded these."""
    with _LOCK:
        for counts, name in recorded:
            counts[name] += 1
