"""Virtual time for the twin: one clock and one deterministic event queue.

Counterpart of ``saturn_tpu/twin/clock.py``. The real control-plane code
runs unmodified against simulated time: while :meth:`VirtualClock.patch` is
active, ``time.time()``, ``time.monotonic()`` and ``timeit.default_timer()``
read the virtual clock anywhere in the process, and ``time.sleep()``
advances it instead of blocking. Queue timestamps, deadline slack, the
gateway's backpressure cooldown, journal ``ts`` fields and metrics
timestamps all live on the simulated axis and repeat from a seed.

``time.perf_counter`` is left alone on purpose: the anytime solver races
its tier ladder against real CPU time, and that race (a deadline miss
included) is what the twin must measure rather than simulate away. The
solver's wall time is the one real quantity a campaign reports.

Single-threaded by contract: the campaign loop owns the process while the
patch is active (patching module attributes is process-wide), so no live
service and no engine launcher thread may run beside it. The runner never
starts the gateway and drives every step inline.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import time
import timeit
from typing import Any, Iterator, List, Optional, Tuple


class VirtualClock:
    """A monotonic simulated clock, in seconds from ``start``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self, *_args) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance the clock by {dt}s")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        """Jump forward to the absolute time ``t`` (nothing if already past)."""
        if t > self._now:
            self._now = float(t)
        return self._now

    def sleep(self, dt: float) -> None:
        """``time.sleep`` inside the patch: advances instead of blocking (a
        negative duration clamps to zero, as the real one does)."""
        self.advance(max(0.0, float(dt)))

    @contextlib.contextmanager
    def patch(self) -> Iterator["VirtualClock"]:
        """Swap ``time.time`` / ``time.monotonic`` / ``time.sleep`` and
        ``timeit.default_timer`` for this clock, and restore them on exit.
        ``time.perf_counter`` stays real (module docstring)."""
        saved = (time.time, time.monotonic, time.sleep, timeit.default_timer)
        time.time = self.now
        time.monotonic = self.now
        time.sleep = self.sleep
        timeit.default_timer = self.now
        try:
            yield self
        finally:
            (time.time, time.monotonic, time.sleep, timeit.default_timer) = saved


class EventQueue:
    """A deterministic time-ordered event queue.

    Ties on the timestamp break by insertion order (a monotone counter), so
    two runs that push the same events in the same order pop them in the
    same order."""

    def __init__(self):
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._counter = itertools.count()

    def push(self, at: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._heap, (float(at), next(self._counter), kind, payload))

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_due(self, now: float) -> List[Tuple[float, str, Any]]:
        """Pop every event with a timestamp <= ``now``, in order."""
        out: List[Tuple[float, str, Any]] = []
        while self._heap and self._heap[0][0] <= now:
            at, _n, kind, payload = heapq.heappop(self._heap)
            out.append((at, kind, payload))
        return out

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def empty(self) -> bool:
        return not self._heap
