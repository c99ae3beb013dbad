"""Structured metrics: append-only JSONL event stream.

A copy of ``saturn_tpu/utils/metrics.py``: every subsystem emits typed
events (trials, profile-cache hits, solves and solver tiers, task failures,
retries and completions, plan quarantines, the health guardian's
transitions) to one JSONL file, with the JAX package's event kinds and
field names, so either package's ``read_events`` reads the other's file.

Disabled unless configured — ``search(metrics_path=...)`` /
``orchestrate(metrics_path=...)`` or :func:`configure` directly.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger("saturn_tpu_torch")


class MetricsWriter:
    """Thread-safe JSONL appender (the engine launches tasks from threads).

    Events are buffered in memory and written in batches — size-bounded
    (``max_buffered`` events) and time-bounded (``max_latency_s`` since the
    oldest unwritten event) — so emission stays off the step critical path.
    Callers append under the lock; the engine and the orchestrator call
    :func:`flush` at interval boundaries, and ``close()`` always drains.

    Each drain is a single ``write()`` of whole ``\\n``-terminated lines,
    so a crash can tear at most the last line in flight — what
    ``read_events`` skips and warns on. A crash between
    flushes drops the buffered events: metrics are not a ledger.
    """

    def __init__(self, path: str, max_buffered: int = 256,
                 max_latency_s: float = 2.0):
        self.path = path
        self.max_buffered = max(1, int(max_buffered))
        self.max_latency_s = float(max_latency_s)
        self._lock = threading.Lock()
        self._fh = open(path, "a")
        self._buf: list = []
        self._oldest: Optional[float] = None  # monotonic ts of _buf[0]

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        now = time.monotonic()
        with self._lock:
            if self._fh.closed:
                # The module-level event() reads _WRITER without _CONF_LOCK,
                # so a racing configure()/scoped() may close this writer
                # between the read and this call. Dropping the event is fine;
                # raising inside an engine launcher thread would record a
                # spurious task failure.
                return
            self._buf.append(line)
            if self._oldest is None:
                self._oldest = now
            if (len(self._buf) >= self.max_buffered
                    or now - self._oldest >= self.max_latency_s):
                self._drain_locked()

    def _drain_locked(self) -> None:
        if not self._buf or self._fh.closed:
            self._buf = []
            self._oldest = None
            return
        data = "\n".join(self._buf) + "\n"
        self._buf = []
        self._oldest = None
        try:
            self._fh.write(data)
            self._fh.flush()
        except (OSError, ValueError):
            pass

    def flush(self) -> None:
        """Write out everything buffered (interval-boundary durability for
        post-run ``read_events``)."""
        with self._lock:
            self._drain_locked()

    def close(self) -> None:
        """Drain, then close the stream, fsyncing first: ``configure``/
        ``scoped`` rotate sinks by closing the old writer, so rotation is a
        durability point — a crash right after must not lose the rotated-out
        events to the page cache."""
        with self._lock:
            self._drain_locked()
            if not self._fh.closed:
                try:
                    self._fh.flush()
                    # fsync under the lock keeps late event() callers from
                    # interleaving appends into a half-synced stream
                    os.fsync(self._fh.fileno())
                except (OSError, ValueError):
                    pass
            self._fh.close()


_WRITER: Optional[MetricsWriter] = None
_CONF_LOCK = threading.Lock()


def configure(path: Optional[str]) -> None:
    """Point the global metrics stream at ``path`` (None disables)."""
    global _WRITER
    with _CONF_LOCK:
        if _WRITER is not None:
            _WRITER.close()
        _WRITER = MetricsWriter(path) if path else None


def event(kind: str, **fields) -> None:
    """Emit an event if metrics are configured; no-op otherwise."""
    # Invariant: _WRITER swaps are atomic (one assignment under _CONF_LOCK)
    # and a stale writer is drained-then-closed, where event() degrades to
    # a documented drop (see MetricsWriter.event) — taking _CONF_LOCK here
    # would put a mutex acquisition on every hot-path emission.
    w = _WRITER
    if w is not None:
        w.event(kind, **fields)


def flush() -> None:
    """Drain the configured writer's buffer to disk; no-op when metrics are
    off. Called at interval boundaries (engine, orchestrator)
    so telemetry lands off the step critical path but before the next
    interval's work starts."""
    w = _WRITER
    if w is not None:
        w.flush()


def read_events(path: str, kind: Optional[str] = None) -> list:
    """Read a JSONL metrics file back as dicts, optionally filtered by
    ``kind`` — the test/analysis counterpart to :func:`event`. Lines that
    fail to parse (a crashed writer's torn tail) are skipped with a
    WARNING — losing the last in-flight event to a crash is expected,
    losing it *silently* is not."""
    out = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                logger.warning(
                    "metrics: skipping torn/corrupt line %d of %s "
                    "(%d bytes) — a crashed writer's unflushed tail",
                    lineno, path, len(line),
                )
                continue
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out


def tail_events(path: str, kind: Optional[str] = None, poll_s: float = 0.2, stop=None,
                follow: bool = True):
    """Generator over a live JSONL metrics stream (``tail -f``): the events
    from the start of the file, then every appended one, polling every
    ``poll_s`` until ``stop`` (a ``threading.Event``) is set, or up to the
    end of the file with ``follow=False``. A partial last line (the writer
    mid-append) is held back until its newline lands; a torn line in the
    middle (a crashed writer's tail that a restarted one appended past) is
    skipped with a warning. The service's CLI reads it."""
    buf = ""
    with open(path) as fh:
        while True:
            chunk = fh.read(65536)
            if chunk:
                buf += chunk
                while "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        logger.warning("metrics: skipping torn/corrupt line in %s (%d bytes)",
                                       path, len(line))
                        continue
                    if kind is None or rec.get("kind") == kind:
                        yield rec
                continue
            if not follow or (stop is not None and stop.is_set()):
                return
            time.sleep(poll_s)


@contextlib.contextmanager
def scoped(path: Optional[str]):
    """Route events to ``path`` for the enclosed region, then restore the
    previous sink and close the file — so ``orchestrate(metrics_path=...)``
    cannot leak its writer into later runs."""
    global _WRITER
    if not path:
        yield
        return
    mine = MetricsWriter(path)
    with _CONF_LOCK:
        prev = _WRITER
        _WRITER = mine
    try:
        yield
    finally:
        with _CONF_LOCK:
            # A configure() call inside the region may have replaced (and
            # closed) our writer — only close/restore what is still ours.
            if _WRITER is mine:
                _WRITER = prev
        mine.close()
