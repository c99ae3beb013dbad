"""Wire chaos: a seeded, frame-aware TCP proxy in front of the gateway.

Counterpart of ``saturn_tpu/resilience/netchaos.py``. ``chaos.py``
attacks the training plane; this module attacks the wire between a
:class:`~saturn_tpu_torch.service.gateway.client.GatewayClient` and its
:class:`~saturn_tpu_torch.service.gateway.server.GatewayServer`. The proxy
listens on a port of its own, pumps bytes both ways, cuts them into JSONL
frames and injects a fault per frame from a seeded RNG: the same spec and
connection order give the same fault sequence, in this package and in
the JAX one.

Fault classes (:data:`NET_FAULT_CLASSES`):

- ``drop``: cut the connection before the frame is forwarded;
- ``delay``: hold the frame ``delay_s``, then forward it;
- ``partial``: forward a strict prefix of the frame, then cut;
- ``dup``: forward the frame twice (a duplicated request must not admit
  twice, a duplicated answer is dropped by ``rid``);
- ``reorder``: hold the frame until after its successor;
- ``kill_ack``: server to client only, swallow the answer and cut. For a
  submit that is the lost acknowledgement: the job is admitted and
  journaled, the client never hears, and only the dedup key makes the
  retry safe.

A cut is a ``shutdown`` of both sockets before their close, so the client
sees its connection end at once. The JAX proxy only closes them, and the
other direction's reader keeps the descriptor open: there the client
learns of the cut at its timeout (``ROADMAP.md``, queue 3).

A campaign through the proxy holds: no job lost, none admitted twice, and
the jobs' journaled trajectories those of an in-process run of the mix.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("saturn_tpu_torch")

#: Every wire-fault class the proxy can inject.
NET_FAULT_CLASSES: Tuple[str, ...] = ("drop", "delay", "partial", "dup", "reorder", "kill_ack")

#: The directions a fault applies to; ``kill_ack`` only to answers.
_C2S = "c2s"
_S2C = "s2c"


@dataclass(frozen=True)
class NetChaosSpec:
    """One seeded wire-chaos configuration: ``fault_rate`` per frame, at
    most ``max_faults_per_conn`` faults a connection (so a campaign ends),
    the first ``skip_frames`` frames of each connection clean (the hello
    exchange)."""

    seed: int
    fault_classes: Tuple[str, ...] = NET_FAULT_CLASSES
    fault_rate: float = 0.25
    delay_s: float = 0.05
    max_faults_per_conn: int = 2
    skip_frames: int = 2


@dataclass
class NetChaosStats:
    """What the proxy did; every pump thread updates it under the lock."""

    connections: int = 0
    frames: int = 0
    injected: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def note(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def note_frame(self) -> None:
        with self._lock:
            self.frames += 1

    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())


class _Pump:
    """One direction of one proxied connection: frames in, a seeded draw
    per frame, frames (or their remains) out."""

    def __init__(self, proxy: "NetChaosProxy", conn_id: int, direction: str,
                 src: socket.socket, dst: socket.socket):
        self.proxy = proxy
        self.direction = direction
        self.src = src
        self.dst = dst
        spec = proxy.spec
        # seeded by (seed, connection ordinal, direction) alone: no clock
        # and no thread interleaving enters the fault sequence
        self.rng = random.Random(f"{spec.seed}:{conn_id}:{direction}")
        self.faults_left = spec.max_faults_per_conn
        self.skip = spec.skip_frames
        self.held: Optional[bytes] = None  # a frame held by ``reorder``
        self.classes = [c for c in spec.fault_classes if c != "kill_ack" or direction == _S2C]

    def run(self) -> None:
        reader = self.src.makefile("rb")
        try:
            while True:
                try:
                    frame = reader.readline()
                except OSError:
                    break
                if not frame or not self._forward(frame):
                    break
            self._flush_held()
        finally:
            try:
                reader.close()
            except OSError:
                pass
            # EOF to both peers at once: the other pump's reader still holds
            # its socket, so a close alone would leave the peer waiting for
            # its timeout; the other pump ends on its own EOF
            for s in (self.src, self.dst):
                for cut in (lambda: s.shutdown(socket.SHUT_RDWR), s.close):
                    try:
                        cut()
                    except OSError:
                        pass

    def _forward(self, frame: bytes) -> bool:
        """Forward one frame, perhaps faulted; False once the connection is
        cut (by a fault or a dead peer)."""
        self.proxy.stats.note_frame()
        fault = self._draw()
        if fault is None:
            return self._send(frame)
        spec = self.proxy.spec
        self.proxy.stats.note(fault)
        logger.info("netchaos: inject %s on %s frame", fault, self.direction)
        if fault in ("drop", "kill_ack"):
            return False
        if fault == "delay":
            time.sleep(spec.delay_s)
            return self._send(frame)
        if fault == "partial":
            cut = max(1, self.rng.randrange(1, max(2, len(frame))))
            try:
                self.dst.sendall(frame[:cut])
            except OSError:
                pass
            return False
        if fault == "dup":
            return self._send(frame) and self._send(frame)
        if fault == "reorder":
            if self.held is None:
                self.held = frame  # released after the next frame
                return True
            return self._send(frame)
        raise AssertionError(f"unknown fault class {fault!r}")

    def _draw(self) -> Optional[str]:
        if self.skip > 0:
            self.skip -= 1
            return None
        if self.faults_left <= 0 or not self.classes:
            return None
        if self.rng.random() >= self.proxy.spec.fault_rate:
            return None
        self.faults_left -= 1
        return self.rng.choice(self.classes)

    def _send(self, frame: bytes) -> bool:
        held, self.held = self.held, None
        try:
            # a held frame goes out after the next one
            self.dst.sendall(frame + held if held is not None else frame)
        except OSError:
            return False
        return True

    def _flush_held(self) -> None:
        if self.held is not None:
            held, self.held = self.held, None
            try:
                self.dst.sendall(held)
            except OSError:
                pass


class NetChaosProxy:
    """Listen on :attr:`address`, forward to ``(upstream_host,
    upstream_port)``, maul frames by ``spec``. A context manager, or
    :meth:`start` / :meth:`stop`; point a ``GatewayClient`` at
    ``proxy.address``."""

    def __init__(self, upstream_host: str, upstream_port: int, spec: NetChaosSpec,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream_host, upstream_port)
        self.spec = spec
        self.host = host
        self.port = port
        self.stats = NetChaosStats()
        self._lock = threading.Lock()
        self._stopped = False
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._socks: List[socket.socket] = []
        self.address: Tuple[str, int] = (host, port)

    def start(self) -> "NetChaosProxy":
        sock = socket.create_server((self.host, self.port))
        sock.settimeout(0.2)
        self._listener = sock
        self.address = sock.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="netchaos-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            socks = list(self._socks)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for t in list(self._threads):
            t.join(5.0)

    def __enter__(self) -> "NetChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    break
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                server = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._lock:
                if self._stopped:
                    for s in (client, server):
                        try:
                            s.close()
                        except OSError:
                            pass
                    break
                conn_id = self.stats.connections
                self.stats.connections += 1
                self._socks += [client, server]
                for direction, src, dst in ((_C2S, client, server), (_S2C, server, client)):
                    pump = _Pump(self, conn_id, direction, src, dst)
                    t = threading.Thread(target=pump.run, name=f"netchaos-{conn_id}-{direction}",
                                         daemon=True)
                    self._threads.append(t)
                    t.start()


def single_fault_spec(seed: int, fault_class: str, **overrides) -> NetChaosSpec:
    """A spec that injects one fault class only (a campaign's seeds x
    classes grid)."""
    if fault_class not in NET_FAULT_CLASSES:
        raise ValueError(f"{fault_class!r} is not a wire-fault class "
                         f"(use one of {NET_FAULT_CLASSES})")
    defaults = dict(fault_rate=0.5, max_faults_per_conn=1)
    defaults.update(overrides)
    return NetChaosSpec(seed=seed, fault_classes=(fault_class,), **defaults)
