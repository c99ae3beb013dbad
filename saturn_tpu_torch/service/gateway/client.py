"""Retrying gateway client with the :class:`ServiceClient` surface.

Counterpart of ``saturn_tpu/service/gateway/client.py``. ``GatewayClient``
speaks the frame protocol to a
:class:`~saturn_tpu_torch.service.gateway.server.GatewayServer` and hides
a hostile wire from its caller:

- **Backoff with seeded jitter.** A transport failure or a retriable
  refusal sleeps ``min(cap, base * 2**attempt)`` (at least the server's
  ``retry_after_s``) times a jitter drawn from a seeded ``random.Random``:
  two clients with one seed retry on one schedule.
- **Reconnects resume the session.** The client keeps one ``session``
  id and says ``hello`` after each connect, so the per-session window
  survives a dead connection. Replica endpoints are tried in rotation.
- **Idempotent submits.** A submit mints its ``dedup_key`` before the
  first attempt and sends it with every retry: a retry whose first
  acknowledgement was lost gets the original job id.
- **rid correlation.** Responses are matched by their echoed ``rid``; a
  stray (a duplicated or reordered frame) is dropped.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from saturn_tpu_torch.service.gateway import protocol
from saturn_tpu_torch.service.gateway.protocol import GatewayError

_TERMINAL_STATES = ("DONE", "FAILED", "EVICTED")


class GatewayClient:
    """submit / status / wait / cancel against a gateway over TCP."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        session: Optional[str] = None,
        seed: int = 0,
        timeout_s: float = 10.0,
        max_attempts: int = 8,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        endpoints: Optional[Sequence[Tuple[str, int]]] = None,
    ):
        self.host = host
        self.port = port
        #: replica endpoints in rotation, ``(host, port)`` first: a
        #: transport failure or a retriable refusal moves to the next
        #: before the retry (the same frame and dedup key)
        self.endpoints: List[Tuple[str, int]] = [(host, port)]
        for ep in endpoints or ():
            pair = (ep[0], int(ep[1]))
            if pair not in self.endpoints:
                self.endpoints.append(pair)
        self._ep_idx = 0
        self.session = session or f"gwc-{seed}-{id(self) & 0xFFFF:04x}"
        self.timeout_s = timeout_s
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = random.Random(seed)  # the jitter and the dedup keys
        self._rid = 0
        self._dedup_seq = 0
        self._sock: Optional[socket.socket] = None
        self._reader = None
        self.reconnects = 0
        self.retries = 0

    # ------------------------------------------------------------- transport
    def _rotate_endpoint(self) -> None:
        if len(self.endpoints) > 1:
            self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)

    def _connect(self) -> None:
        self.close()
        # every endpoint once, from the current one: a dead replica costs
        # one connect attempt, not the call
        last: Optional[BaseException] = None
        sock = None
        for i in range(len(self.endpoints)):
            host, port = self.endpoints[(self._ep_idx + i) % len(self.endpoints)]
            try:
                sock = socket.create_connection((host, port), timeout=self.timeout_s)
                self._ep_idx = (self._ep_idx + i) % len(self.endpoints)
                break
            except OSError as e:
                last = e
        if sock is None:
            raise ConnectionError(f"no gateway replica reachable across "
                                  f"{len(self.endpoints)} endpoint(s): {last}")
        self._sock = sock
        self._reader = sock.makefile("rb")
        # resume the session before any request
        rid = self._next_rid()
        self._write({"op": "hello", "rid": rid, "session": self.session})
        self._read_response(rid)
        self.reconnects += 1

    def close(self) -> None:
        for attr in ("_reader", "_sock"):
            handle = getattr(self, attr)
            if handle is not None:
                try:
                    handle.close()
                except OSError:
                    pass
                setattr(self, attr, None)

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _next_rid(self) -> str:
        self._rid += 1
        return f"{self.session}:r{self._rid}"

    def _write(self, frame: Dict[str, Any]) -> None:
        self._sock.sendall(protocol.encode_frame(frame))

    def _read_response(self, rid: str) -> Dict[str, Any]:
        """Read frames until the one answering ``rid``; every other frame
        (an old duplicate, a reordered earlier answer, a torn line) is a
        stray and dropped."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(f"no response to {rid}")
            self._sock.settimeout(remaining)
            line = self._reader.readline(protocol.MAX_FRAME_BYTES + 1)
            if not line:
                raise ConnectionError("gateway closed the connection")
            try:
                frame = protocol.decode_frame(line)
            except GatewayError:
                continue
            if frame.get("rid") != rid:
                continue
            if frame.get("ok"):
                result = frame.get("result")
                return result if isinstance(result, dict) else {}
            raise GatewayError.from_wire(frame.get("error"))

    def _backoff(self, attempt: int, hint: Optional[float]) -> float:
        base = min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))
        if hint is not None:
            base = max(base, float(hint))
        return base * (0.5 + self._rng.random())

    def _call(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """One request with reconnects and retries: the same frame (and
        dedup key) every attempt, a fresh rid."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                if self._sock is None:
                    self._connect()
                rid = self._next_rid()
                self._write(dict(frame, rid=rid, session=self.session))
                return self._read_response(rid)
            except GatewayError as e:
                if not e.retriable:
                    raise
                last = e
                hint = e.retry_after_s
                if len(self.endpoints) > 1:
                    # this replica drains, is not the leaseholder or was
                    # fenced: try a peer
                    self.close()
                    self._rotate_endpoint()
            except (OSError, ConnectionError) as e:
                # the transport died: the next attempt reconnects (to a peer
                # where there is one) and resumes the session
                self.close()
                self._rotate_endpoint()
                last = e
                hint = None
            self.retries += 1
            time.sleep(self._backoff(attempt, hint))
        raise GatewayError(protocol.GW_UNAVAILABLE,
                           f"gateway unreachable after {self.max_attempts} attempts: "
                           f"{type(last).__name__}: {last}")

    # -------------------------------------------------------------- surface
    def submit(self, task=None, priority: float = 0.0, deadline_s: Optional[float] = None,
               max_retries: int = 1, spec: Optional[dict] = None, *,
               name: Optional[str] = None, total_batches: Optional[int] = None,
               request_deadline_s: Optional[float] = None, dedup_key: Optional[str] = None,
               tenant: Optional[str] = None) -> str:
        """Enqueue a job; returns its id (the original id on a retry).

        Takes a task (its ``name`` and ``total_batches`` cross the wire and
        the server's ``task_provider`` builds the task) or ``name=`` and
        ``total_batches=``. ``deadline_s`` is the job's deadline (the
        pressure shedder's), ``request_deadline_s`` bounds this submit's
        time in the gateway before admission; ``tenant`` names the billing
        and fairness principal (None: the default tenant)."""
        if task is not None:
            name = getattr(task, "name", None)
            if total_batches is None:
                total_batches = getattr(task, "total_batches", None)
        if not name:
            raise GatewayError(protocol.GW_BADREQUEST, "submit needs a task or a name=")
        if dedup_key is None:
            # unique per submit even for two clients resuming one session:
            # the counter and a seeded draw
            self._dedup_seq += 1
            dedup_key = f"{self.session}:d{self._dedup_seq}-{self._rng.randrange(1 << 30):08x}"
        frame: Dict[str, Any] = {
            "op": "submit",
            "dedup_key": dedup_key,
            "job": {"name": name, "total_batches": int(total_batches or 0),
                    "priority": priority, "deadline_s": deadline_s,
                    "max_retries": max_retries, "spec": spec, "tenant": tenant},
        }
        if request_deadline_s is not None:
            frame["deadline_s"] = request_deadline_s
        return str(self._call(frame)["job_id"])

    def status(self, job_id: str) -> dict:
        """The job's lifecycle record now."""
        return self._call({"op": "status", "job": job_id})

    def wait(self, job_id: str, timeout: Optional[float] = None) -> dict:
        """Block until the job is DONE, FAILED or EVICTED; ``TimeoutError``
        after ``timeout``. The wait goes in server-side chunks of half the
        transport timeout, so a quiet wait never looks like a dead wire."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            remaining = deadline - time.monotonic() if deadline is not None else None
            if remaining is not None and remaining <= 0:
                raise TimeoutError(f"job {job_id} not terminal after {timeout}s")
            chunk = max(0.1, self.timeout_s * 0.5)
            if remaining is not None:
                chunk = min(chunk, remaining)
            snap = self._call({"op": "wait", "job": job_id, "timeout_s": chunk})
            if snap.get("terminal") or snap.get("state") in _TERMINAL_STATES:
                snap.pop("terminal", None)
                return snap

    def cancel(self, job_id: str) -> bool:
        """Ask for the job's eviction; False if it is terminal already."""
        return bool(self._call({"op": "cancel", "job": job_id})["cancelled"])

    def ping(self) -> dict:
        return self._call({"op": "ping"})
