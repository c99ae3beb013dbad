"""Threaded JSONL-over-TCP gateway in front of :class:`SaturnService`.

Counterpart of ``saturn_tpu/service/gateway/server.py``. One accept thread
and one reader thread per connection feed the service's
:class:`~saturn_tpu_torch.service.queue.SubmissionQueue`; the gateway owns
what the in-process client never had to:

- **Idempotent submission.** A submit may carry a ``dedup_key``. The key
  rides the ``job_submitted`` record, which the queue's observer commits
  before ``submit`` returns, so a retry whose acknowledgement was lost (a
  dropped connection, a chaos proxy's ``kill_ack``, a dead gateway) gets
  the original job id, across incarnations too: the service's fold hands
  the dedup table back (``SaturnService.recovered_dedup``). Each hit is
  journaled as ``gateway_dedup_hit``.
- **Per-request deadlines.** ``deadline_s`` is the client's budget when
  it sent the frame; expired work is shed before admission, at dispatch
  and again after the wait for the dedup lock.
- **Inflight windows.** A global cap on live jobs, a per-session cap and,
  with a ``TenantLedger`` on the service, a per-tenant one; past one the
  submit is refused with ``GW_RETRY_AFTER`` (``GW_TENANT_OVER_QUOTA``) and
  a ``retry_after_s``. While the service's deadline-pressure shedder has
  evicted recently (``SaturnService.last_pressure_shed``) the global
  window shrinks by ``pressure_window_factor``, or, with tenants, only the
  windows of tenants over their fair share.
- **Graceful drain.** ``shutdown()`` (or SIGTERM through
  :meth:`install_sigterm`) stops accepting, lets the requests in flight
  answer, and journals a ``gateway_drain`` marker with the shed and dedup
  counts.
- **Replicas.** ``GatewayServer(service, replica_of=first, replica_id=...,
  lease=...)``: replicas share the dedup table and an epoch-fenced
  :class:`~saturn_tpu_torch.tenancy.ReplicaLease` over the same journal; a
  deposed replica's late submit is refused with ``GW_STALE_EPOCH`` before
  anything is admitted.

Lock order: the dedup lock, then the connection lock; the dedup lock,
then the queue's, then the journal's; the dedup lock, then the lease's.
No gateway lock is taken under a queue or journal lock. The locks are
plain ``threading.RLock``s: the JAX gateway names them into its
concurrency sanitizer, which the port does not have (``ROADMAP.md``,
queue 3).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from saturn_tpu_torch.resilience.crash import SimulatedKill
from saturn_tpu_torch.service.gateway import protocol
from saturn_tpu_torch.service.gateway.protocol import GatewayError
from saturn_tpu_torch.service.queue import TERMINAL_STATES, JobRequest
from saturn_tpu_torch.tenancy.lease import LeaseHeld
from saturn_tpu_torch.utils import metrics

logger = logging.getLogger("saturn_tpu_torch")

_ACCEPT_POLL_S = 0.2


class _Session:
    """A client's state across reconnects: the job ids it submitted (the
    per-session window)."""

    def __init__(self, sid: str):
        self.sid = sid
        self.jobs: set = set()
        self.connects = 0


class _Conn:
    def __init__(self, cid: int, sock: socket.socket, addr: Any, thread: threading.Thread):
        self.cid = cid
        self.sock = sock
        self.addr = addr
        self.thread = thread


class GatewayServer:
    """The TCP front door of one :class:`SaturnService`.

    The service needs a ``task_provider``: a wire submit carries a JSON job
    and the provider builds its task, with the payload crash recovery
    hands it (``recovery.build_restore_records``). The provider runs in the
    reader thread and must not touch the card. ``port=0`` binds a free
    port; read :attr:`address` after :meth:`start`."""

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_inflight: int = 64,
        max_inflight_per_session: int = 16,
        pressure_window_factor: float = 0.5,
        pressure_cooldown_s: Optional[float] = None,
        retry_after_s: Optional[float] = None,
        wait_chunk_cap_s: float = 5.0,
        replica_id: Optional[str] = None,
        lease=None,
        replica_of: Optional["GatewayServer"] = None,
    ):
        self.service = service
        self.host = host
        self.port = port
        self.max_inflight = max_inflight
        self.max_inflight_per_session = max_inflight_per_session
        self.pressure_window_factor = pressure_window_factor
        self.pressure_cooldown_s = (pressure_cooldown_s if pressure_cooldown_s is not None
                                    else 5.0 * getattr(service, "interval", 1.0))
        self.retry_after_s = (retry_after_s if retry_after_s is not None
                              else getattr(service, "interval", 1.0))
        self.wait_chunk_cap_s = wait_chunk_cap_s

        # the connection lock guards connections, sessions, the drain flag
        # and the shed counts; the dedup lock guards the dedup table and
        # serializes the submit path (look up the key, submit, record the
        # key), so that two retries of one key never both submit
        self._lock = threading.RLock()
        if replica_of is not None:
            # one dedup table and lock, and by default one lease, for the
            # whole replica set
            if replica_of.service is not service:
                raise ValueError("replica_of must front the same SaturnService")
            self._dedup_lock = replica_of._dedup_lock
            self._dedup = replica_of._dedup
            if lease is None:
                lease = replica_of.lease
        else:
            self._dedup_lock = threading.RLock()
            self._dedup = dict(getattr(service, "recovered_dedup", None) or {})
        self._conns: Dict[int, _Conn] = {}
        self._sessions: Dict[str, _Session] = {}
        self._sheds: Dict[str, int] = {}
        self._draining = False
        self._next_conn = 0
        self._dedup_hits = 0
        #: this replica's name in the lease protocol
        self.replica_id = replica_id or f"gw-{id(self):x}"
        #: the ReplicaLease shared with peer replicas (None: one gateway,
        #: no fence)
        self.lease = lease
        if self.lease is not None and self.lease.journal is None:
            self.lease.journal = getattr(service, "journal", None)

        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self.address: Tuple[str, int] = (host, port)
        self.killed = False  # set only by the crash harness's simulated kill
        # set once a drain has journaled its marker: a host draining from a
        # signal handler's thread waits on it before it stops the service
        self._drained = threading.Event()

    # ---------------------------------------------------------------- control
    def start(self) -> "GatewayServer":
        if self._accept_thread is not None:
            raise RuntimeError("gateway already started")
        sock = socket.create_server((self.host, self.port))
        sock.settimeout(_ACCEPT_POLL_S)  # a polled accept ends promptly on a drain
        self._listener = sock
        self.address = sock.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop, name="gw-accept",
                                               daemon=True)
        self._accept_thread.start()
        logger.info("gateway listening on %s:%d", *self.address)
        return self

    def install_sigterm(self) -> bool:
        """Drain this gateway on SIGTERM (from a thread of its own). False
        where no handler can be installed (not the main thread)."""
        import signal

        def _on_term(signum, frame):
            threading.Thread(target=self.shutdown, kwargs={"reason": "SIGTERM"},
                             name="gw-sigterm", daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError, AttributeError):
            return False
        return True

    def shutdown(self, timeout: float = 10.0, reason: str = "shutdown") -> bool:
        """Graceful drain: stop accepting, let the readers answer what they
        hold, journal ``gateway_drain``. True when every reader ended
        inside ``timeout``."""
        with self._lock:
            already = self._draining
            self._draining = True
            conns = list(self._conns.values())
        if already:
            # the first caller drains; the others return once its marker is
            # durable
            self._drained.wait(timeout)
            return True
        listener = self._listener
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout)
        # close each connection's read side: no new request arrives, the one
        # a reader holds still gets its answer
        for c in conns:
            try:
                c.sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        clean = True
        for c in conns:
            c.thread.join(max(0.0, deadline - time.monotonic()))
            if c.thread.is_alive():
                clean = False
        with self._lock:
            sheds = dict(self._sheds)
            sessions = len(self._sessions)
        with self._dedup_lock:
            dedup_entries = len(self._dedup)
            dedup_hits = self._dedup_hits
        if self.lease is not None:
            # a clean handoff: a peer takes over without waiting out the ttl
            # (``_die`` does neither: a killed replica cannot)
            self.lease.mark_dead(self.replica_id)
            self.lease.release(self.replica_id)
        jnl = self.service.journal
        if jnl is not None:
            jnl.log("gateway_drain", reason=reason, clean=clean, sessions=sessions,
                    dedup_entries=dedup_entries, dedup_hits=dedup_hits, sheds=sheds,
                    replica=self.replica_id)
        metrics.event("gateway_drain", reason=reason, clean=clean, sessions=sessions,
                      sheds=sheds)
        if not clean:
            logger.warning("gateway drain (%s): %d connection(s) still flushing past %.1fs",
                           reason, sum(c.thread.is_alive() for c in conns), timeout)
        self._drained.set()
        return clean

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a drain (the SIGTERM handler's, say) has journaled its
        marker; a host calls it before it stops the service."""
        return self._drained.wait(timeout)

    # ----------------------------------------------------------- accept loop
    def _accept_loop(self) -> None:
        listener = self._listener
        while True:
            with self._lock:
                if self._draining:
                    break
            try:
                sock, addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # closed by a drain
            self._register(sock, addr)

    def _register(self, sock: socket.socket, addr: Any) -> None:
        with self._lock:
            if self._draining:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            cid = self._next_conn
            self._next_conn += 1
            thread = threading.Thread(target=self._serve, args=(cid, sock),
                                      name=f"gw-conn-{cid}", daemon=True)
            self._conns[cid] = _Conn(cid, sock, addr, thread)
            thread.start()

    def _unregister(self, cid: int) -> None:
        with self._lock:
            self._conns.pop(cid, None)

    # ---------------------------------------------------------- reader thread
    def _serve(self, cid: int, sock: socket.socket) -> None:
        reader = sock.makefile("rb")
        session: Optional[str] = None
        try:
            while True:
                try:
                    line = reader.readline(protocol.MAX_FRAME_BYTES + 1)
                except OSError:
                    break
                if not line:
                    break  # the client hung up, or a drain closed the read side
                arrival = time.monotonic()
                rid: Any = None
                try:
                    frame = protocol.decode_frame(line)
                    rid = frame.get("rid")
                    session = frame.get("session") or session
                    resp = protocol.ok_response(rid, self._dispatch(frame, session, arrival))
                except GatewayError as e:
                    resp = protocol.error_response(rid, e)
                    if e.code == protocol.GW_BADFRAME:
                        self._send(sock, resp)
                        break  # the stream's framing is lost
                except SimulatedKill as e:
                    # a kill takes the whole gateway: no answer, no marker
                    self._die(e)
                    return
                except Exception as e:
                    logger.exception("gateway: unexpected error serving conn %d", cid)
                    resp = protocol.error_response(rid, protocol.classify_exception(e))
                if not self._send(sock, resp):
                    break
        finally:
            try:
                reader.close()
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            self._unregister(cid)

    def _die(self, exc: BaseException) -> None:
        """The gateway's simulated death: every socket cut, nothing
        journaled; the next incarnation recovers."""
        with self._lock:
            self.killed = True
            self._draining = True  # the accept loop ends at its next poll
            conns = list(self._conns.values())
        listener = self._listener
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        for c in conns:
            # shut down before the close: the reader thread's file keeps the
            # descriptor open, and the client must see its connection die
            for cut in (lambda: c.sock.shutdown(socket.SHUT_RDWR), c.sock.close):
                try:
                    cut()
                except OSError:
                    pass
        logger.warning("gateway killed by crash harness: %s", exc)

    @staticmethod
    def _send(sock: socket.socket, resp: Dict[str, Any]) -> bool:
        try:
            sock.sendall(protocol.encode_frame(resp))
        except (OSError, GatewayError):
            return False
        return True

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, frame: Dict[str, Any], session: Optional[str],
                  arrival: float) -> Dict[str, Any]:
        op = frame.get("op")
        if op == "submit":
            return self._op_submit(frame, session, arrival)
        if op == "status":
            return self._op_status(frame)
        if op == "wait":
            return self._op_wait(frame)
        if op == "cancel":
            return self._op_cancel(frame)
        if op == "hello":
            return self._op_hello(frame, session)
        if op == "ping":
            with self._lock:
                draining = self._draining
            return {"pong": True, "draining": draining}
        raise GatewayError(protocol.GW_BADREQUEST, f"unknown op {op!r}")

    def _op_hello(self, frame: Dict[str, Any], session: Optional[str]) -> Dict[str, Any]:
        if not session:
            raise GatewayError(protocol.GW_BADREQUEST, "hello needs a session id")
        with self._lock:
            sess = self._sessions.get(session)
            resumed = sess is not None
            if sess is None:
                sess = self._sessions[session] = _Session(session)
            sess.connects += 1
            live = sum(1 for jid in sess.jobs if self._live_state(jid))
        return {"proto": protocol.PROTO_VERSION, "resumed": resumed, "live_jobs": live}

    def _op_submit(self, frame: Dict[str, Any], session: Optional[str],
                   arrival: float) -> Dict[str, Any]:
        with self._lock:
            if self._draining:
                raise GatewayError(protocol.GW_DRAINING,
                                   "gateway is draining; retry against the next incarnation")
        self._check_deadline(frame, arrival, session, "submit")
        job = frame.get("job")
        if not isinstance(job, dict) or not job.get("name"):
            raise GatewayError(protocol.GW_BADREQUEST, "submit needs a job object with a name")
        tenant = job.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise GatewayError(protocol.GW_BADREQUEST,
                               f"job.tenant must be a string, got {tenant!r}")
        key = frame.get("dedup_key")
        if key is not None and self.lease is not None:
            # a retry's answer is durable already and the table is shared:
            # any replica serves it, without the lease
            with self._dedup_lock:
                jid = self._dedup.get(key)
                if jid is not None:
                    return self._serve_dedup_hit(key, jid, session)
        epoch = self._ensure_lease(session)
        with self._dedup_lock:
            if key is not None:
                jid = self._dedup.get(key)
                if jid is not None:
                    return self._serve_dedup_hit(key, jid, session)
            # the wait for the dedup lock counts against the request's budget
            self._check_deadline(frame, arrival, session, "submit")
            self._check_window(session, tenant)
            # the fence, at the commit point: a replica deposed since its
            # lease check admits nothing
            if self.lease is not None and not self.lease.check(self.replica_id, epoch):
                self._shed("stale_epoch", session, "submit", tenant=tenant)
                raise GatewayError(
                    protocol.GW_STALE_EPOCH,
                    f"replica {self.replica_id} holds stale lease epoch {epoch} (current: "
                    f"{self.lease.epoch}) — nothing admitted; retry against the current "
                    "leaseholder")
            task = self._build_task(job)
            req = JobRequest(task=task, priority=float(job.get("priority", 0.0)),
                             deadline_s=job.get("deadline_s"),
                             max_retries=int(job.get("max_retries", 1)), spec=job.get("spec"),
                             dedup_key=key, tenant=tenant)
            try:
                rec = self.service.queue.submit(req)
            except (ValueError, RuntimeError) as e:
                raise protocol.classify_exception(e) from e
            # on a durable service submit() returning is the durable ack:
            # the job_submitted record, its key included, is committed
            if key is not None:
                self._dedup[key] = rec.job_id
            self._note_session_job(session, rec.job_id)
        return {"job_id": rec.job_id, "duplicate": False}

    def _serve_dedup_hit(self, key: str, jid: str, session: Optional[str]) -> Dict[str, Any]:
        """Answer a retried submit from the dedup table (the caller holds the
        re-entrant dedup lock)."""
        self._dedup_hits += 1
        self._note_session_job(session, jid)
        jnl = self.service.journal
        if jnl is not None:
            jnl.append("gateway_dedup_hit", key=key, job=jid, session=session,
                       replica=self.replica_id)
        metrics.event("gateway_dedup_hit", key=key, job=jid, session=session)
        return {"job_id": jid, "duplicate": True}

    def _ensure_lease(self, session: Optional[str]) -> Optional[int]:
        """Hold or take the lease before touching admission state; the epoch
        for the commit-point fence (None without a lease). A live peer's
        lease is a retriable refusal: the client rotates to it."""
        if self.lease is None:
            return None
        try:
            return self.lease.ensure(self.replica_id)
        except LeaseHeld as e:
            self._shed("lease_held", session, "submit")
            raise GatewayError(
                protocol.GW_RETRY_AFTER,
                f"replica {self.replica_id} is not the leaseholder ({e.holder} is) — retry "
                "against it", retry_after_s=e.retry_after_s) from e

    def _op_status(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        jid = self._job_id(frame)
        try:
            rec = self.service.queue.get(jid)
        except KeyError as e:
            raise protocol.classify_exception(e) from e
        return rec.snapshot()

    def _op_wait(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        jid = self._job_id(frame)
        chunk = min(float(frame.get("timeout_s") or self.wait_chunk_cap_s),
                    self.wait_chunk_cap_s)
        try:
            rec = self.service.queue.wait(jid, timeout=max(chunk, 0.0))
        except KeyError as e:
            raise protocol.classify_exception(e) from e
        except TimeoutError:
            return dict(self.service.queue.get(jid).snapshot(), terminal=False)
        return dict(rec.snapshot(), terminal=True)

    def _op_cancel(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        jid = self._job_id(frame)
        try:
            cancelled = self.service.queue.cancel(jid)
        except KeyError as e:
            raise protocol.classify_exception(e) from e
        return {"cancelled": cancelled}

    # -------------------------------------------------------------- helpers
    @staticmethod
    def _job_id(frame: Dict[str, Any]) -> str:
        jid = frame.get("job")
        if not isinstance(jid, str) or not jid:
            raise GatewayError(protocol.GW_BADREQUEST, "request needs a job id")
        return jid

    def _live_state(self, jid: str) -> bool:
        try:
            rec = self.service.queue.get(jid)
        except KeyError:
            return False
        return rec.state not in TERMINAL_STATES

    def _note_session_job(self, sid: Optional[str], jid: str) -> None:
        if sid is None:
            return
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                sess = self._sessions[sid] = _Session(sid)
            sess.jobs.add(jid)

    def _check_deadline(self, frame: Dict[str, Any], arrival: float, session: Optional[str],
                        op: str) -> None:
        deadline_s = frame.get("deadline_s")
        if deadline_s is None:
            return
        expired = time.monotonic() - arrival >= float(deadline_s)
        if expired or float(deadline_s) <= 0:
            self._shed("deadline_expired", session, op)
            raise GatewayError(protocol.GW_DEADLINE_EXPIRED,
                               f"request budget of {deadline_s}s elapsed before admission")

    def _pressure_active(self) -> bool:
        last = getattr(self.service, "last_pressure_shed", None)
        return last is not None and time.monotonic() - last < self.pressure_cooldown_s

    def _check_window(self, session: Optional[str], tenant: Optional[str] = None) -> None:
        tenancy = getattr(self.service, "tenancy", None)
        window = self.max_inflight
        pressured = self._pressure_active()
        if pressured and tenancy is None:
            # the shedder is evicting admitted work: feed it less until the
            # cooldown passes (with tenants the shrink is selective, below)
            window = max(1, int(window * self.pressure_window_factor))
        live = self.service.queue.live()
        if live >= window:
            self._shed("retry_after", session, "submit", tenant=tenant)
            raise GatewayError(protocol.GW_RETRY_AFTER,
                               f"{live} live job(s) >= window {window}"
                               + (" (pressure-shrunk)" if pressured else ""),
                               retry_after_s=self.retry_after_s)
        if tenancy is not None:
            self._check_tenant_window(session, tenant, tenancy, pressured)
        if session is not None:
            with self._lock:
                sess = self._sessions.get(session)
                jobs = list(sess.jobs) if sess is not None else []
            sess_live = sum(1 for jid in jobs if self._live_state(jid))
            if sess_live >= self.max_inflight_per_session:
                self._shed("retry_after_session", session, "submit", tenant=tenant)
                raise GatewayError(
                    protocol.GW_RETRY_AFTER,
                    f"session {session} has {sess_live} live job(s) >= per-session window "
                    f"{self.max_inflight_per_session}", retry_after_s=self.retry_after_s)

    def _check_tenant_window(self, session: Optional[str], tenant: Optional[str], tenancy,
                             pressured: bool) -> None:
        """The tenant's inflight window, shrunk under pressure only for a
        tenant over its weighted fair share."""
        quota = tenancy.quota(tenant)
        window = quota.max_inflight
        squeezed = False
        if pressured:
            if tenancy.over_fair_share(tenant, self.service.queue.live_by_tenant()):
                base = window if window is not None else self.max_inflight
                window = max(1, int(base * self.pressure_window_factor))
                squeezed = True
        if window is None:
            return
        tenant_live = self.service.queue.live_tenant(tenant)
        if tenant_live >= window:
            tenancy.note_shed(tenant)
            self._shed("tenant_over_quota", session, "submit", tenant=tenant)
            raise GatewayError(
                protocol.GW_TENANT_OVER_QUOTA,
                f"tenant {tenancy.resolve(tenant)!r} has {tenant_live} live job(s) >= its "
                f"window {window}" + (" (pressure-shrunk: over fair share)" if squeezed else ""),
                retry_after_s=(quota.retry_after_s if quota.retry_after_s is not None
                               else self.retry_after_s))

    def _shed(self, reason: str, session: Optional[str], op: str,
              tenant: Optional[str] = None) -> None:
        with self._lock:
            self._sheds[reason] = self._sheds.get(reason, 0) + 1
        jnl = self.service.journal
        if jnl is not None:
            jnl.append("gateway_shed", reason=reason, session=session, op=op, tenant=tenant,
                       replica=self.replica_id)
        metrics.event("gateway_shed", reason=reason, session=session, op=op, tenant=tenant)

    def _build_task(self, job: Dict[str, Any]) -> Any:
        provider = self.service.task_provider
        if provider is None:
            raise GatewayError(protocol.GW_BADREQUEST,
                               "wire submissions need SaturnService(task_provider=...) to "
                               "rebuild task objects from job specs")
        name = job["name"]
        total = int(job.get("total_batches") or 0)
        # the payload of crash recovery's build_restore_records: one
        # provider serves both paths
        task = provider({
            "job_id": None,
            "task": name,
            "total_batches": total,
            "remaining_batches": total,
            "priority": float(job.get("priority", 0.0)),
            "deadline_s": job.get("deadline_s"),
            "max_retries": int(job.get("max_retries", 1)),
            "spec": job.get("spec"),
            "tenant": job.get("tenant"),
        })
        if getattr(task, "name", None) != name:
            raise GatewayError(protocol.GW_INTERNAL,
                               f"task_provider returned {getattr(task, 'name', None)!r} for "
                               f"submitted name {name!r}")
        return task

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """The gateway's counters at this moment."""
        with self._lock:
            out: Dict[str, Any] = {"connections": len(self._conns),
                                   "sessions": len(self._sessions),
                                   "sheds": dict(self._sheds), "draining": self._draining}
        with self._dedup_lock:
            out["dedup_entries"] = len(self._dedup)
            out["dedup_hits"] = self._dedup_hits
        out["replica_id"] = self.replica_id
        if self.lease is not None:
            out["lease"] = self.lease.snapshot()
        return out
