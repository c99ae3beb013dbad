"""The port's network gateway, replica lease and wire chaos against the JAX
package's (``tests/test_gateway.py`` and the lease / gateway cases of
``tests/test_tenancy.py``), on CPU topologies over loopback TCP.

- Protocol: frames byte for byte over a seeded set of objects, the same
  error codes and constants, ``classify_exception`` on each package's own
  service exceptions, ``GatewayError`` round trips (also across packages).
- ``ReplicaLease``: JAX's lease cases on both packages with one fake clock;
  their observations and journaled ``gateway_lease`` records are equal.
- The gateway with a fake technique: JAX's surface, admission-control,
  drain, kill-replay and session-resume cases, the tenant windows and the
  replicated gateways.
- Netchaos: one spec draws the same fault sequence per connection in both
  packages' proxies; a short seeded campaign (``kill_ack`` and ``dup``,
  seed 11) ends with the trajectory of the in-process reference; the
  3-seed campaign and the mixed-fault kill / restart are ``slow``, as in
  the JAX suite.
- Journals: after a gateway run with a dedup hit, a lease acquisition and
  a drain, JAX's ``replay_service_state`` folds the port's journal into
  the same dedup table, lease epoch and owner and job states as the
  port's; a restarted service seeds the gateway from them.
- A cancel of an admitted job, answered over the wire, survives a kill
  before the next interval boundary (journaled at once; the restart evicts
  the job without calling ``task_provider``), and the JAX fold reads the
  record as the state the job had.
- End to end: the same tiny GPT-2 jobs through both packages' gateways,
  with a retried submit: the same job states, progress and dedup answers,
  and final losses within TRAJ_TOL of the JAX package's.

Tolerances: TRAJ_TOL on losses; none elsewhere.
"""

import dataclasses
import functools
import inspect
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu import durability as jdur
from saturn_tpu import service as jservice
from saturn_tpu import tenancy as jtenancy
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.core.technique import BaseTechnique as JBaseTechnique
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.resilience import netchaos as jnetchaos
from saturn_tpu.service.gateway import protocol as jprotocol
from saturn_tpu.tenancy import lease as jlease
from saturn_tpu.utils.metrics import read_events as j_read_events

import saturn_tpu_torch as sat
from saturn_tpu_torch import durability as dur
from saturn_tpu_torch import resilience as res
from saturn_tpu_torch import service
from saturn_tpu_torch import tenancy
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.resilience import netchaos
from saturn_tpu_torch.service.gateway import protocol
from saturn_tpu_torch.tenancy import lease

pytestmark = pytest.mark.gateway

TRAJ_TOL = 1e-4  # final losses against the JAX package's (tests/test_torch_service.py)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG",
                 "SATURN_TPU_HBM_BYTES", "SATURN_TPU_GROW_POLL", "SATURN_TPU_PARTITION_MAX",
                 "SATURN_TPU_SENTINEL", "SATURN_TPU_SENTINEL_SPIKE", "SATURN_TPU_MAX_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fakes(strategy_cls, technique_cls):
    class RecordingTech(technique_cls):
        """Sleeps per batch; records (task, block size) launches."""

        name = "gw-fake"

        def __init__(self, per_batch=0.001):
            self.per_batch = per_batch
            self.calls = []
            self.lock = threading.Lock()

        def execute(self, task, devices, tid, override_batch_count=None):
            with self.lock:
                self.calls.append((task.name, len(devices)))
            time.sleep(self.per_batch * (override_batch_count or 1))

        def search(self, task, devices, tid):
            return {}, self.per_batch

    class FakeTask:
        """A pre-profiled duck-typed task (admission runs no sweep)."""

        def __init__(self, name, total_batches, sizes, tech, pbt=0.001):
            self.name = name
            self.total_batches = total_batches
            self.current_batch = 0
            self.epoch_length = 1000
            self.hints = {}
            self.chip_range = None
            self.strategies = {g: strategy_cls(tech, g, {}, pbt * total_batches, pbt)
                               for g in sizes}
            self.selected_strategy = None

        def feasible_strategies(self):
            return {g: s for g, s in self.strategies.items() if s.feasible}

        def select_strategy(self, g):
            self.selected_strategy = self.strategies[g]

        def reconfigure(self, n):
            self.current_batch = (self.current_batch + n) % self.epoch_length

    return SimpleNamespace(RecordingTech=RecordingTech, FakeTask=FakeTask)


class _Dev:
    platform = "cpu"
    process_index = 0


PKGS = {
    "torch": SimpleNamespace(
        Service=service.SaturnService, SubmissionQueue=service.SubmissionQueue, JobRequest=service.JobRequest,
        GatewayServer=service.GatewayServer, GatewayClient=service.GatewayClient,
        GatewayError=service.GatewayError, protocol=protocol, lease=lease,
        ReplicaLease=tenancy.ReplicaLease, LeaseHeld=tenancy.LeaseHeld, replay=dur.replay, replay_service_state=dur.replay_service_state,
        fakes=_fakes(Strategy, BaseTechnique),
        topo=lambda n=8: SliceTopology([torch.device("cpu")] * n)),
    "jax": SimpleNamespace(
        Service=jservice.SaturnService, SubmissionQueue=jservice.SubmissionQueue, JobRequest=jservice.JobRequest,
        GatewayServer=jservice.GatewayServer, GatewayClient=jservice.GatewayClient,
        GatewayError=jservice.GatewayError, protocol=jprotocol, lease=jlease,
        ReplicaLease=jtenancy.ReplicaLease, LeaseHeld=jtenancy.LeaseHeld, replay=jdur.replay, replay_service_state=jdur.replay_service_state,
        fakes=_fakes(JStrategy, JBaseTechnique),
        topo=lambda n=8: JSliceTopology([_Dev() for _ in range(n)])),
}
T = PKGS["torch"]
F = T.fakes
SPEC = {"sizes": [4, 8]}


def _provider(tech, fakes=F, calls=None):
    """The one rebuild contract of wire submits and crash recovery."""
    def provide(payload):
        if calls is not None:
            calls.append(payload)
        return fakes.FakeTask(payload["task"], payload["remaining_batches"],
                              payload["spec"]["sizes"], tech, pbt=0.004)

    return provide


def _service(tech, wal=None, barrier=None, start=True, pkg="torch", calls=None, **kw):
    p = PKGS[pkg]
    svc = p.Service(topology=p.topo(8), interval=0.2, poll_s=0.02, durability_dir=wal,
                    task_provider=_provider(tech, p.fakes, calls), crash_barrier=barrier,
                    health_guardian=False, **kw)
    return svc.start() if start else svc


def _submit_frame(gw, name, tenant=None, dedup_key=None, total=3, session="sess"):
    job = {"name": name, "total_batches": total, "spec": SPEC}
    if tenant is not None:
        job["tenant"] = tenant
    frame = {"op": "submit", "job": job}
    if dedup_key is not None:
        frame["dedup_key"] = dedup_key
    return gw._op_submit(frame, session, time.monotonic())


# ---------------------------------------------------------------- surfaces
@pytest.mark.parametrize("name,attr", [
    ("GatewayServer", "__init__"), ("GatewayClient", "__init__"), ("GatewayClient", "submit"),
    ("GatewayClient", "status"), ("GatewayClient", "wait"), ("GatewayClient", "cancel"),
    ("GatewayClient", "ping"), ("ReplicaLease", "__init__"), ("GatewayServer", "shutdown")])
def test_signatures_are_the_jax_packages(name, attr):
    assert (inspect.signature(getattr(getattr(T, name), attr))
            == inspect.signature(getattr(getattr(PKGS["jax"], name), attr)))


def test_exports():
    for name in ("GatewayServer", "GatewayClient", "GatewayError"):
        assert name in service.__all__
    assert {"ReplicaLease", "LeaseHeld"} <= set(tenancy.__all__)
    assert {"NET_FAULT_CLASSES", "NetChaosSpec", "NetChaosStats", "NetChaosProxy",
            "single_fault_spec"} <= set(res.__all__)
    assert netchaos.NET_FAULT_CLASSES == jnetchaos.NET_FAULT_CLASSES
    assert ([(f.name, f.default) for f in dataclasses.fields(netchaos.NetChaosSpec)]
            == [(f.name, f.default) for f in dataclasses.fields(jnetchaos.NetChaosSpec)])


# ----------------------------------------------------------------- protocol
def _random_obj(rng, depth=0):
    kind = rng.randrange(8 if depth < 3 else 5)
    if kind == 0:
        return rng.randrange(-10**9, 10**9)
    if kind == 1:
        return rng.uniform(-1e6, 1e6)
    if kind == 2:
        return "".join(rng.choice("aZ0 _:-\"\\é漢\n\t") for _ in range(rng.randrange(12)))
    if kind == 3:
        return rng.choice([None, True, False])
    if kind == 4:
        return rng.randrange(100) / 7.0
    if kind == 5:
        return [_random_obj(rng, depth + 1) for _ in range(rng.randrange(4))]
    return {f"k{rng.randrange(50)}": _random_obj(rng, depth + 1) for _ in range(rng.randrange(5))}


def test_frames_are_the_jax_packages_byte_for_byte():
    rng = random.Random(21)
    frames = [{"op": "submit", "rid": f"s:{i}", "job": _random_obj(rng), "x": _random_obj(rng)}
              for i in range(200)]
    frames.append({"rid": "s:0", "ok": False,
                   "error": protocol.GatewayError(protocol.GW_RETRY_AFTER, "full",
                                                  retry_after_s=0.1234567).to_wire()})
    for frame in frames:
        got = protocol.encode_frame(frame)
        assert got == jprotocol.encode_frame(frame)
        assert protocol.decode_frame(got) == jprotocol.decode_frame(got)
    assert protocol.encode_frame(protocol.ok_response("r", {"a": 1})) == jprotocol.encode_frame(
        jprotocol.ok_response("r", {"a": 1}))


def test_error_codes_and_constants_match():
    assert protocol.ERROR_CODES == jprotocol.ERROR_CODES
    assert protocol.RETRIABLE_CODES == jprotocol.RETRIABLE_CODES
    assert protocol.MAX_FRAME_BYTES == jprotocol.MAX_FRAME_BYTES
    assert protocol.PROTO_VERSION == jprotocol.PROTO_VERSION
    for code in protocol.ERROR_CODES:
        assert getattr(protocol, code) == getattr(jprotocol, code) == code


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_decode_rejects_garbage_and_oversized(pkg):
    p = PKGS[pkg]
    for raw in (b"not json\n", b"[1,2]\n", b"\xff\xfe\n",
                b"x" * (p.protocol.MAX_FRAME_BYTES + 1)):
        with pytest.raises(p.GatewayError) as ei:
            p.protocol.decode_frame(raw)
        assert ei.value.code == p.protocol.GW_BADFRAME
    with pytest.raises(p.GatewayError):
        p.protocol.encode_frame({"op": "submit", "blob": "x" * p.protocol.MAX_FRAME_BYTES})
    with pytest.raises(ValueError):
        p.GatewayError("GW_NOT_A_CODE")


def test_errors_round_trip_across_the_packages():
    for code in sorted(protocol.ERROR_CODES):
        hint = 0.25 if code == protocol.GW_RETRY_AFTER else None
        for make, back in ((protocol.GatewayError, jprotocol.GatewayError),
                           (jprotocol.GatewayError, protocol.GatewayError)):
            e = make(code, "why it failed", retry_after_s=hint)
            b = back.from_wire(e.to_wire())
            assert (b.code, b.message, b.retriable, b.retry_after_s) == (
                e.code, e.message, e.retriable, e.retry_after_s)
            assert e.to_wire() == back(code, "why it failed", retry_after_s=hint).to_wire()
    for payload in (None, "boom", {"code": "GW_NOPE", "message": "m"}):
        e, je = protocol.GatewayError.from_wire(payload), jprotocol.GatewayError.from_wire(payload)
        assert (e.code, e.message) == (je.code, je.message) == (protocol.GW_INTERNAL, je.message)


def _service_exceptions(p):
    """The exceptions each package's service raises for a duplicate live
    name and an unknown job id, and two others."""
    q = p.SubmissionQueue()
    tech = p.fakes.RecordingTech()
    q.submit(p.JobRequest(p.fakes.FakeTask("a", 3, [1], tech)))
    out = []
    try:
        q.submit(p.JobRequest(p.fakes.FakeTask("a", 3, [1], tech)))
    except ValueError as e:
        out.append(e)
    try:
        q.get("j9999-nope")
    except KeyError as e:
        out.append(e)
    return out + [ValueError("bad field"), RuntimeError("boom")]


def test_classify_exception_gives_the_jax_packages_codes():
    got = [(e.code, e.message) for e in map(protocol.classify_exception,
                                            _service_exceptions(T))]
    want = [(e.code, e.message) for e in map(jprotocol.classify_exception,
                                             _service_exceptions(PKGS["jax"]))]
    assert got == want
    assert [c for c, _ in got] == [protocol.GW_DUPLICATE_NAME, protocol.GW_UNKNOWN_JOB,
                                   protocol.GW_BADREQUEST, protocol.GW_INTERNAL]
    assert "RuntimeError" in got[-1][1]


# ------------------------------------------------------------ replica lease
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


class _Journal:
    def __init__(self):
        self.records = []

    def log(self, kind, **data):
        self.records.append((kind, data))

    append = log


def _lease_acquire_renew_check(p, clock):
    lease_ = p.ReplicaLease(ttl_s=30.0)
    e1 = lease_.ensure("gw-a")
    out = [e1, lease_.owner, lease_.ensure("gw-a"), lease_.check("gw-a", e1),
           lease_.check("gw-b", e1), lease_.check("gw-a", e1 + 1)]
    assert out == [1, "gw-a", 1, True, False, False]
    return out


def _lease_held_by_live_peer(p, clock):
    lease_ = p.ReplicaLease(ttl_s=30.0)
    lease_.ensure("gw-a")
    clock.t += 10.0
    with pytest.raises(p.LeaseHeld) as ei:
        lease_.ensure("gw-b")
    assert ei.value.holder == "gw-a" and ei.value.retry_after_s > 0
    return [ei.value.holder, ei.value.retry_after_s, str(ei.value)]


def _lease_mark_dead_fences(p, clock):
    lease_ = p.ReplicaLease(ttl_s=30.0)
    e1 = lease_.ensure("gw-a")
    lease_.mark_dead("gw-a")
    out = [lease_.check("gw-a", e1)]  # mark_dead alone does not move the epoch
    e2 = lease_.ensure("gw-b")
    out += [e2, lease_.check("gw-a", e1), lease_.check("gw-b", e2), lease_.snapshot()]
    assert out[:4] == [True, e1 + 1, False, True]
    return out


def _lease_ttl_expiry(p, clock):
    lease_ = p.ReplicaLease(ttl_s=0.05)
    e1 = lease_.ensure("gw-a")
    clock.t += 0.08
    e2 = lease_.ensure("gw-b")
    assert e2 == e1 + 1 and not lease_.check("gw-a", e1)
    return [e1, e2]


def _lease_release_reacquire(p, clock):
    lease_ = p.ReplicaLease(ttl_s=30.0)
    lease_.ensure("gw-a")
    lease_.release("gw-a")
    out = [lease_.owner, lease_.ensure("gw-b")]
    assert out == [None, 2]
    return out


def _lease_journals(p, clock):
    jnl = _Journal()
    lease_ = p.ReplicaLease(jnl, ttl_s=30.0)
    lease_.ensure("gw-a")
    lease_.ensure("gw-a")  # a renewal journals nothing
    lease_.mark_dead("gw-a")
    lease_.ensure("gw-b")
    assert [(d["epoch"], d["owner"]) for _, d in jnl.records] == [(1, "gw-a"), (2, "gw-b")]
    assert jnl.records[1][1]["prev_owner"] == "gw-a"
    epochs = [e for e, _, _ in lease_.history]
    assert len(epochs) == len(set(epochs))
    return [jnl.records, lease_.history]


def _lease_seeded_epoch(p, clock):
    lease_ = p.ReplicaLease(ttl_s=30.0, epoch=7)
    assert lease_.ensure("gw-c") == 8
    return [lease_.epoch, lease_.owner]


LEASE_CASES = [_lease_acquire_renew_check, _lease_held_by_live_peer, _lease_mark_dead_fences,
               _lease_ttl_expiry, _lease_release_reacquire, _lease_journals, _lease_seeded_epoch]


@pytest.mark.parametrize("case", LEASE_CASES, ids=lambda f: f.__name__[7:])
def test_lease_cases_match_jax(case, monkeypatch):
    outs = []
    for pkg in ("torch", "jax"):
        clock = _Clock()
        monkeypatch.setattr(PKGS[pkg].lease, "time", clock)
        outs.append(case(PKGS[pkg], clock))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ basic surface
def test_submit_wait_status_cancel_over_the_wire(tmp_path):
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc).start()
    try:
        with service.GatewayClient(*gw.address, seed=1) as c:
            jid = c.submit(name="wire-a", total_batches=5, spec=SPEC)
            snap = c.status(jid)
            assert snap["job_id"] == jid and snap["task"] == "wire-a"
            assert c.wait(jid, timeout=60)["state"] == "DONE"
            assert c.cancel(jid) is False  # terminal already
            assert c.ping()["pong"] is True
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


def test_duplicate_name_unknown_job_and_bad_op_are_typed(tmp_path):
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc).start()
    try:
        with service.GatewayClient(*gw.address, seed=2) as c:
            c.submit(name="dup-name", total_batches=50, spec=SPEC)
            with pytest.raises(service.GatewayError) as ei:
                c.submit(name="dup-name", total_batches=5, spec=SPEC)
            assert ei.value.code == protocol.GW_DUPLICATE_NAME and not ei.value.retriable
            with pytest.raises(service.GatewayError) as ei:
                c.status("j9999-nope")
            assert ei.value.code == protocol.GW_UNKNOWN_JOB
            with pytest.raises(service.GatewayError) as ei:
                c._call({"op": "frobnicate"})
            assert ei.value.code == protocol.GW_BADREQUEST
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


def test_same_dedup_key_returns_the_original_job_id(tmp_path):
    wal = str(tmp_path / "wal")
    tech = F.RecordingTech()
    svc = _service(tech, wal=wal)
    gw = service.GatewayServer(svc).start()
    try:
        with service.GatewayClient(*gw.address, seed=4) as c:
            a = c.submit(name="idem", total_batches=5, spec=SPEC, dedup_key="retry:me:1")
            b = c.submit(name="idem", total_batches=5, spec=SPEC, dedup_key="retry:me:1")
            assert a == b and gw.stats()["dedup_hits"] == 1
            assert c.wait(a, timeout=60)["state"] == "DONE"
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)
    hits = [r["data"] for r in dur.replay(wal) if r["kind"] == "gateway_dedup_hit"]
    assert [(h["key"], h["job"]) for h in hits] == [("retry:me:1", a)]


# ---------------------------------------------------- deadlines, windows
def test_expired_request_deadline_sheds_before_admission(tmp_path):
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc).start()
    try:
        with service.GatewayClient(*gw.address, seed=5) as c:
            with pytest.raises(service.GatewayError) as ei:
                c.submit(name="late", total_batches=5, spec=SPEC, request_deadline_s=0.0)
            assert ei.value.code == protocol.GW_DEADLINE_EXPIRED
            assert gw.stats()["sheds"] == {"deadline_expired": 1}
            assert all(r.name != "late" for r in svc.queue.jobs())
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


@pytest.mark.parametrize("pressure", [False, True])
def test_global_window_backpressure(tmp_path, pressure):
    """A full window answers ``GW_RETRY_AFTER`` with a hint; a recent
    pressure shed shrinks the window by ``pressure_window_factor``."""
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc, max_inflight=8 if pressure else 1,
                               pressure_window_factor=0.25).start()
    try:
        if pressure:
            svc.last_pressure_shed = time.monotonic()  # window 8 x 0.25 = 2
        with service.GatewayClient(*gw.address, seed=6, max_attempts=1) as c:
            for i in range(2 if pressure else 1):
                c.submit(name=f"bp-{i}", total_batches=2000, spec=SPEC)
            with pytest.raises(service.GatewayError) as ei:
                c.submit(name="bp-x", total_batches=5, spec=SPEC)
            e = ei.value
            assert e.code in (protocol.GW_RETRY_AFTER, protocol.GW_UNAVAILABLE)
            if e.code == protocol.GW_RETRY_AFTER:
                assert e.retriable and e.retry_after_s > 0
                assert ("pressure-shrunk" in e.message) == pressure
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


def test_retry_after_clears_once_the_window_frees(tmp_path):
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc, max_inflight=1, retry_after_s=0.1).start()
    try:
        with service.GatewayClient(*gw.address, seed=7, max_attempts=30,
                                   backoff_base_s=0.05) as c:
            a = c.submit(name="win-a", total_batches=3, spec=SPEC)
            b = c.submit(name="win-b", total_batches=3, spec=SPEC)  # retries past a
            assert c.wait(a, timeout=60)["state"] == "DONE"
            assert c.wait(b, timeout=60)["state"] == "DONE"
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


def test_per_session_window_survives_a_reconnect(tmp_path):
    tech = F.RecordingTech()
    svc = _service(tech, wal=str(tmp_path / "wal"))
    gw = service.GatewayServer(svc, max_inflight=64, max_inflight_per_session=1).start()
    try:
        c = service.GatewayClient(*gw.address, session="resume-me", seed=14, max_attempts=1)
        c.submit(name="rs-a", total_batches=2000, spec=SPEC)
        c.close()
        c2 = service.GatewayClient(*gw.address, session="resume-me", seed=15, max_attempts=1)
        with pytest.raises(service.GatewayError):
            c2.submit(name="rs-b", total_batches=5, spec=SPEC)
        c2.close()
        assert gw.stats()["sessions"] == 1
        with service.GatewayClient(*gw.address, seed=10, max_attempts=1) as c3:
            c3.submit(name="rs-c", total_batches=5, spec=SPEC)  # another session fits
    finally:
        gw.shutdown(reason="test")
        svc.stop(abort=True, timeout=30)


# -------------------------------------------------------------------- drain
def test_drain_refuses_submits_and_journals_its_marker(tmp_path):
    wal = str(tmp_path / "wal")
    tech = F.RecordingTech()
    svc = _service(tech, wal=wal)
    gw = service.GatewayServer(svc).start()
    with service.GatewayClient(*gw.address, seed=11) as c:
        jid = c.submit(name="drain-a", total_batches=5, spec=SPEC)
        assert gw.shutdown(timeout=10.0, reason="SIGTERM") is True
        with pytest.raises(service.GatewayError) as ei:
            c.submit(name="drain-b", total_batches=5, spec=SPEC)
        assert ei.value.code in (protocol.GW_DRAINING, protocol.GW_UNAVAILABLE)
    svc.stop(abort=True, timeout=30)
    drains = [r["data"] for r in dur.replay(wal) if r["kind"] == "gateway_drain"]
    assert len(drains) == 1
    assert drains[0]["reason"] == "SIGTERM" and drains[0]["clean"] is True
    assert drains[0]["dedup_entries"] == 1
    assert jid in dur.replay_service_state(wal).jobs
    with pytest.raises(service.GatewayError) as ei:
        service.GatewayClient(*gw.address, seed=12, max_attempts=2, timeout_s=1.0,
                              backoff_base_s=0.01).ping()
    assert ei.value.code == protocol.GW_UNAVAILABLE


def test_wait_drained_blocks_until_the_marker_is_durable(tmp_path):
    wal = str(tmp_path / "wal")
    svc = _service(F.RecordingTech(), wal=wal)
    gw = service.GatewayServer(svc).start()
    assert gw.wait_drained(timeout=0.05) is False
    t = threading.Thread(target=gw.shutdown, kwargs={"reason": "SIGTERM"}, daemon=True)
    t.start()
    assert gw.wait_drained(timeout=10.0) is True
    assert "gateway_drain" in [r["kind"] for r in dur.replay(wal)]
    t.join(timeout=5.0)
    svc.stop(abort=True, timeout=30)


# -------------------------------------------------------------- kill-replay
def test_ack_cut_by_a_gateway_kill_recovers_idempotently(tmp_path):
    """The submit's commit lands, the gateway dies before its answer (a
    kill at ``post-commit`` in the reader thread), and the retry against
    the next incarnation gets the original id: one admission."""
    wal = str(tmp_path / "wal")
    inj = res.CrashInjector("post-commit", hit=1, armed=False)
    svc = _service(F.RecordingTech(), wal=wal, barrier=inj.barrier, start=False)
    gw = service.GatewayServer(svc).start()
    inj.arm()
    with pytest.raises(service.GatewayError) as ei:
        service.GatewayClient(*gw.address, session="killer", seed=13, max_attempts=2,
                              timeout_s=2.0, backoff_base_s=0.01).submit(
            name="kill-a", total_batches=4, spec=SPEC, dedup_key="kill:me:1")
    assert ei.value.code == protocol.GW_UNAVAILABLE
    assert inj.fired.is_set() and gw.killed
    original = dur.replay_service_state(wal).dedup["kill:me:1"]
    svc2 = _service(F.RecordingTech(), wal=wal)
    assert svc2.recovered_dedup == {"kill:me:1": original}
    gw2 = service.GatewayServer(svc2).start()
    try:
        with service.GatewayClient(*gw2.address, session="killer", seed=13) as c:
            jid = c.submit(name="kill-a", total_batches=4, spec=SPEC, dedup_key="kill:me:1")
            assert jid == original
            assert c.wait(jid, timeout=60)["state"] == "DONE"
    finally:
        gw2.shutdown(reason="test")
        svc2.stop(abort=True, timeout=30)
    final = dur.replay_service_state(wal)
    assert [j.job_id for j in final.jobs.values() if j.dedup_key == "kill:me:1"] == [original]


def _held_kill(wal, tech, calls, name="cancel-me"):
    """A service whose loop stops at its first ``mid-interval`` barrier
    after job ``name`` runs, until the test has cancelled the job over the
    wire; then a kill at that barrier. Returns (service, gateway, the
    cancelled job's id, what ``cancel`` answered, the injector)."""
    inj = res.CrashInjector("mid-interval", hit=1, armed=False)
    held, go = threading.Event(), threading.Event()
    state = {}

    def barrier(point, ctx):
        if point == "mid-interval" and not held.is_set() and state.get("jid"):
            rec = state["svc"].queue.get(state["jid"])
            if rec.started_at is not None:
                held.set()
                assert go.wait(30), "the test never released the loop"
        inj.barrier(point, ctx)

    svc = _service(tech, wal=wal, barrier=barrier, start=False, calls=calls)
    state["svc"] = svc
    svc.start()
    gw = service.GatewayServer(svc).start()
    with service.GatewayClient(*gw.address, seed=17) as c:
        state["jid"] = jid = c.submit(name=name, total_batches=2000, spec=SPEC,
                                      dedup_key="k-cancel")
        assert held.wait(30), "the job never ran an interval"
        answer = c.cancel(jid)
    inj.arm()
    go.set()
    assert inj.fired.wait(30)
    svc._thread.join(30)
    assert svc.killed
    gw._die(svc._error)
    return svc, gw, jid, answer, inj


def test_a_wire_cancel_survives_a_kill_before_the_boundary(tmp_path):
    """The cancel of an admitted job is answered true, the service is
    killed before the boundary that would sweep it: the restart evicts it
    as "cancelled" with no provider call and no launch, and journals the
    eviction."""
    wal = str(tmp_path / "wal")
    tech = F.RecordingTech(per_batch=0.004)
    calls = []
    svc, _, jid, answer, _ = _held_kill(wal, tech, calls)
    assert answer is True
    assert svc.queue.get(jid).state.value == "RUNNING"  # never swept
    folded = dur.replay_service_state(wal).jobs[jid]
    assert folded.cancel_requested and not folded.terminal
    n_calls = len(calls)
    tech2 = F.RecordingTech(per_batch=0.004)
    svc2 = _service(tech2, wal=wal, calls=calls)
    gw2 = service.GatewayServer(svc2).start()
    try:
        with service.GatewayClient(*gw2.address, seed=18) as c:
            snap = c.wait(jid, timeout=30)
            assert c.submit(name="cancel-me", total_batches=5, spec=SPEC,
                            dedup_key="k-cancel") == jid  # the dedup table stands
    finally:
        gw2.shutdown(reason="test")
        svc2.stop(timeout=30)
    assert (snap["state"], snap["error"]) == ("EVICTED", "cancelled")
    assert len(calls) == n_calls and not tech2.calls
    after = dur.replay_service_state(wal).jobs[jid]
    assert after.state == "EVICTED" and after.error == "cancelled"
    assert jdur.replay_service_state(wal).jobs[jid].state == "EVICTED"


def test_the_jax_fold_reads_a_cancel_record_as_the_state_it_had(tmp_path):
    """JAX's fold of the journal a cancelled and killed run left gives the
    job the state, attempts, requeues and error its last edge before the
    cancel record gave (what it read before the record existed); the port's
    fold keeps the flag."""
    wal = str(tmp_path / "wal")
    _, _, jid, _, _ = _held_kill(wal, F.RecordingTech(per_batch=0.004), [])
    recs = dur.replay(wal, strict=True)
    assert recs == jdur.replay(wal, strict=True)
    i = next(i for i, r in enumerate(recs) if r["data"].get("cancel_requested"))
    cancel = recs[i]["data"]
    assert recs[i]["kind"] == "job_state" and cancel["job"] == jid
    before = [r["data"] for r in recs[:i] if r["kind"] == "job_state" and r["data"]["job"] == jid]
    assert before and not any(r["data"].get("job") == jid and r["kind"] == "job_state"
                              for r in recs[i + 1:])
    j = jdur.replay_service_state(wal).jobs[jid]
    assert (j.state, j.attempts, j.requeues) == (before[-1]["state"], before[-1]["attempts"],
                                                 before[-1]["requeues"]) == (
        cancel["state"], cancel["attempts"], cancel["requeues"])
    assert j.error == before[-1]["error"] and not hasattr(j, "cancel_requested")
    port = dur.replay_service_state(wal).jobs[jid]
    assert port.state == j.state and port.cancel_requested


# ------------------------------------------------------------ tenant window
def test_bursty_tenant_shed_quiet_untouched():
    led = tenancy.TenantLedger({"bursty": tenancy.TenantQuota(max_inflight=2, retry_after_s=0.7),
                                "quiet": tenancy.TenantQuota(max_inflight=8)})
    svc = _service(F.RecordingTech(), start=False, tenancy=led)
    gw = service.GatewayServer(svc)
    _submit_frame(gw, "b-0", tenant="bursty")
    _submit_frame(gw, "b-1", tenant="bursty")
    with pytest.raises(service.GatewayError) as ei:
        _submit_frame(gw, "b-2", tenant="bursty")
    assert ei.value.code == protocol.GW_TENANT_OVER_QUOTA and ei.value.retriable
    assert ei.value.retry_after_s == 0.7
    for i in range(3):
        _submit_frame(gw, f"q-{i}", tenant="quiet")
    assert svc.queue.live_tenant("quiet") == 3
    assert led.snapshot()["bursty"]["shed"] == 1
    assert not led.snapshot().get("quiet", {}).get("shed")
    assert gw.stats()["sheds"] == {"tenant_over_quota": 1}


def test_pressure_shrink_targets_only_over_share_tenants():
    led = tenancy.TenantLedger({"hog": tenancy.TenantQuota(max_inflight=4),
                                "quiet": tenancy.TenantQuota(max_inflight=4)})
    svc = _service(F.RecordingTech(), start=False, tenancy=led)
    gw = service.GatewayServer(svc, max_inflight=16)
    for i in range(3):
        _submit_frame(gw, f"h-{i}", tenant="hog")
    _submit_frame(gw, "q-0", tenant="quiet")
    svc.last_pressure_shed = time.monotonic()
    with pytest.raises(service.GatewayError) as ei:
        _submit_frame(gw, "h-3", tenant="hog")
    assert ei.value.code == protocol.GW_TENANT_OVER_QUOTA
    assert "pressure-shrunk" in ei.value.message
    _submit_frame(gw, "q-1", tenant="quiet")
    assert svc.queue.live_tenant("quiet") == 2
    with pytest.raises(service.GatewayError) as ei:
        gw._op_submit({"op": "submit", "job": {"name": "x", "total_batches": 3, "spec": SPEC,
                                               "tenant": 123}}, "s", time.monotonic())
    assert ei.value.code == protocol.GW_BADREQUEST


def test_a_service_pressure_shed_sets_the_time():
    """``_shed_pressure`` stamps ``last_pressure_shed`` when it evicts, as
    the JAX service does; a shed of nothing leaves it."""
    svc = _service(F.RecordingTech(), start=False)
    assert svc.last_pressure_shed is None
    svc._shed_pressure({}, svc.topology, None)
    assert svc.last_pressure_shed is None
    from saturn_tpu_torch.service import server as tserver

    rec = svc.queue.submit(service.JobRequest(F.FakeTask("victim", 3, [8], F.RecordingTech())))
    orig = tserver.project_pressure_shed
    try:
        tserver.project_pressure_shed = lambda *a, **k: ([rec], 2.0, 1.0)
        before = time.monotonic()
        svc._shed_pressure({rec.name: rec}, svc.topology, None)
    finally:
        tserver.project_pressure_shed = orig
    assert svc.last_pressure_shed >= before
    assert svc.queue.get(rec.job_id).error == "admission-pressure"


# ------------------------------------------------------- replicated gateways
def _pair(svc, ttl_s=30.0):
    lease_ = tenancy.ReplicaLease(ttl_s=ttl_s)
    gw_a = service.GatewayServer(svc, replica_id="gw-a", lease=lease_)
    gw_b = service.GatewayServer(svc, replica_id="gw-b", replica_of=gw_a)
    return lease_, gw_a, gw_b


def test_a_replica_must_front_the_same_service():
    gw = service.GatewayServer(_service(F.RecordingTech(), start=False), replica_id="gw-a")
    with pytest.raises(ValueError):
        service.GatewayServer(_service(F.RecordingTech(), start=False), replica_of=gw)


def test_a_non_leaseholder_refuses_but_serves_dedup():
    svc = _service(F.RecordingTech(), start=False)
    lease_, gw_a, gw_b = _pair(svc)
    out = _submit_frame(gw_a, "r-0", dedup_key="k-r0")
    assert not out["duplicate"] and lease_.owner == "gw-a"
    with pytest.raises(service.GatewayError) as ei:
        _submit_frame(gw_b, "r-1", dedup_key="k-r1")
    assert ei.value.code == protocol.GW_RETRY_AFTER and "gw-a" in ei.value.message
    assert _submit_frame(gw_b, "r-0", dedup_key="k-r0") == {"job_id": out["job_id"],
                                                            "duplicate": True}
    assert svc.queue.live() == 1


def test_a_clean_shutdown_hands_the_lease_to_the_peer():
    svc = _service(F.RecordingTech(), start=False)
    lease_, gw_a, gw_b = _pair(svc)
    _submit_frame(gw_a, "h-0")
    assert lease_.epoch == 1
    gw_a.shutdown(timeout=2.0)
    _submit_frame(gw_b, "h-1")
    assert lease_.owner == "gw-b" and lease_.epoch == 2


def test_a_stale_epoch_is_fenced_and_admits_nothing(monkeypatch):
    svc = _service(F.RecordingTech(), start=False)
    lease_, gw_a, gw_b = _pair(svc)
    _submit_frame(gw_a, "f-0")
    stale = lease_.epoch
    lease_.mark_dead("gw-a")
    _submit_frame(gw_b, "f-1")
    assert lease_.epoch == stale + 1
    monkeypatch.setattr(gw_a, "_ensure_lease", lambda session: stale)
    live_before = svc.queue.live()
    with pytest.raises(service.GatewayError) as ei:
        _submit_frame(gw_a, "f-2", dedup_key="k-stale")
    assert ei.value.code == protocol.GW_STALE_EPOCH and ei.value.retriable
    assert svc.queue.live() == live_before and "k-stale" not in gw_a._dedup
    assert gw_a.stats()["sheds"].get("stale_epoch") == 1


# ----------------------------------------------------------------- journals
def test_both_folds_read_a_gateway_journal_alike(tmp_path):
    """A gateway run with a lease acquisition, a dedup hit and a drain: both
    packages' folds give the same dedup table, lease epoch, owner and
    history, and job states; a restarted service hands them back."""
    wal = str(tmp_path / "wal")
    svc = _service(F.RecordingTech(), wal=wal)
    lease_ = tenancy.ReplicaLease(ttl_s=30.0)
    gw = service.GatewayServer(svc, replica_id="gw-a", lease=lease_).start()
    try:
        with service.GatewayClient(*gw.address, seed=3) as c:
            a = c.submit(name="fold-a", total_batches=3, spec=SPEC, dedup_key="k-a")
            assert c.submit(name="fold-a", total_batches=3, spec=SPEC, dedup_key="k-a") == a
            b = c.submit(name="fold-b", total_batches=2000, spec=SPEC, dedup_key="k-b")
            assert c.wait(a, timeout=60)["state"] == "DONE"
            assert c.cancel(b) is True
            assert c.wait(b, timeout=60)["state"] == "EVICTED"
    finally:
        gw.shutdown(timeout=5.0, reason="fold")
        svc.stop(timeout=30)
    kinds = {r["kind"] for r in dur.replay(wal, strict=True)}
    assert {"gateway_lease", "gateway_dedup_hit", "gateway_drain"} <= kinds
    got, want = dur.replay_service_state(wal), jdur.replay_service_state(wal)
    assert got.dedup == want.dedup == {"k-a": a, "k-b": b}
    assert (got.lease_epoch, got.lease_owner) == (want.lease_epoch, want.lease_owner) == (1, "gw-a")
    assert got.lease_history == want.lease_history
    assert ({k: (j.state, j.realized, j.error) for k, j in got.jobs.items()}
            == {k: (j.state, j.realized, j.error) for k, j in want.jobs.items()})
    svc2 = _service(F.RecordingTech(), wal=wal, start=False)
    assert svc2.recovered_dedup == got.dedup
    assert (svc2.recovered_lease_epoch, svc2.recovered_lease_owner) == (1, "gw-a")
    lease2 = tenancy.ReplicaLease(ttl_s=30.0, epoch=svc2.recovered_lease_epoch)
    gw2 = service.GatewayServer(svc2, replica_id="gw-b", lease=lease2)
    assert lease2.journal is svc2.journal  # wired from the service
    assert _submit_frame(gw2, "fold-a", dedup_key="k-a") == {"job_id": a, "duplicate": True}
    _submit_frame(gw2, "fold-c")
    assert lease2.epoch == 2
    svc2.journal.close()
    assert [e for e, _, _ in jdur.replay_service_state(wal).lease_history] == [1, 2]


# ------------------------------------------------------------------ netchaos
@pytest.mark.parametrize("spec", [
    netchaos.NetChaosSpec(seed=11), netchaos.NetChaosSpec(seed=31, fault_rate=0.3),
    netchaos.single_fault_spec(11, "kill_ack", max_faults_per_conn=2),
    netchaos.single_fault_spec(23, "dup", max_faults_per_conn=2),
    netchaos.NetChaosSpec(seed=5, fault_rate=0.9, max_faults_per_conn=50, skip_frames=0)],
    ids=["mixed-11", "mixed-31", "kill_ack-11", "dup-23", "dense-5"])
def test_a_spec_draws_the_jax_packages_fault_sequence(spec):
    """Per connection and direction, the same draws (fault, and a partial's
    cut) in both packages' pumps."""
    jspec = jnetchaos.NetChaosSpec(**dataclasses.asdict(spec))

    def draws(mod, s, conn, direction):
        proxy = SimpleNamespace(spec=s, stats=mod.NetChaosStats())
        pump = mod._Pump(proxy, conn, direction, None, None)
        out = []
        for _ in range(60):
            fault = pump._draw()
            out.append((fault, pump.rng.randrange(1, 97) if fault == "partial" else None))
        return out

    for conn in range(4):
        for direction in ("c2s", "s2c"):
            got = draws(netchaos, spec, conn, direction)
            assert got == draws(jnetchaos, jspec, conn, direction)
            assert direction == "s2c" or all(f != "kill_ack" for f, _ in got)


def test_single_fault_spec_matches_jax():
    for fc in netchaos.NET_FAULT_CLASSES:
        assert (dataclasses.asdict(netchaos.single_fault_spec(7, fc, fault_rate=0.4))
                == dataclasses.asdict(jnetchaos.single_fault_spec(7, fc, fault_rate=0.4)))
    with pytest.raises(ValueError):
        netchaos.single_fault_spec(7, "meteor")


def _trajectory(wal):
    """Each job name's (state, realized, total) from the journal; a second
    admission of a name fails."""
    out = {}
    for j in dur.replay_service_state(wal).jobs.values():
        assert j.task not in out, f"duplicate admission for {j.task}"
        out[j.task] = (j.state, j.realized, j.total_batches)
    return out


def _job_mix(n=6):
    return [(f"mix-{i}", 3 + (i % 3)) for i in range(n)]


def _run_in_process(wal, mix):
    tech = F.RecordingTech()
    svc = _service(tech, wal=wal)
    try:
        client = service.ServiceClient(svc)
        ids = [client.submit(F.FakeTask(name, total, SPEC["sizes"], tech, pbt=0.004),
                             spec={"sizes": SPEC["sizes"]}) for name, total in mix]
        for jid in ids:
            assert client.wait(jid, timeout=60)["state"] == "DONE"
    finally:
        svc.stop(timeout=60)
    return _trajectory(wal)


def _run_through_chaos(wal, mix, spec):
    svc = _service(F.RecordingTech(), wal=wal)
    gw = service.GatewayServer(svc).start()
    try:
        with netchaos.NetChaosProxy(*gw.address, spec) as px:
            with service.GatewayClient(*px.address, seed=spec.seed, timeout_s=5.0,
                                       max_attempts=10) as c:
                ids = [c.submit(name=name, total_batches=total, spec=SPEC)
                       for name, total in mix]
                for jid in ids:
                    assert c.wait(jid, timeout=90)["state"] == "DONE", jid
            stats = px.stats
    finally:
        gw.shutdown(reason="campaign")
        svc.stop(timeout=60)
    return _trajectory(wal), stats


def test_a_short_seeded_campaign_loses_and_duplicates_nothing(tmp_path):
    """Seed 11, ``kill_ack`` then ``dup``: each chaos run's trajectory is the
    in-process reference's, and each class was injected."""
    mix = _job_mix(4)
    reference = _run_in_process(str(tmp_path / "ref"), mix)
    assert all(st == "DONE" and r >= t for st, r, t in reference.values())
    for fc in ("kill_ack", "dup"):
        spec = netchaos.single_fault_spec(seed=11, fault_class=fc, max_faults_per_conn=2)
        trajectory, stats = _run_through_chaos(str(tmp_path / fc), mix, spec)
        assert trajectory == reference, fc
        assert stats.injected.get(fc, 0) > 0, (fc, stats.injected)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 23, 47])
def test_netchaos_campaign_zero_lost_zero_duplicated(seed, tmp_path):
    mix = _job_mix()
    reference = _run_in_process(str(tmp_path / "ref"), mix)
    injected = {}
    for fc in ("drop", "dup", "partial", "kill_ack"):
        spec = netchaos.single_fault_spec(seed=seed, fault_class=fc, max_faults_per_conn=2)
        trajectory, stats = _run_through_chaos(str(tmp_path / f"chaos-{fc}"), mix, spec)
        assert trajectory == reference, fc
        for k, v in stats.injected.items():
            injected[k] = injected.get(k, 0) + v
    assert set(injected) == {"drop", "dup", "partial", "kill_ack"}, injected


@pytest.mark.slow
def test_netchaos_mixed_faults_with_gateway_kill_and_restart(tmp_path):
    mix = _job_mix(5)
    reference = _run_in_process(str(tmp_path / "ref"), mix)
    wal = str(tmp_path / "chaos")
    spec = netchaos.NetChaosSpec(seed=31, fault_rate=0.3, max_faults_per_conn=2)
    inj = res.CrashInjector("post-commit", hit=2, armed=True)
    svc = _service(F.RecordingTech(), wal=wal, barrier=inj.barrier, start=False)
    gw = service.GatewayServer(svc).start()
    survivors = {}
    keys = {name: f"camp:{name}" for name, _ in mix}
    with netchaos.NetChaosProxy(*gw.address, spec) as px:
        c = service.GatewayClient(*px.address, session="camp", seed=spec.seed, timeout_s=3.0,
                                  max_attempts=3, backoff_base_s=0.02)
        for name, total in mix:
            try:
                survivors[name] = c.submit(name=name, total_batches=total, spec=SPEC,
                                           dedup_key=keys[name])
            except service.GatewayError:
                pass  # lost to the kill: retried after the restart
        c.close()
    assert inj.fired.is_set() and gw.killed
    svc2 = _service(F.RecordingTech(), wal=wal)
    gw2 = service.GatewayServer(svc2).start()
    try:
        with netchaos.NetChaosProxy(*gw2.address, spec) as px2:
            with service.GatewayClient(*px2.address, session="camp", seed=spec.seed,
                                       timeout_s=5.0, max_attempts=10) as c2:
                for name, total in mix:
                    jid = c2.submit(name=name, total_batches=total, spec=SPEC,
                                    dedup_key=keys[name])
                    if name in survivors:
                        assert jid == survivors[name], name
                    assert c2.wait(jid, timeout=90)["state"] == "DONE", name
    finally:
        gw2.shutdown(reason="campaign")
        svc2.stop(timeout=60)
    assert _trajectory(wal) == reference


# ---------------------------------------------------------------- end to end
SEQ, BATCH, N_BATCHES = 16, 2, 4
NAMES = (("gw-tiny-a", 1e-3, 1.0), ("gw-tiny-b", 2e-3, 0.0))
_JAX_INIT = {}


def _jax_init_state_dict():
    if "sd" not in _JAX_INIT:
        import jax

        params = j_build_gpt2("test-tiny", seq_len=SEQ).init_fn(jax.random.PRNGKey(0))
        _JAX_INIT["sd"] = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return _JAX_INIT["sd"]


def _spec(**kw):
    spec = build_gpt2("test-tiny", seq_len=SEQ, **kw)
    sd = _jax_init_state_dict()

    def init_fn(generator=None, device=None):
        model = spec.meta_init_fn().to_empty(device=device or "cpu")
        model.load_state_dict(sd)
        return model

    return dataclasses.replace(spec, init_fn=init_fn)


def test_tiny_jobs_through_both_gateways(tmp_path, monkeypatch):
    """The same two tiny GPT-2 jobs submitted over each package's gateway,
    the first submitted twice with one dedup key: the same answers, job
    states, journaled progress and dedup tables, and final losses within
    TRAJ_TOL of the JAX package's."""
    import jax
    import jax.numpy as jnp

    from saturn_tpu.ops import ce as jce

    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))
    monkeypatch.setattr(sat.Task, "apply_realized_feedback", lambda self: None)
    monkeypatch.setattr(JTask, "apply_realized_feedback", lambda self: None)
    tech, jtech = DataParallel(), JDataParallel()
    built = {}

    def provide_torch(payload):
        t = sat.Task(get_model=_spec,
                     get_dataloader=lambda: make_lm_dataset(
                         context_length=SEQ, batch_size=BATCH, vocab_size=256,
                         n_tokens=SEQ * BATCH * N_BATCHES),
                     loss_fn=pretraining_loss,
                     hparams=sat.HParams(lr=payload["spec"]["lr"], batch_count=N_BATCHES,
                                         kwargs={"dtype": torch.float32}),
                     name=payload["task"], save_dir=str(tmp_path / "ck"))
        t.strategies = {1: sat.Strategy(tech, 1, {"remat": False}, 1.0 * N_BATCHES, 1.0)}
        built[t.name] = t
        return t

    def provide_jax(payload):
        t = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", seq_len=SEQ,
                                                      dtype=jnp.float32, **kw),
                  get_dataloader=lambda: j_make_lm_dataset(
                      context_length=SEQ, batch_size=BATCH, vocab_size=256,
                      n_tokens=SEQ * BATCH * N_BATCHES),
                  loss_fn=j_pretraining_loss,
                  hparams=JHParams(lr=payload["spec"]["lr"], batch_count=N_BATCHES),
                  name=payload["task"], save_dir=str(tmp_path / "jck"))
        t.strategies = {1: JStrategy(jtech, 1, {}, 1.0 * N_BATCHES, 1.0)}
        return t

    def run(pkg, topology, provider, wal, mpath):
        p = PKGS[pkg]
        svc = p.Service(topology=topology, interval=10.0, solver_time_limit=2.0, poll_s=0.02,
                        durability_dir=wal, task_provider=provider, metrics_path=mpath,
                        health_guardian=False)
        gw = p.GatewayServer(svc).start()
        try:
            with p.GatewayClient(*gw.address, seed=21) as c:
                # both submitted before the loop starts: one drain, one plan
                ids = [c.submit(name=n, total_batches=N_BATCHES, priority=prio,
                                spec={"lr": lr}, dedup_key=f"k-{n}")
                       for n, lr, prio in NAMES]
                svc.start()
                again = c.submit(name=NAMES[0][0], total_batches=N_BATCHES,
                                 spec={"lr": NAMES[0][1]}, dedup_key=f"k-{NAMES[0][0]}")
                outs = [c.wait(j, timeout=300) for j in ids]
        finally:
            gw.shutdown(reason="test")
            svc.stop(timeout=120)
        progress = {}
        for r in p.replay(wal, strict=True):
            if r["kind"] == "task_progress":
                progress[r["data"]["task"]] = progress.get(r["data"]["task"], 0) + \
                    r["data"]["batches"]
        return ids, again, [o["state"] for o in outs], progress, \
            p.replay_service_state(wal).dedup

    got = run("torch", SliceTopology([torch.device("cpu")]), provide_torch,
              str(tmp_path / "wal"), str(tmp_path / "m.jsonl"))
    jmpath = str(tmp_path / "jm.jsonl")
    want = run("jax", JSliceTopology(jax.devices()[:1]), provide_jax, str(tmp_path / "jwal"),
               jmpath)
    assert got == want
    ids, again, states, progress, _ = got
    assert again == ids[0] and states == ["DONE", "DONE"]
    assert progress == {n: N_BATCHES for n, _, _ in NAMES}
    jlast = {e["task"]: e["loss"] for e in j_read_events(jmpath, kind="task_interval")}
    losses = [built[n].last_losses[-1] for n, _, _ in NAMES]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, [jlast[n] for n, _, _ in NAMES], rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)
