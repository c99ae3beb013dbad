"""The port's digital twin (``saturn_tpu_torch/twin/``) and its ``twin``
subcommand against the JAX package's (the cases of ``tests/test_twin.py``).

- The virtual clock and event queue, the arrivals (draw for draw against
  the JAX generator, with and without a tenant mix), the reconciled journal
  replay.
- Determinism: a synth campaign (30 jobs, seed 11) and the seeded storm
  (``STORM_CFG``) give the same ``events.jsonl`` and ``ledger.json`` over
  three runs, and the same bytes as the JAX twin; other seeds diverge; a
  dedup retry storm collapses through the real gateway's table.
- Fidelity: a campaign's own journal replays within ``DEFAULT_BAND``; a
  JAX twin's journal loads to the same trace in both packages; a journal
  of the port's ``SaturnService`` (tiny jobs, one cancelled) replays
  within the band; the band's edges.
- What-if and the CLI (``python -m saturn_tpu_torch.analysis twin``): the
  same JSON as the JAX CLI for the same arguments.

The cases of ``tests/test_twin.py`` that read ``benchmarks/`` (the
gateway bench's generator, the bench guard's twin row, the slow
real-service phase) have no counterpart: the port has no benchmark; the
real-service case here takes the last one's place.

Tolerances: none; events, ledgers and CLI output are compared as bytes or
JSON. Solver budgets are 30 real seconds (``SAFE_SOLVE_S``): the tier
ladder races ``time.perf_counter``, which the twin leaves unpatched, so
bytes repeat only when every tier it tries finishes inside its budget.
"""

import json
import os
import threading
import time
import timeit
import zlib

import pytest
import torch

from saturn_tpu.analysis.cli import main as j_cli_main
from saturn_tpu.twin import arrivals as j_arrivals
from saturn_tpu.twin import runner as j_runner
from saturn_tpu.twin import trace as j_trace
from saturn_tpu_torch.analysis.cli import main
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.core.strategy import Strategy
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.durability import journal as jmod
from saturn_tpu_torch.service import SaturnService
from saturn_tpu_torch.service.queue import JobRequest
from saturn_tpu_torch.twin.arrivals import BURST_EVERY, BURST_LEN, arrival_stream
from saturn_tpu_torch.twin.clock import EventQueue, VirtualClock
from saturn_tpu_torch.twin.runner import CampaignConfig, run_campaign, run_what_if
from saturn_tpu_torch.twin.trace import DEFAULT_BAND, fidelity_compare, load_trace, tier_shares

pytestmark = pytest.mark.twin


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    # the tier-1 partition width of the JAX suite: every MILP the campaigns
    # make proves optimality in milliseconds, so no incumbent depends on
    # the wall clock
    monkeypatch.setenv("SATURN_TPU_PARTITION_MAX", "4")
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG",
                 "SATURN_TPU_HBM_BYTES", "SATURN_TPU_GROW_POLL", "SATURN_TPU_GROW_HYSTERESIS"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the real-clock solver budget: every tier the ladder tries must finish
SAFE_SOLVE_S = 30.0

#: the JAX suite's seeded storm (topology changes, transient crashes,
#: preemption requeues and one spent retry budget all fire)
STORM_CFG = dict(
    n_jobs=24, n_slices=2, interval_s=12.0, total_batches=6,
    solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=3, storm=True,
    storm_p_preempt=0.6, storm_p_crash=0.5, storm_p_straggler=0.3,
    outage_intervals=1, max_intervals=80,
)
SYNTH_CFG = dict(n_jobs=30, n_slices=2, interval_s=60.0, solve_deadline_s=SAFE_SOLVE_S,
                 metrics=False, seed=11)


def _campaign_bytes(out_dir):
    """The determinism contract: the event log and the verdict ledger."""
    out = {}
    for fn in ("events.jsonl", "ledger.json"):
        with open(os.path.join(out_dir, fn), "rb") as fh:
            out[fn] = fh.read()
    return out


# --------------------------------------------------------------------------
# virtual clock and event queue
# --------------------------------------------------------------------------
class TestVirtualClock:
    def test_patch_swaps_and_restores_time_sources(self):
        real_time = time.time
        real_mono = time.monotonic
        with VirtualClock(start=100.0).patch() as clk:
            assert time.time() == 100.0
            assert time.monotonic() == 100.0
            assert timeit.default_timer() == 100.0
            time.sleep(5.5)  # advances instead of blocking
            assert time.time() == 105.5
            assert clk.now() == 105.5
        assert time.time is real_time
        assert time.monotonic is real_mono
        assert time.time() > 1e9  # back on the epoch clock

    def test_perf_counter_stays_real_under_patch(self):
        with VirtualClock().patch():
            a = time.perf_counter()
            for _ in range(10_000):
                pass
            assert time.perf_counter() >= a
            assert time.perf_counter() != time.time()

    def test_advance_contract(self):
        clk = VirtualClock(start=10.0)
        with pytest.raises(ValueError):
            clk.advance(-1.0)
        assert clk.advance_to(5.0) == 10.0   # never goes backwards
        assert clk.advance_to(12.0) == 12.0
        clk.sleep(-3.0)                       # clamps like time.sleep
        assert clk.now() == 12.0

    def test_restores_on_exception(self):
        real_time = time.time
        with pytest.raises(RuntimeError):
            with VirtualClock().patch():
                raise RuntimeError("boom")
        assert time.time is real_time

    def test_event_queue_breaks_ties_by_insertion_order(self):
        q = EventQueue()
        q.push(2.0, "b")
        q.push(1.0, "tie-first")
        q.push(1.0, "tie-second")
        assert q.peek_time() == 1.0
        assert len(q) == 3 and not q.empty
        due = q.pop_due(1.0)
        assert [k for _, k, _ in due] == ["tie-first", "tie-second"]
        assert q.pop_due(5.0) == [(2.0, "b", None)]
        assert q.empty


# --------------------------------------------------------------------------
# arrivals
# --------------------------------------------------------------------------
class TestArrivals:
    def test_deterministic_across_calls(self):
        a = arrival_stream(200, base_rate_hz=12.0, burst_rate_hz=80.0, seed=7)
        b = arrival_stream(200, base_rate_hz=12.0, burst_rate_hz=80.0, seed=7)
        assert a == b
        assert a != arrival_stream(200, base_rate_hz=12.0, burst_rate_hz=80.0, seed=8)

    def test_diurnal_burst_shape(self):
        trace = arrival_stream(BURST_EVERY + 5, base_rate_hz=2.0, burst_rate_hz=50.0, seed=1)
        assert all(t.in_burst for t in trace[:BURST_LEN])
        assert not any(t.in_burst for t in trace[BURST_LEN:BURST_EVERY])
        assert all(t.in_burst for t in trace[BURST_EVERY:])
        offsets = [t.at_s for t in trace]
        assert offsets == sorted(offsets)
        assert all(t.priority in (0.0, 1.0, 2.0) for t in trace)

    def test_rejects_nonsense(self):
        with pytest.raises(ValueError):
            arrival_stream(-1, base_rate_hz=1.0, burst_rate_hz=1.0)
        with pytest.raises(ValueError):
            arrival_stream(1, base_rate_hz=0.0, burst_rate_hz=1.0)
        with pytest.raises(ValueError):
            arrival_stream(1, base_rate_hz=1.0, burst_rate_hz=1.0, burst_every=0)
        with pytest.raises(ValueError):
            arrival_stream(1, base_rate_hz=1.0, burst_rate_hz=1.0, tenant_mix={"a": 0.0})

    @pytest.mark.parametrize("seed", [0, 7, 1234])
    @pytest.mark.parametrize("tenant_mix", [None, {"acme": 10.0, "solo": 1.0}],
                             ids=["no-tenants", "tenants"])
    def test_draw_for_draw_against_jax(self, seed, tenant_mix):
        kw = dict(base_rate_hz=12.0, burst_rate_hz=80.0, seed=seed, tenant_mix=tenant_mix)
        got = arrival_stream(130, **kw)
        want = j_arrivals.arrival_stream(130, **kw)
        assert [tuple(vars(a).values()) for a in got] == [tuple(vars(a).values())
                                                          for a in want]
        assert (BURST_EVERY, BURST_LEN) == (j_arrivals.BURST_EVERY, j_arrivals.BURST_LEN)
        if tenant_mix is None:
            assert all(a.tenant is None for a in got)
        else:  # the tenant draws leave the trace itself as it was
            plain = arrival_stream(130, **dict(kw, tenant_mix=None))
            assert [(a.at_s, a.priority) for a in got] == [(a.at_s, a.priority)
                                                          for a in plain]


# --------------------------------------------------------------------------
# reconciled journal replay
# --------------------------------------------------------------------------
def _write_segment(root, index, records):
    """A hand-built CRC-valid journal segment: records = [(seq, data)]."""
    lines = []
    for seq, data in records:
        body = {"seq": seq, "ts": float(seq), "kind": "job_state", "data": data}
        crc = format(zlib.crc32(json.dumps(body, sort_keys=True, separators=(",", ":"),
                                           default=str).encode("utf-8")), "08x")
        body["crc"] = crc
        lines.append(json.dumps(body, sort_keys=True, separators=(",", ":"), default=str))
    path = os.path.join(root, f"wal-{index:06d}.jsonl")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


class TestReplayReconciled:
    def test_overlapping_incarnations_merge_latest_wins(self, tmp_path):
        root = str(tmp_path)
        _write_segment(root, 0, [(s, {"inc": 0, "seq": s}) for s in (1, 2, 3)])
        _write_segment(root, 1, [(s, {"inc": 0, "seq": s}) for s in (4, 5, 6)])
        # incarnation 1 restarted from an older durable cut: it re-uses
        # seqs 4..6, then extends the history to 8
        _write_segment(root, 2, [(s, {"inc": 1, "seq": s}) for s in (4, 5, 6, 7, 8)])
        strict = jmod.replay(root)
        assert [r["seq"] for r in strict] == [1, 2, 3, 4, 5, 6]
        assert all(r["data"]["inc"] == 0 for r in strict)
        merged = jmod.replay_reconciled(root)
        assert [r["seq"] for r in merged] == [1, 2, 3, 4, 5, 6, 7, 8]
        by_seq = {r["seq"]: r["data"]["inc"] for r in merged}
        assert by_seq == {1: 0, 2: 0, 3: 0, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1}

    def test_single_incarnation_matches_strict_replay(self, tmp_path):
        root = str(tmp_path)
        _write_segment(root, 0, [(s, {"inc": 0}) for s in (1, 2)])
        _write_segment(root, 1, [(s, {"inc": 0}) for s in (3, 4)])
        assert jmod.replay_reconciled(root) == jmod.replay(root)

    def test_corrupt_record_is_skipped_not_fatal(self, tmp_path):
        root = str(tmp_path)
        _write_segment(root, 0, [(s, {"inc": 0}) for s in (1, 2, 3)])
        with open(os.path.join(root, "wal-000000.jsonl"), "a") as fh:
            fh.write("{torn garbage\n")
        assert [r["seq"] for r in jmod.replay_reconciled(root)] == [1, 2, 3]


# --------------------------------------------------------------------------
# campaign determinism, and the same bytes as the JAX twin
# --------------------------------------------------------------------------
class TestCampaignDeterminism:
    def _run_n(self, cfg, tmp_path, n=3):
        outs = []
        for i in range(n):
            d = str(tmp_path / f"run{i}")
            summary = run_campaign(cfg, d)
            outs.append((summary, _campaign_bytes(d)))
        return outs

    def test_synth_campaign_bit_identical_across_3_runs(self, tmp_path):
        outs = self._run_n(CampaignConfig(**SYNTH_CFG), tmp_path)
        blobs = [b for _, b in outs]
        assert blobs[0]["events.jsonl"]  # a non-trivial log
        assert blobs[0] == blobs[1] == blobs[2]
        summary = outs[0][0]
        assert summary["status"] == "ok"
        assert summary["completed"] == 30
        assert summary["deadline_misses"] == 0
        # wall_s lives only in the summary, the one field that does not repeat
        assert "wall_s" not in json.loads(blobs[0]["ledger.json"])

    def test_storm_campaign_bit_identical_and_chaotic(self, tmp_path):
        cfg = CampaignConfig(**STORM_CFG)
        outs = self._run_n(cfg, tmp_path)
        blobs = [b for _, b in outs]
        assert blobs[0] == blobs[1] == blobs[2]
        summary = outs[0][0]
        assert summary["status"] == "ok"
        assert summary["deadline_misses"] == 0
        assert summary["topology_changes"] >= 2
        assert summary["preemption_requeues"] > 0
        assert summary["crashes"] > 0
        assert summary["completed"] + summary["failed"] == cfg.n_jobs
        kinds = {json.loads(line)["kind"]
                 for line in blobs[0]["events.jsonl"].decode().splitlines()}
        assert {"topology_change", "task_preempted", "solve", "job_completed"} <= kinds

    def test_different_seed_diverges(self, tmp_path):
        base = dict(n_jobs=16, n_slices=2, interval_s=60.0, solve_deadline_s=SAFE_SOLVE_S,
                    metrics=False)
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        run_campaign(CampaignConfig(seed=1, **base), a)
        run_campaign(CampaignConfig(seed=2, **base), b)
        assert _campaign_bytes(a)["events.jsonl"] != _campaign_bytes(b)["events.jsonl"]

    def test_dedup_retry_storm_collapses_idempotently(self, tmp_path):
        cfg = CampaignConfig(n_jobs=25, n_slices=2, interval_s=60.0,
                             solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=5,
                             dedup_every=5)
        summary = run_campaign(cfg, str(tmp_path / "dedup"))
        assert summary["duplicates"] == (cfg.n_jobs - 1) // cfg.dedup_every
        assert summary["submitted"] == cfg.n_jobs - summary["duplicates"]
        assert summary["completed"] == summary["submitted"]

    @pytest.mark.parametrize("cfg", [SYNTH_CFG, STORM_CFG], ids=["synth", "storm"])
    def test_same_bytes_as_the_jax_twin(self, cfg, tmp_path):
        """No field is masked: the port's events and ledger are the JAX
        twin's, and so is the trace either package loads from the JAX
        twin's journal."""
        mine, theirs = str(tmp_path / "torch"), str(tmp_path / "jax")
        got = run_campaign(CampaignConfig(**cfg), mine)
        want = j_runner.run_campaign(j_runner.CampaignConfig(**cfg), theirs)
        assert _campaign_bytes(mine) == _campaign_bytes(theirs)
        drop = ("wall_s", "sim_speedup", "out_dir", "metrics_path")
        assert ({k: v for k, v in got.items() if k not in drop}
                == {k: v for k, v in want.items() if k not in drop})
        for journal in (os.path.join(theirs, "journal"), os.path.join(mine, "journal")):
            t, jt = load_trace(journal), j_trace.load_trace(journal)
            assert [tuple(vars(j).values()) for j in t.jobs] == [tuple(vars(j).values())
                                                                  for j in jt.jobs]
            assert (t.admission_mix, t.incarnations, t.span_s, t.verdict_shares) == \
                (jt.admission_mix, jt.incarnations, jt.span_s, jt.verdict_shares)
            assert len(t.jobs) == got["submitted"]


# --------------------------------------------------------------------------
# fidelity: twin journals are replayable traces; replays land in the band
# --------------------------------------------------------------------------
class TestReplayFidelity:
    def test_campaign_journal_replays_within_band(self, tmp_path):
        cfg = CampaignConfig(n_jobs=20, n_slices=2, interval_s=30.0,
                             solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=9)
        a_dir = str(tmp_path / "original")
        a = run_campaign(cfg, a_dir)
        journal_dir = os.path.join(a_dir, "journal")
        trace = load_trace(journal_dir)
        assert len(trace.jobs) == a["submitted"]
        assert set(trace.admission_mix) <= {"admit", "defer", "reject"}
        offsets = [j.at_s for j in trace.jobs]
        assert offsets == sorted(offsets) and offsets[0] == 0.0
        b_cfg = CampaignConfig(trace_dir=journal_dir, n_slices=2, interval_s=30.0,
                               solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=9)
        b = run_campaign(b_cfg, str(tmp_path / "replay"))
        assert b["status"] == "ok"
        assert b["completed"] == a["completed"]
        cmp = fidelity_compare(
            {"tier_shares": b["tier_shares"], "verdict_shares": b["verdict_shares"],
             "makespan_s": b["makespan_s"]},
            {"tier_shares": a["tier_shares"], "verdict_shares": a["verdict_shares"],
             "makespan_s": a["makespan_s"]})
        assert cmp["within_band"], cmp

    def test_fidelity_compare_band_edges(self):
        flat = {"tier_shares": {"1": 1.0}, "verdict_shares": {"admit": 1.0},
                "makespan_s": 10.0}
        assert fidelity_compare(flat, dict(flat))["within_band"]
        drifted = dict(flat, tier_shares={"2": 1.0})
        out = fidelity_compare(drifted, flat)
        assert not out["within_band"]
        assert out["tier_share_deltas"] == {"1": 1.0, "2": 1.0}
        slow = dict(flat, makespan_s=10.0 * DEFAULT_BAND["makespan_ratio"][1] * 1.5)
        assert not fidelity_compare(slow, flat)["within_band"]
        empty = {"tier_shares": {}, "verdict_shares": {}, "makespan_s": 0.0}
        assert fidelity_compare(empty, dict(empty))["within_band"]
        for twin, real in ((drifted, flat), (slow, flat), (flat, flat), (empty, empty)):
            assert fidelity_compare(twin, real) == j_trace.fidelity_compare(twin, real)
        assert DEFAULT_BAND == j_trace.DEFAULT_BAND


class _SleepTech(BaseTechnique):
    """Sleeps per batch, a stand-in for device work."""

    name = "twin-fidelity"

    def __init__(self, per_batch):
        self.per_batch = per_batch

    def execute(self, task, devices, tid, override_batch_count=None):
        time.sleep(self.per_batch * (override_batch_count or 1))

    def search(self, task, devices, tid):
        return {}, self.per_batch


class _SleepTask:
    def __init__(self, name, total_batches, sizes, tech):
        self.name = name
        self.total_batches = total_batches
        self.current_batch = 0
        self.epoch_length = 1000
        self.hints = {}
        self.chip_range = None
        p = tech.per_batch
        self.strategies = {g: Strategy(tech, g, {}, p * total_batches, p) for g in sizes}
        self.selected_strategy = None

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}

    def select_strategy(self, g):
        self.selected_strategy = self.strategies[g]

    def reconfigure(self, n):
        self.current_batch = (self.current_batch + n) % self.epoch_length


def test_port_service_journal_replays_within_band(tmp_path):
    """A real ``SaturnService`` (the port's loop, engine and journal) runs
    tiny jobs arriving over time, one of them cancelled while it runs; the
    twin replays its journal in trace mode within ``DEFAULT_BAND``, with
    each journaled submission once, and the CLI agrees."""
    per_batch, interval = 0.004, 0.2
    tech = _SleepTech(per_batch)
    wal, metrics_path = str(tmp_path / "wal"), str(tmp_path / "metrics.jsonl")
    svc = SaturnService(topology=SliceTopology([torch.device("cpu")] * 8), interval=interval,
                        poll_s=0.02, durability_dir=wal, metrics_path=metrics_path,
                        health_guardian=False, technique_names=["twin-fidelity"])
    svc.start()
    spec = {"sizes": [2, 4]}
    recs = []
    try:
        for i in range(8):
            batches = 160 if i == 3 else 80  # the one cancelled runs for 4 intervals
            recs.append(svc.queue.submit(JobRequest(task=_SleepTask(f"real-{i}", batches,
                                                                    [2, 4], tech),
                                                    priority=float(i % 3), spec=spec)))
            time.sleep(0.05)
        deadline = time.monotonic() + 30
        while recs[3].state.value != "RUNNING" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.queue.cancel(recs[3].job_id)
        states = [svc.queue.wait(r.job_id, timeout=60).state.value for r in recs]
    finally:
        svc.stop(timeout=60)
    assert states == ["DONE"] * 3 + ["EVICTED"] + ["DONE"] * 4

    trace = load_trace(wal)
    assert [j.name for j in trace.jobs] == [f"real-{i}" for i in range(8)]
    assert [tuple(vars(j).values()) for j in trace.jobs] == \
        [tuple(vars(j).values()) for j in j_trace.load_trace(wal).jobs]
    out_dir = str(tmp_path / "twin")
    # the service's own solve budget (interval / 2): the tier mix is a race
    # against it on both sides
    twin = run_campaign(CampaignConfig(trace_dir=wal, n_slices=1, chips_per_slice=8,
                                       interval_s=interval, solve_deadline_s=interval / 2,
                                       flat_per_batch_s=per_batch, metrics=False, seed=0),
                        out_dir)
    assert twin["status"] == "ok" and twin["submitted"] == 8 and twin["duplicates"] == 0
    submitted = [json.loads(line)["task"] for line in open(os.path.join(out_dir, "events.jsonl"))
                 if json.loads(line)["kind"] == "admission"]
    assert sorted(submitted) == [f"real-{i}" for i in range(8)]
    real = {"tier_shares": tier_shares(metrics_path), "verdict_shares": trace.verdict_shares,
            "makespan_s": _journal_makespan(wal)}
    cmp = fidelity_compare({"tier_shares": twin["tier_shares"],
                            "verdict_shares": twin["verdict_shares"],
                            "makespan_s": twin["makespan_s"]}, real)
    assert cmp["within_band"], (cmp, real, twin)


def _journal_makespan(wal):
    from saturn_tpu_torch.analysis.cli import _twin_journal_makespan

    return _twin_journal_makespan(wal, 0.0)


# --------------------------------------------------------------------------
# capacity what-if
# --------------------------------------------------------------------------
class TestWhatIf:
    def test_relaxing_deadlines_attributably_reduces_evictions(self, tmp_path):
        base = CampaignConfig(n_jobs=24, n_slices=2, interval_s=30.0, deadline_s=35.0,
                              solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=7)
        verdict = run_what_if(base, str(tmp_path))
        cmp = verdict["comparison"]
        assert set(cmp) == {"base", "add-slice", "relax-deadlines"}
        assert cmp["base"]["evicted"] > 0
        assert cmp["relax-deadlines"]["evicted"] < cmp["base"]["evicted"]
        assert cmp["relax-deadlines"]["completed"] > cmp["base"]["completed"]
        with open(os.path.join(str(tmp_path), "whatif.json")) as fh:
            assert json.load(fh)["comparison"] == cmp


# --------------------------------------------------------------------------
# the operator surface: python -m saturn_tpu_torch.analysis twin
# --------------------------------------------------------------------------
class TestTwinCLI:
    @pytest.fixture()
    def campaign_dir(self, tmp_path):
        d = str(tmp_path / "campaign")
        run_campaign(CampaignConfig(n_jobs=15, n_slices=2, interval_s=30.0,
                                    solve_deadline_s=SAFE_SOLVE_S, metrics=False, seed=13), d)
        return d

    def test_inspect_human_and_json(self, campaign_dir, capsys):
        assert main(["twin", campaign_dir]) == 0
        out = capsys.readouterr().out
        assert "twin campaign ok" in out
        assert "admission:" in out and "solver:" in out
        assert main(["--json", "twin", campaign_dir]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["status"] == "ok"
        assert payload["completed"] == 15
        assert payload["deadline_misses"] == 0
        assert payload["tier_counts"]

    def test_fidelity_deltas_against_own_journal(self, campaign_dir, capsys):
        rc = main(["--json", "twin", campaign_dir,
                   "--trace", os.path.join(campaign_dir, "journal")])
        assert rc == 0
        fid = json.loads(capsys.readouterr().out)["fidelity"]
        assert fid["within_band"] is True
        assert all(v <= DEFAULT_BAND["verdict_share_delta"]
                   for v in fid["verdict_share_deltas"].values())

    def test_run_synth_through_cli(self, tmp_path, capsys):
        d = str(tmp_path / "via-cli")
        rc = main(["--json", "twin", d, "--run", "synth", "--jobs", "12", "--slices", "2",
                   "--interval", "30", "--solve-deadline", str(SAFE_SOLVE_S)])
        assert rc == 0
        assert json.loads(capsys.readouterr().out)["submitted"] == 12
        for fn in ("events.jsonl", "ledger.json", "summary.json"):
            assert os.path.exists(os.path.join(d, fn))

    def test_run_storm_through_cli_is_deterministic(self, tmp_path, capsys):
        dirs = [str(tmp_path / "s1"), str(tmp_path / "s2")]
        payloads = []
        for d in dirs:
            rc = main(["--json", "twin", d, "--run", "storm", "--jobs", "10", "--slices", "2",
                       "--interval", "30", "--seed", "3",
                       "--solve-deadline", str(SAFE_SOLVE_S)])
            assert rc == 0
            payloads.append(json.loads(capsys.readouterr().out))
        assert payloads[0] == payloads[1]
        assert _campaign_bytes(dirs[0]) == _campaign_bytes(dirs[1])
        assert os.path.isdir(os.path.join(dirs[0], "journal"))

    def test_run_whatif_through_cli(self, tmp_path, capsys):
        d = str(tmp_path / "whatif-cli")
        rc = main(["--json", "twin", d, "--run", "whatif", "--jobs", "12", "--slices", "2",
                   "--interval", "30", "--solve-deadline", str(SAFE_SOLVE_S)])
        assert rc == 0
        payload = json.loads(capsys.readouterr().out)
        assert set(payload["whatif"]) == {"base", "add-slice", "relax-deadlines"}
        assert main(["--json", "twin", d]) == 0
        assert json.loads(capsys.readouterr().out)["whatif"] == payload["whatif"]

    def test_usage_errors(self, tmp_path, capsys):
        assert main(["twin", str(tmp_path / "nope")]) == 2
        assert main(["twin", str(tmp_path / "r"), "--run", "replay"]) == 2
        assert "requires --trace" in capsys.readouterr().err

    @pytest.mark.parametrize("run", ["synth", "storm", "replay", "whatif", None])
    def test_prints_the_jax_cli_json(self, run, campaign_dir, tmp_path, capsys):
        args = ["--jobs", "10", "--slices", "2", "--interval", "30", "--seed", "3",
                "--solve-deadline", str(SAFE_SOLVE_S)]
        if run is not None:
            args += ["--run", run]
        if run in ("replay", None):
            args += ["--trace", os.path.join(campaign_dir, "journal")]
        out = []
        for pkg, cli in (("torch", main), ("jax", j_cli_main)):
            d = campaign_dir if run is None else str(tmp_path / pkg)
            assert cli(["--json", "twin", d] + args) == 0
            out.append(json.loads(capsys.readouterr().out))
        assert out[0] == out[1]
        if run == "whatif":
            assert set(out[0]["whatif"]) == {"base", "add-slice", "relax-deadlines"}
        else:
            assert out[0]["status"] == "ok" and out[0]["deadline_misses"] == 0
