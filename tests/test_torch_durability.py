"""The port's durability journal, batch recovery, crash harness and
``orchestrate(resume_dir=, crash_barrier=)`` against the JAX package.

- The journal's format: each package reads what the other wrote (strict
  replay, ``replay_batch_state``), and both write the same bytes for the
  same records.
- The JAX package's journal, injector and checkpoint cases
  (``tests/test_crash.py``), run on both packages where the format is
  shared, on the port's ``torch.save`` format where it is not.
- Resume on real tasks: the same journal records as the JAX package for one
  run of two tiny GPT-2 tasks; a kill at ``mid-interval`` after the
  checkpoint landed ends each task at exactly its total step, bitwise equal
  to an uninterrupted run (the JAX package's rule trains the lost interval's
  batches again on top); a NaN batch's quarantine replayed after a kill at
  ``post-rollback``.

Tolerances: none. Records, steps and tensors are compared exactly.
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu import durability as jdur
from saturn_tpu import resilience as jres
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.executor.orchestrator import orchestrate as j_orchestrate
from saturn_tpu.health import GuardianConfig as JGuardianConfig
from saturn_tpu.health import HungDispatchError as JHungDispatchError
from saturn_tpu.health import NumericFaultError as JNumericFaultError
from saturn_tpu.health import TrainingGuardian as JTrainingGuardian
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.solver import milp as jmilp
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu_torch import durability as dur
from saturn_tpu_torch import resilience as res
from saturn_tpu_torch.core.mesh import Block, SliceTopology
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.durability import journal as jmod
from saturn_tpu_torch.health import (
    GuardianConfig,
    HungDispatchError,
    NumericFaultError,
    TrainingGuardian,
)
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.utils import checkpoint as ckpt

CPU = [torch.device("cpu")]
MARK = 255  # a whole row of this token marks a poisoned batch


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    for name in ("SATURN_TPU_SENTINEL", "SATURN_TPU_SENTINEL_SPIKE",
                 "SATURN_TPU_SOLVE_DEADLINE", "SATURN_TPU_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {
    "torch": SimpleNamespace(Journal=dur.Journal, replay=dur.replay, recover=dur.recover,
                             JournalCorruptError=dur.JournalCorruptError,
                             replay_batch_state=dur.replay_batch_state,
                             CrashInjector=res.CrashInjector, SimulatedKill=res.SimulatedKill),
    "jax": SimpleNamespace(Journal=jdur.Journal, replay=jdur.replay, recover=jdur.recover,
                           JournalCorruptError=jdur.JournalCorruptError,
                           replay_batch_state=jdur.replay_batch_state,
                           CrashInjector=jres.CrashInjector, SimulatedKill=jres.SimulatedKill),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _fields(state):
    return {k: getattr(state, k) for k in ("progress", "completed", "failed", "plan",
                                           "checkpoints", "last_seq", "n_records",
                                           "quarantined", "detached")}


def _write_batch_journal(journal_cls, root):
    """Two incarnations' worth of batch records, rotated over small segments."""
    j = journal_cls(root, segment_max_bytes=400)
    j.log("recovery", replayed_seq=1, replayed_records=1, completed=0, remaining=2)
    j.append("plan_commit", interval=0, makespan=7.0,
             plan={"makespan": 7.0, "assignments": {"a": [1, 0, 1, 0.0, 3.0]},
                   "dependencies": {"a": []}, "coschedule": [], "fused": []})
    for name, n in (("a", 3), ("b", 2), ("a", 3)):
        j.append("task_progress", task=name, batches=n)
    j.append("ckpt_published", task="a", path="/ckpts/a.pt")
    j.append("health_quarantine", task="b", indices=[4, 2])
    j.append("task_completed", task="a")
    j.append("task_failed", task="c", error="RuntimeError('boom')")
    j.append("interval_commit", interval=0)
    j.commit()
    j.close()
    j = journal_cls(root, segment_max_bytes=400)
    j.log("task_progress", task="b", batches=5)
    j.close()


# ---------------------------------------------------------------- the format
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_each_package_reads_the_others_journal(tmp_path, writer, reader):
    root = str(tmp_path / "wal")
    _write_batch_journal(PKGS[writer].Journal, root)
    got = PKGS[reader].replay(root, strict=True)
    assert got == PKGS[writer].replay(root, strict=True)
    assert [r["seq"] for r in got] == list(range(1, len(got) + 1))
    assert len([n for n in os.listdir(root) if n.endswith(".jsonl")]) >= 2
    state = PKGS[reader].replay_batch_state(root)
    assert _fields(state) == _fields(PKGS[writer].replay_batch_state(root))
    assert state.progress == {"a": 6, "b": 7} and state.completed == ["a"]
    assert state.quarantined == {"b": [2, 4]} and state.failed == {"c": "RuntimeError('boom')"}


def test_both_packages_write_the_same_bytes(tmp_path, monkeypatch):
    """With the clock pinned, the same records give byte-identical segments."""
    monkeypatch.setattr(time, "time", lambda: 1754390400.1234567)
    for name in ("torch", "jax"):
        _write_batch_journal(PKGS[name].Journal, str(tmp_path / name))
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) >= 2
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# ---------------------------------------- the JAX package's journal cases
def case_rotation_and_seq_continuity(p, d):
    j = p.Journal(d, segment_max_bytes=512)
    j.log("job_submitted", job="j0001-a", task="a", total_batches=10)
    for _ in range(20):
        j.append("task_progress", task="a", job="j0001-a", batches=1)
    assert j.pending == 20
    j.commit()
    assert j.pending == 0
    j.close()
    assert len([n for n in os.listdir(d) if n.endswith(".jsonl")]) >= 2
    seqs = [r["seq"] for r in p.replay(d, strict=True)]
    assert seqs == list(range(1, len(seqs) + 1))
    # a new incarnation goes on in a fresh segment, whose header takes a seq
    j2 = p.Journal(d, segment_max_bytes=512)
    s = j2.log("recovery")
    assert s == seqs[-1] + 2
    j2.close()
    assert p.replay(d, strict=True)[-1]["seq"] == s


def case_uncommitted_records_die(p, d):
    j = p.Journal(d)
    j.log("a")
    j.append("b")  # never committed: the process dies here
    assert [r["kind"] for r in p.replay(d, strict=True)] == ["segment_open", "a"]


def case_torn_tail_quarantined(p, d):
    j = p.Journal(d)
    j.log("a")
    j.log("b")
    j.close()
    seg = os.path.join(d, "wal-000001.jsonl")
    with open(seg, "ab") as f:
        f.write(b'{"crc":"00000000","data":{},"ki')
    with pytest.raises(p.JournalCorruptError):
        p.replay(d, strict=True)
    j2 = p.Journal(d)
    assert j2.recovery_report["quarantined"] == [seg + ".corrupt"]
    assert os.path.exists(seg + ".corrupt")
    j2.log("c")
    j2.close()
    kinds = [r["kind"] for r in p.replay(d, strict=True) if r["kind"] != "segment_open"]
    assert kinds == ["a", "b", "c"]


def case_mid_sequence_corruption_rolls_back(p, d):
    j = p.Journal(d, segment_max_bytes=256)
    for i in range(12):
        j.log("rec", i=i)
    j.close()
    segs = sorted(n for n in os.listdir(d) if n.endswith(".jsonl"))
    assert len(segs) >= 3
    victim = os.path.join(d, segs[1])
    raw = open(victim, "rb").read()
    open(victim, "wb").write(raw[: len(raw) // 2] + b"XXXX" + raw[len(raw) // 2 + 4:])
    report = p.recover(d)
    assert len(report["quarantined"]) >= 2  # the victim's tail and every later segment
    datas = [r["data"]["i"] for r in p.replay(d, strict=True) if r["kind"] == "rec"]
    assert datas == list(range(len(datas)))


def case_crc_catches_bit_rot(p, d):
    j = p.Journal(d)
    j.log("x", payload="hello")
    j.close()
    seg = os.path.join(d, "wal-000001.jsonl")
    raw = open(seg, "rb").read()
    open(seg, "wb").write(raw.replace(b"hello", b"jello"))
    assert all(r["kind"] != "x" for r in p.replay(d))


def case_injector_fires_on_exact_hit(p, d):
    inj = p.CrashInjector("post-commit", hit=2)
    j = p.Journal(d, barrier=inj.barrier)
    j.log("a")
    with pytest.raises(p.SimulatedKill):
        j.log("b")
    assert inj.fired.is_set()
    j.log("c")  # inert once fired
    assert p.replay(d, strict=True)[-1]["kind"] == "c"


def case_mid_fsync_kill_tears_the_tail(p, d):
    inj = p.CrashInjector("mid-fsync", hit=1, armed=False)
    j = p.Journal(d, barrier=inj.barrier)
    j.log("a")
    inj.arm()
    with pytest.raises(p.SimulatedKill):
        j.log("b", payload="x" * 64)
    assert p.recover(d)["quarantined"]
    kinds = [r["kind"] for r in p.replay(d, strict=True) if r["kind"] != "segment_open"]
    assert kinds == ["a"]


def case_seeded_is_deterministic(p, d):
    a = p.CrashInjector.seeded(1234, armed=False)
    b = p.CrashInjector.seeded(1234, armed=False)
    assert (a.point, a.hit) == (b.point, b.hit)
    draws = {(c.point, c.hit) for c in (p.CrashInjector.seeded(s, armed=False)
                                        for s in range(20))}
    assert len(draws) > 1


JOURNAL_CASES = [case_rotation_and_seq_continuity, case_uncommitted_records_die,
                 case_torn_tail_quarantined, case_mid_sequence_corruption_rolls_back,
                 case_crc_catches_bit_rot, case_injector_fires_on_exact_hit,
                 case_mid_fsync_kill_tears_the_tail, case_seeded_is_deterministic]


@pytest.mark.parametrize("case", JOURNAL_CASES, ids=lambda c: c.__name__[5:])
def test_journal_case(tmp_path, pkg, case):
    case(pkg, str(tmp_path / "wal"))


def test_run_to_kill_arms_waits_and_joins(tmp_path):
    """A loop thread committing to a journal dies at the armed kill point;
    ``run_to_kill`` returns once it has, and times out on a point that is
    never crossed."""
    inj = res.CrashInjector("post-commit", hit=3, armed=False)
    journal = dur.Journal(str(tmp_path / "wal"), barrier=inj.barrier)
    died = []

    def loop():
        try:
            for i in range(10_000):
                journal.log("tick", i=i)
                time.sleep(0.001)
        except res.SimulatedKill:
            died.append(True)

    service = SimpleNamespace(_thread=threading.Thread(target=loop, daemon=True))
    service._thread.start()
    res.run_to_kill(inj, service, timeout=10.0)
    assert died == [True] and not service._thread.is_alive()
    assert inj.counts()["post-commit"] == 3
    with pytest.raises(TimeoutError, match="never fired"):
        res.run_to_kill(res.CrashInjector("pre-rotate", armed=False), SimpleNamespace(),
                        timeout=0.05)


def test_seeded_draws_match_jax():
    for seed in range(30):
        a, b = res.CrashInjector.seeded(seed), jres.CrashInjector.seeded(seed)
        assert (a.point, a.hit) == (b.point, b.hit)
    assert res.KILL_POINTS == jres.KILL_POINTS


def test_replay_reconciled_matches_jax(tmp_path):
    """Two incarnations whose seq ranges overlap: the union, later one wins."""
    d = str(tmp_path / "wal")
    _write_batch_journal(dur.Journal, d)
    segs = sorted(n for n in os.listdir(d) if n.endswith(".jsonl"))
    # a stale copy of the first segment under a later name: a restart from an older cut
    with open(os.path.join(d, segs[0]), "rb") as f:
        stale = f.read()
    with open(os.path.join(d, "wal-000099.jsonl"), "wb") as f:
        f.write(stale)
    got = dur.replay_reconciled(d)
    assert got == jdur.journal.replay_reconciled(d)
    assert [r["seq"] for r in got] == sorted({r["seq"] for r in got})


# ------------------------------------------------------ checkpoint files
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(8, 4)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(2, 8, generator=g)).sum().backward()
    opt.step()
    return {"params": model, "opt_state": opt, "step": 3 + seed}


def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _flip_tensor_byte(path):
    """Flip one byte inside the first array member's data of the
    checkpoint's shard file (the manifest names it)."""
    import glob
    import struct
    import zipfile

    shard = glob.glob(glob.escape(path) + ".g*.r0.npz")[0]
    with zipfile.ZipFile(shard) as zf:
        info = next(i for i in zf.infolist() if i.filename.endswith(".npy"))
    raw = bytearray(open(shard, "rb").read())
    name_len, extra_len = struct.unpack("<HH", raw[info.header_offset + 26:
                                                   info.header_offset + 30])
    # past the member's npy header (128 bytes) into its data
    raw[info.header_offset + 30 + name_len + extra_len + 128 + 5] ^= 0xFF
    open(shard, "wb").write(bytes(raw))


@pytest.mark.parametrize("damage", [_truncate, _flip_tensor_byte], ids=["truncated", "bit-flip"])
def test_damaged_checkpoint_fails_verify_and_goes_to_a_sidecar(tmp_path, damage):
    path = str(tmp_path / "t.pt")
    ckpt.save(path, _state())
    assert ckpt.verify(path) is True
    damage(path)
    assert ckpt.verify(path) is False
    if damage is _truncate:
        with pytest.raises(ckpt.CheckpointCorruptError) as err:
            ckpt.restore(path, _state(1))
        assert err.value.quarantined == path + ".corrupt"
    else:  # a reader takes a flipped array byte: recovery's verify finds it
        assert dur.reconcile_checkpoints({"t": [path, path]}) == {"t": None}
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    # a second quarantine of the same path never overwrites the first
    ckpt.save(path, _state())
    damage(path)
    assert not ckpt.verify(path)
    assert ckpt.quarantine(path) == path + ".corrupt.1"


def test_missing_checkpoint_is_not_corrupt(tmp_path):
    path = str(tmp_path / "never.pt")
    assert ckpt.verify(path) is False
    with pytest.raises(FileNotFoundError):
        ckpt.restore(path, _state())
    assert not os.path.exists(path + ".corrupt")


def test_reconcile_falls_back_past_a_missing_publication(tmp_path):
    good, gone = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    ckpt.save(good, _state())
    assert dur.reconcile_checkpoints({"a": [good, gone], "b": [gone]}) == {"a": good,
                                                                           "b": None}


@pytest.mark.parametrize("save", ["save", "save_async"])
def test_publish_hook_fires_after_the_rename(tmp_path, save):
    seen = []

    def hook(stem, path):
        seen.append((stem, path, os.path.exists(path), threading.current_thread().name))

    path = str(tmp_path / "t1.pt")
    ckpt.add_publish_hook(hook)
    try:
        getattr(ckpt, save)(path, _state())
        ckpt.flush()
    finally:
        ckpt.remove_publish_hook(hook)
    ckpt.remove_publish_hook(hook)  # removing twice is harmless
    assert [s[:3] for s in seen] == [("t1", os.path.abspath(path), True)]
    assert seen[0][3].startswith("ckpt-") == (save == "save_async")


def test_kill_before_the_rename_keeps_the_previous_checkpoint(tmp_path):
    """``pre-manifest-rename``: the new shard file is written, the manifest
    not renamed; the previous checkpoint stays whole, no temporary file is
    left, no hook fires. ``save_async``'s writer thread never crosses the
    barrier."""
    path = str(tmp_path / "t.pt")
    ckpt.save(path, _state(0))
    seen = []
    hook = lambda stem, p: seen.append(stem)  # noqa: E731
    inj = res.CrashInjector("pre-manifest-rename")
    ckpt.set_crash_barrier(inj.barrier)
    ckpt.add_publish_hook(hook)
    try:
        ckpt.save_async(path, _state(1))
        ckpt.flush()
        assert inj.counts() == {} and ckpt.load(path)["step"] == 4 and seen == ["t"]
        with pytest.raises(res.SimulatedKill):
            ckpt.save(path, _state(2))
    finally:
        ckpt.set_crash_barrier(None)
        ckpt.remove_publish_hook(hook)
    assert ckpt.verify(path) and ckpt.load(path)["step"] == 4 and seen == ["t"]
    names = os.listdir(tmp_path)
    assert "t.pt" in names and not [n for n in names if n.endswith(".tmp")]


# ------------------------------------------------------------ plan records
def test_plan_json_matches_jax():
    from saturn_tpu.core.mesh import Block as JBlock

    spec = {"a": (1, 0, 1, 0.0, 3.5), "b": (2, 2, 2, 1.25, 4.0)}
    plan = milp.Plan({n: milp.Assignment(g, Block(o, s), st, rt)
                      for n, (g, o, s, st, rt) in spec.items()}, makespan=5.25)
    plan.compute_dependencies()
    jplan = jmilp.Plan({n: jmilp.Assignment(g, JBlock(o, s), st, rt)
                        for n, (g, o, s, st, rt) in spec.items()}, makespan=5.25)
    jplan.compute_dependencies()
    assert plan.to_json() == jplan.to_json()
    back = milp.Plan.from_json(jplan.to_json())
    assert back == plan and back.to_json() == plan.to_json()
    # a JAX plan with groups reads back with them, and writes the same form
    grouped = dict(jplan.to_json(), coschedule=[["a", "b"]], fused=[["a", "b"]])
    back = milp.Plan.from_json(grouped)
    assert back.coschedule == [["a", "b"]] and back.fused == [["a", "b"]]
    assert back.to_json() == jmilp.Plan.from_json(grouped).to_json()


# ------------------------------------------------------- guardian records
SCRIPT = [  # (interval, task, fault kind, batches); "ok" = a clean interval
    (0, "sick", "nan", (2,)), (2, "sick", "nan", (2, 3)), (3, "wedged", "hung", ()),
    (5, "sick", "ok", ()), (6, "sick", "nan", (4,)), (8, "sick", "nan", (4,)),
    (9, "wedged", "hung", ()), (11, "wedged", "hung", ()),
]


class _SkipList:
    """A task stand-in with the skip-list contract of both packages' Task."""

    def __init__(self, name, epoch_length=8):
        self.name, self.epoch_length, self._q = name, epoch_length, set()

    def quarantine_batches(self, indices):
        self._q |= {int(i) % self.epoch_length for i in indices}


def _guardian_records(root, p, guardian_cls, config, numeric, hung):
    j = p.Journal(root)
    g = guardian_cls(config, journal=j)
    tasks = {n: _SkipList(n) for n in ("sick", "wedged")}
    for i, name, kind, batches in SCRIPT:
        if kind == "ok":
            g.note_success(name)
            continue
        err = (numeric(name, 0, "nonfinite", step=0, loss=float("nan"),
                       batch_indices=batches, bad_count=len(batches))
               if kind == "nan" else hung(name, 1.0, 2.0))
        g.on_fault(tasks[name], err, i)
    durable = [(r["kind"], r["data"]) for r in p.replay(root)]
    j.close()
    return durable, [(r["kind"], r["data"]) for r in p.replay(root)]


def test_guardian_journals_the_jax_records(tmp_path):
    """One fault sequence through both guardians, each with a journal: the
    same records with the same fields, and the same ones durable before the
    close (a quarantine commits at once, faults and backoffs ride the next
    commit)."""
    cfg = dict(retry_budget=4, hung_budget=2, quarantine_after=2, backoff_cap=4)
    want = _guardian_records(str(tmp_path / "jax"), PKGS["jax"], JTrainingGuardian,
                             JGuardianConfig(**cfg), JNumericFaultError, JHungDispatchError)
    got = _guardian_records(str(tmp_path / "torch"), PKGS["torch"], TrainingGuardian,
                            GuardianConfig(**cfg), NumericFaultError, HungDispatchError)
    assert got == want
    kinds = [k for k, _ in got[1]]
    assert kinds.count("health_quarantine") == 2 and "health_fault" in kinds
    assert [k for k, _ in got[0]][-1] == "health_quarantine"


def test_guardian_restore_reapplies_skip_lists():
    g = TrainingGuardian(GuardianConfig())
    tasks = [_SkipList("a"), _SkipList("b")]
    g.restore({"a": [3, 1], "c": [2]}, ["b"], tasks)
    assert tasks[0]._q == {1, 3} and tasks[1]._q == set()


# -------------------------------------------- resume with a fake technique
class RecordingTech(BaseTechnique):
    """Runs nothing and writes no checkpoint: only the journal says how far
    a task got, as in the JAX package's resume tests."""

    name = "recording"

    def __init__(self):
        self.calls, self.lock = [], threading.Lock()

    def execute(self, task, devices, tid, override_batch_count=None, window_size=None):
        with self.lock:
            self.calls.append((task.name, override_batch_count))

    def search(self, task, devices, tid):
        return {}, 0.001


def _fake_tasks(tmp_path, tech, totals, pbt=0.01):
    out = []
    for name, total in totals.items():
        t = sat.Task(get_model=lambda **kw: None,
                     get_dataloader=lambda: make_lm_dataset(
                         context_length=16, batch_size=2, vocab_size=64, n_tokens=16 * 2 * 4),
                     loss_fn=pretraining_loss, hparams=sat.HParams(batch_count=total),
                     name=name, save_dir=str(tmp_path / "ckpts"))
        t.strategies = {1: sat.Strategy(tech, 1, {}, pbt * total, pbt)}
        out.append(t)
    return out


def test_resume_runs_only_what_the_journal_lacks(tmp_path):
    d = str(tmp_path / "wal")
    with dur.Journal(d) as j:  # an earlier incarnation: a ran 30 of 50, b completed
        j.append("task_progress", task="a", batches=30)
        j.append("task_progress", task="b", batches=40)
        j.append("task_completed", task="b")
        j.commit()
    tech = RecordingTech()
    out = sat.orchestrate(_fake_tasks(tmp_path, tech, {"a": 50, "b": 40}), interval=0.2,
                          topology=SliceTopology(CPU), resume_dir=d, health_guardian=False)
    assert sorted(out["completed"]) == ["a", "b"]
    ran = {}
    for name, n in tech.calls:
        ran[name] = ran.get(name, 0) + n
    assert ran == {"a": 20}
    state = dur.replay_batch_state(d)
    assert state.progress == {"a": 50, "b": 40} and sorted(state.completed) == ["a", "b"]
    recs = dur.replay(d, strict=True)
    assert [r["data"]["completed"] for r in recs if r["kind"] == "recovery"] == [1]
    jdur.replay(d, strict=True)


def test_resume_is_idempotent_when_everything_is_done(tmp_path):
    d = str(tmp_path / "wal")
    tech = RecordingTech()
    topo = SliceTopology(CPU)
    out1 = sat.orchestrate(_fake_tasks(tmp_path, tech, {"x": 30}), interval=0.2,
                           topology=topo, resume_dir=d)
    assert out1["completed"] == ["x"]
    n_calls = len(tech.calls)
    out2 = sat.orchestrate(_fake_tasks(tmp_path, tech, {"x": 30}), interval=0.2,
                           topology=topo, resume_dir=d)
    assert out2["completed"] == ["x"] and len(tech.calls) == n_calls
    assert dur.replay_batch_state(d).progress == {"x": 30}


def test_journaled_failure_is_not_retried(tmp_path):
    d = str(tmp_path / "wal")
    with dur.Journal(d) as j:
        j.log("task_failed", task="a", error="RuntimeError('gone')")
    tech = RecordingTech()
    out = sat.orchestrate(_fake_tasks(tmp_path, tech, {"a": 5, "b": 5}), interval=1.0,
                          topology=SliceTopology(CPU), resume_dir=d)
    assert out == {"completed": ["b"], "failed": {"a": "RuntimeError('gone')"}}
    assert {n for n, _ in tech.calls} == {"b"}


def test_a_committed_plan_that_fails_the_verifier_is_quarantined(tmp_path):
    d = str(tmp_path / "wal")
    bad = {"makespan": 1.0, "assignments": {"a": [1, 0, 1, 0.0, 1.0], "b": [1, 0, 1, 0.0, 1.0]},
           "dependencies": {"a": [], "b": []}, "coschedule": [], "fused": []}
    with dur.Journal(d) as j:
        j.log("plan_commit", interval=0, makespan=1.0, plan=bad)
    tech = RecordingTech()
    sat.orchestrate(_fake_tasks(tmp_path, tech, {"a": 3, "b": 3}), interval=1.0,
                    topology=SliceTopology(CPU), resume_dir=d)
    quarantines = [r["data"] for r in dur.replay(d) if r["kind"] == "plan_quarantine"]
    assert quarantines and quarantines[0]["source"] == "journal-replay"
    assert quarantines[0]["codes"]


def test_a_journal_that_cannot_be_opened_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    tech = RecordingTech()
    with pytest.raises(OSError):
        sat.orchestrate(_fake_tasks(tmp_path, tech, {"a": 3}), interval=1.0,
                        topology=SliceTopology(CPU), resume_dir=str(blocker / "wal"))
    assert tech.calls == []


# ------------------------------------------------- resume on tiny GPT-2 tasks
def _loader(poison=None):
    base = make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                           n_tokens=64 * 4 * 8)
    return base if poison is None else Poisoned(base, poison)


class Poisoned:
    """A dataset whose batch ``index`` carries a whole row of ``MARK``."""

    def __init__(self, base, index):
        self.base, self.index = base, index
        self.batch_size = base.batch_size

    def __len__(self):
        return len(self.base)

    def batch(self, i):
        b = np.array(self.base.batch(i))
        if i % len(self.base) == self.index:
            b[0, :] = MARK
        return b

    def example_batch(self):
        return self.base.example_batch()


def sick_loss(logits, tokens):
    """The pretraining loss over the logits, plus sqrt(-1) (NaN) on a marked
    batch."""
    return pretraining_loss(logits, tokens) + torch.sqrt(-(tokens[0] == MARK).all().float())


def _tasks(save_dir, totals=(("a", 8, 1e-3), ("b", 8, 2e-3)), poison=None):
    """Tiny GPT-2 tasks, each with one profiled size-1 strategy of 1 s per
    batch (the forecast's unit)."""
    tech = DataParallel()
    out = []
    for name, total, lr in totals:
        p = poison if name == "sick" else None
        t = sat.Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                     get_dataloader=lambda p=p: _loader(p),
                     loss_fn=pretraining_loss if p is None else sick_loss,
                     hparams=sat.HParams(lr=lr, batch_count=total), name=name,
                     save_dir=str(save_dir))
        t.strategies = {1: sat.Strategy(tech, 1, {"remat": False}, 1.0 * total, 1.0)}
        out.append(t)
    return out


def _jtasks(save_dir, totals=(("a", 8, 1e-3), ("b", 8, 2e-3))):
    tech = JDataParallel()
    out = []
    for name, total, lr in totals:
        t = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", **kw),
                  get_dataloader=lambda: j_make_lm_dataset(
                      context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
                  loss_fn=j_pretraining_loss, hparams=JHParams(lr=lr, batch_count=total),
                  name=name, save_dir=str(save_dir))
        t.strategies = {1: JStrategy(tech, 1, {}, 1.0 * total, 1.0)}
        out.append(t)
    return out


@pytest.fixture
def pinned_profiles(monkeypatch):
    """Keep every task's per-batch time at its profiled 1 s in both packages,
    so that both forecast the same batches for every interval."""
    monkeypatch.setattr(sat.Task, "apply_realized_feedback", lambda self: None)
    monkeypatch.setattr(JTask, "apply_realized_feedback", lambda self: None)


def _jax_topology():
    import jax

    return JSliceTopology(jax.devices()[:1])


def _comparable(records):
    """(kind, data) of each record but the checkpoint publications (their
    paths are each package's format, and each lands in whichever commit
    follows its writer thread's rename), with the plan's times left out."""
    out = []
    for r in records:
        if r["kind"] == "ckpt_published":
            continue
        d = dict(r["data"])
        if r["kind"] == "plan_commit":
            d.pop("makespan")
            plan = dict(d.pop("plan"))
            plan.pop("makespan")
            plan["assignments"] = {n: a[:3] for n, a in plan["assignments"].items()}
            d["plan"] = plan
        out.append((r["kind"], d))
    return out


def test_resume_dir_journals_what_jax_journals(tmp_path, pinned_profiles):
    """Two tiny GPT-2 tasks through both packages' orchestrate(resume_dir=):
    the same records, in the same order, with the same fields."""
    jroot, root = str(tmp_path / "jwal"), str(tmp_path / "wal")
    jout = j_orchestrate(_jtasks(tmp_path / "jckpts"), interval=3.5,
                         topology=_jax_topology(), resume_dir=jroot)
    tasks = _tasks(tmp_path / "ckpts")
    out = sat.orchestrate(tasks, interval=3.5, topology=SliceTopology(CPU), resume_dir=root)
    assert sorted(out["completed"]) == sorted(jout["completed"]) == ["a", "b"]
    recs, jrecs = dur.replay(root, strict=True), jdur.replay(root, strict=True)
    assert recs == jrecs
    got, want = _comparable(recs), _comparable(jdur.replay(jroot, strict=True))
    assert got == want
    kinds = [k for k, _ in got]
    assert kinds.count("interval_commit") >= 3 and kinds.count("plan_commit") >= 3
    # every checkpoint the port wrote is journaled, the last ones included
    for t in tasks:
        published = [r["data"]["path"] for r in recs
                     if r["kind"] == "ckpt_published" and r["data"]["task"] == t.name]
        progress = [r for r in recs
                    if r["kind"] == "task_progress" and r["data"]["task"] == t.name]
        assert published == [os.path.abspath(t.ckpt_path)] * len(progress)
    assert dur.replay_batch_state(root).progress == {"a": 8, "b": 8}


def _params_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _moments_equal(a, b):
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


def test_kill_after_the_checkpoint_landed_ends_at_the_total_step(tmp_path, pinned_profiles):
    """A kill at ``mid-interval``: the interval's checkpoint is written, its
    ``task_progress`` dies uncommitted. On resume the checkpoint's step sets
    both the data cursor and the remaining budget: each task ends at exactly
    its 8th step, bitwise equal to an uninterrupted run, and the journal
    counts 8 batches. The JAX package's rule takes the budget from the
    journal: the task it ran first trains the lost interval's 3 batches
    again, ending at step 11."""
    topo = SliceTopology(CPU)
    ref = _tasks(tmp_path / "ref")
    sat.orchestrate(ref, interval=3.5, topology=topo, resume_dir=str(tmp_path / "A"))
    root, save = str(tmp_path / "B"), tmp_path / "kill"
    inj = res.CrashInjector("mid-interval", hit=1)
    with pytest.raises(res.SimulatedKill):
        sat.orchestrate(_tasks(save), interval=3.5, topology=topo, resume_dir=root,
                        crash_barrier=inj.barrier)
    assert dur.replay_batch_state(root).progress == {}
    tasks = _tasks(save)
    out = sat.orchestrate(tasks, interval=3.5, topology=topo, resume_dir=root)
    assert sorted(out["completed"]) == ["a", "b"] and out["failed"] == {}
    for r, t in zip(ref, tasks):
        want, got = ckpt.load(r.ckpt_path), ckpt.load(t.ckpt_path)
        assert got["step"] == want["step"] == 8
        assert _params_equal(got["params"], want["params"]) and _moments_equal(got, want)
    assert dur.replay_batch_state(root).progress == {"a": 8, "b": 8}
    # the resume's record of the lost interval, of the task the plan ran first
    fix = [r["data"] for r in dur.replay(root, strict=True) if r["kind"] == "task_progress"][0]
    first = fix["task"]
    assert fix == {"task": first, "batches": 3}

    # the JAX package on the same run
    jroot, jsave = str(tmp_path / "JB"), tmp_path / "jkill"
    jinj = jres.CrashInjector("mid-interval", hit=1)
    with pytest.raises(jres.SimulatedKill):
        j_orchestrate(_jtasks(jsave), interval=3.5, topology=_jax_topology(),
                      resume_dir=jroot, crash_barrier=jinj.barrier)
    jtasks = _jtasks(jsave)
    j_orchestrate(jtasks, interval=3.5, topology=_jax_topology(), resume_dir=jroot)
    jckpt.flush()
    steps = {t.name: int(jckpt.load_arrays(t.ckpt_path)["step"]) for t in jtasks}
    assert steps == {first: 11, ({"a", "b"} - {first}).pop(): 8}
    assert jdur.replay_batch_state(jroot).progress == {"a": 8, "b": 8}


def test_quarantine_is_replayed_after_a_kill_at_post_rollback(tmp_path):
    """A task whose batch 4 is NaN faults twice; the second fault
    quarantines batch 4 (committed at once) and the run is killed right
    after the rollback. The next incarnation re-applies the quarantine from
    the journal: the task runs past batch 4 without a fault and completes."""
    topo = SliceTopology(CPU)
    totals = (("sick", 8, 1e-3), ("fine", 6, 1e-3))
    d, save = str(tmp_path / "wal"), tmp_path / "ckpts"
    inj = res.CrashInjector("post-rollback", hit=2)
    with pytest.raises(res.SimulatedKill):
        sat.orchestrate(_tasks(save, totals, poison=4), interval=4.5, topology=topo,
                        resume_dir=d, crash_barrier=inj.barrier)
    state = dur.replay_batch_state(d)
    assert state.quarantined == {"sick": [4]}
    kinds = [r["kind"] for r in dur.replay(d, strict=True)]
    assert kinds.count("health_fault") == 2 and kinds[-1] == "health_quarantine"
    tasks = _tasks(save, totals, poison=4)
    out = sat.orchestrate(tasks, interval=4.5, topology=topo, resume_dir=d)
    assert sorted(out["completed"]) == ["fine", "sick"] and out["failed"] == {}
    assert tasks[0].quarantined_batches == (4,)
    assert ckpt.load(tasks[0].ckpt_path)["step"] == 8
    recs = dur.replay(d, strict=True)
    second = [i for i, r in enumerate(recs) if r["kind"] == "recovery"][1]
    assert not [r for r in recs[second:] if r["kind"] == "health_fault"]
    assert dur.replay_batch_state(d).progress["sick"] == 8


def test_crash_barrier_without_resume_dir_raises(tmp_path):
    tech = RecordingTech()
    inj = res.CrashInjector("mid-interval")
    with pytest.raises(ValueError, match="crash_barrier requires resume_dir"):
        sat.orchestrate(_fake_tasks(tmp_path, tech, {"a": 3}), topology=SliceTopology(CPU),
                        crash_barrier=inj.barrier)
    assert tech.calls == []


def test_unsynced_journal_writes_the_same_bytes_without_fsync(tmp_path, monkeypatch):
    """``Journal(sync=False)`` (the twin's): the bytes of ``sync=True`` and
    not one fsync; both packages' journals make the same calls."""
    from saturn_tpu.durability import journal as j_jmod

    def write(mod, root, sync):
        calls = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
        clock = iter(range(1000))
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
        jnl = mod.Journal(str(root), segment_max_bytes=400, sync=sync)
        for i in range(6):
            jnl.append("job_state", job=f"j{i}", state="RUNNING", attempts=i)
            if i % 2:
                jnl.commit()
        jnl.log("job_submitted", job="j9", task="t")
        jnl.close()
        monkeypatch.undo()
        segs = sorted(n for n in os.listdir(root))
        return calls, [(n.split("-")[0], open(os.path.join(root, n), "rb").read()
                        .replace(str(os.getpid()).encode(), b"PID")) for n in segs]

    synced_calls, synced = write(jmod, tmp_path / "a", True)
    calls, unsynced = write(jmod, tmp_path / "b", False)
    assert calls == [] and len(synced_calls) > 0
    assert unsynced == synced and len(synced) > 1  # it rotated
    j_calls, j_unsynced = write(j_jmod, tmp_path / "c", False)
    assert j_calls == [] and j_unsynced == unsynced


def test_journal_module_keeps_the_jax_encoding():
    assert jmod._JSON_OPTS == jdur.journal._JSON_OPTS
    body = {"seq": 7, "ts": 1.5, "kind": "x", "data": {"b": [1, 2], "a": "é"}}
    assert jmod._crc_of(body) == jdur.journal._crc_of(body)
