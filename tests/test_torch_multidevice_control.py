"""The control path of multi-device blocks, on CPU topologies.

- ``SliceTopology`` and ``core.mesh.physical_groups``: which positions
  share a device; ``topology_signature`` gives a pool that repeats a
  device another key than a pool of as many distinct devices.
- The block's reducer (``parallel/collectives.py``): positions on one
  device are summed there and copied back; distinct devices go through
  ``torch.cuda.nccl.all_reduce`` (a stub here, there is no card), and NCCL
  missing or failing raises.
- ``SPMDTechnique`` on a block: K = 1 over distinct devices, the static
  screen counts the replicas that share a device, and a batch the block
  does not divide yields no config, without raising, and is cached as
  infeasible but not as memory-infeasible.
- The trial runner: anchor-size pruning and the fill against the JAX
  package's ``_anchor_sizes`` and ``_fit_scaling_model`` on stubbed trial
  times, the memory floor (only on a pool of distinct devices), and
  ``parallel_trials=2`` on disjoint blocks against a serial sweep.

Tolerances: none; fitted times to 1e-12 s.
"""

import threading
import time

import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu.trial_runner import evaluator as jevaluator
from saturn_tpu_torch import HParams, Task
from saturn_tpu_torch.core.mesh import SliceTopology, physical_groups
from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel import collectives
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.spmd_base import max_window
from saturn_tpu_torch.trial_runner import evaluator
from saturn_tpu_torch.utils import metrics
from saturn_tpu_torch.utils import profile_cache as pcache
from saturn_tpu_torch.utils import timing

CPU = torch.device("cpu")


def cuda(i):
    return torch.device("cuda", i)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeDev:
    """A device of its own (the pool's positions are distinct)."""

    type = "fake"


def _task(tmp_path, name="t", batch_size=4, chip_range=None):
    return Task(get_model=lambda **kw: build_gpt2("test-tiny", **kw),
                get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=batch_size,
                                                       vocab_size=256, n_tokens=64 * 8 * 8),
                loss_fn=pretraining_loss,
                hparams=HParams(lr=1e-3, batch_count=4, kwargs={"dtype": torch.float32}),
                name=name, save_dir=str(tmp_path), chip_range=chip_range)


# ------------------------------------------------------------------ topology
@pytest.mark.parametrize("devices,groups", [
    ([CPU] * 4, [[0, 1, 2, 3]]),
    ([cuda(0), cuda(1), cuda(0), cuda(1)], [[0, 2], [1, 3]]),
    ([torch.device("cuda"), cuda(0)], [[0, 1]]),
    (["cuda:1", cuda(1), "cpu"], [[0, 1], [2]]),
])
def test_physical_groups(devices, groups):
    assert physical_groups(devices) == groups
    topo = SliceTopology(devices)
    assert topo.distinct == len(groups) and topo.shared == (len(groups) < len(devices))


def test_fake_devices_are_distinct():
    topo = SliceTopology([FakeDev() for _ in range(4)])
    assert topo.distinct == 4 and not topo.shared


def test_a_repeated_device_never_shares_a_key_with_distinct_cards(monkeypatch):
    monkeypatch.setattr(pcache, "_device_kind",
                        lambda d: "NVIDIA H100 80GB HBM3" if d.type == "cuda" else d.type)
    rehearsal = SliceTopology([cuda(0), cuda(0)])
    cards = SliceTopology([cuda(0), cuda(1)])
    one = SliceTopology([cuda(0)])
    sigs = [pcache.topology_signature(t) for t in (rehearsal, cards, one)]
    assert sigs == ["NVIDIA H100 80GB HBM3x2:cap2:distinct1", "NVIDIA H100 80GB HBM3x2:cap2",
                    "NVIDIA H100 80GB HBM3x1:cap1"]
    keys = {pcache.fingerprint("task", "dp", 2, s, {"r": 1}) for s in sigs[:2]}
    assert len(keys) == 2
    eight = pcache.topology_signature(SliceTopology([cuda(0)] * 8))
    assert eight != pcache.topology_signature(SliceTopology([cuda(i) for i in range(8)]))


# ------------------------------------------------------------------- reducer
def test_reducer_on_one_device_sums_in_position_order_and_copies():
    red = collectives.BlockReducer([CPU] * 3)
    ts = [torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0]), torch.tensor([100.0, 200.0])]
    red.all_reduce_(ts)
    for t in ts:
        assert t.tolist() == [111.0, 222.0]
    assert ts[1].data_ptr() != ts[0].data_ptr()
    s, c = red.sum_parts([(torch.tensor(2.0, requires_grad=True), torch.tensor(3)),
                          (torch.tensor(4.0), torch.tensor(0)),
                          (torch.tensor(1.0), torch.tensor(5))])[0]
    assert (float(s), float(c)) == (7.0, 8.0)


class NcclStub:
    def __init__(self, available=True, fail=False):
        self.calls, self.available, self.fail = [], available, fail

    def is_available(self, tensors):
        return self.available

    def all_reduce(self, inputs, outputs=None, op=0, streams=None, comms=None):
        self.calls.append(list(inputs))
        if self.fail:
            raise RuntimeError("NCCL error: unhandled system error")
        total = sum(t.clone() for t in inputs)
        for t in inputs:
            t.copy_(total)


def test_reducer_sends_distinct_devices_through_nccl(monkeypatch):
    stub = NcclStub()
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", stub.all_reduce)
    monkeypatch.setattr(torch.cuda.nccl, "is_available", stub.is_available)
    red = collectives.BlockReducer([cuda(0), cuda(1), cuda(0), cuda(1)])
    assert red.distinct and red.groups == [[0, 2], [1, 3]]
    ts = [torch.tensor([float(10 ** r)]) for r in range(4)]
    red.all_reduce_(ts)
    assert len(stub.calls) == 1 and [t.data_ptr() for t in stub.calls[0]] == [
        ts[0].data_ptr(), ts[1].data_ptr()]
    assert [t.item() for t in ts] == [1111.0] * 4


@pytest.mark.parametrize("stub,error", [
    (NcclStub(fail=True), "unhandled system error"),
    (NcclStub(available=False), "NCCL cannot sum"),
])
def test_reducer_raises_where_nccl_fails(monkeypatch, stub, error):
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", stub.all_reduce)
    monkeypatch.setattr(torch.cuda.nccl, "is_available", stub.is_available)
    red = collectives.BlockReducer([cuda(0), cuda(1)])
    with pytest.raises(RuntimeError, match=error):
        red.all_reduce_([torch.ones(2), torch.ones(2)])


def test_reducer_refuses_a_block_of_mixed_device_types():
    with pytest.raises(ValueError, match="all CUDA"):
        collectives.BlockReducer([CPU, cuda(0)])


# ----------------------------------------------------------- the technique
def test_windows_over_distinct_devices_run_one_step_at_a_time(tmp_path):
    task = _task(tmp_path)
    tech = DataParallel()
    k = max_window()
    assert k > 1
    assert tech._window(task, None, [cuda(0), cuda(0)]) == k
    assert tech._window(task, None, [cuda(0), cuda(1)]) == 1
    assert tech._window(task, None, [CPU] * 4) == k


def test_static_screen_counts_the_replicas_that_share_a_device(tmp_path, monkeypatch):
    task = _task(tmp_path)
    tech = DataParallel()
    need = tech.state_bytes(task, {"remat": False})
    cap = int(1.5 * need / 0.92)
    monkeypatch.setattr(timing, "device_memory_bytes", lambda d: cap)
    assert tech._static_screen(task, [cuda(0)], {"remat": False})
    assert tech._static_screen(task, [cuda(0), cuda(1)], {"remat": False})
    assert not tech._static_screen(task, [cuda(0), cuda(0)], {"remat": False})


def test_a_batch_the_block_does_not_divide_is_infeasible_not_an_error(tmp_path):
    sat.library.register_default_library()
    task = _task(tmp_path, batch_size=4, chip_range=[8])
    tech = DataParallel()
    with pytest.raises(ValueError, match="not divisible by data=8"):
        tech.build(task, [CPU] * 8, {"remat": False})
    assert tech.search(task, [CPU] * 8, 0) == (None, None)
    assert tech.search_report(task.name, 8) == {"memory_infeasible": False}
    events = str(tmp_path / "events.jsonl")
    cache_dir = str(tmp_path / "cache")
    topo = SliceTopology([CPU] * 8)
    stats = sat.search([task], technique_names=["dp"], topology=topo, profile_cache=cache_dir,
                       metrics_path=events, fusion=False)
    assert stats["trials_run"] == 1
    assert not task.strategies[8].feasible
    trial = metrics.read_events(events, kind="trial")
    assert [(e["size"], e["feasible"], e["memory_infeasible"]) for e in trial] == [
        (8, False, False)]
    key = pcache.fingerprint(pcache.task_signature(task), "dp", 8,
                             pcache.topology_signature(topo), pcache.runtime_signature())
    entry = pcache.ProfileCache(cache_dir).get(key)
    assert entry["feasible"] is False and entry["memory_infeasible"] is False


# ---------------------------------------------------------------- the sweep
def _stub(times, memory_at=(), delay=0.0, calls=None):
    """A technique whose trial at size g takes ``times[g]`` s per batch
    (``memory_at``: sizes it finds memory-infeasible); it records
    (task, size, block devices, thread) of every trial."""
    calls = calls if calls is not None else []
    active, lock = [0, 0], threading.Lock()

    class Stub(BaseTechnique):
        name = "stub"
        memory_monotone = True
        log, peak = calls, active

        def __init__(self):
            self._reports = {}

        def search(self, task, devices, tid):
            with lock:
                active[0] += 1
                active[1] = max(active[1], active[0])
            time.sleep(delay)
            with lock:
                active[0] -= 1
                calls.append((task.name, len(devices), tuple(id(d) for d in devices),
                              threading.current_thread().name))
            g = len(devices)
            if g in memory_at:
                self._reports[(task.name, g)] = {"memory_infeasible": True}
                return None, None
            return {"g": g}, times[g]

        def search_report(self, task_name, size):
            return self._reports.pop((task_name, size), None)

        def execute(self, task, devices, tid, override_batch_count=None):
            pass

    return Stub


TIMES = {1: 0.8, 2: 0.47, 4: 0.26, 8: 0.17}


@pytest.fixture
def stub_lib():
    names = []

    def register(cls):
        sat.library.register(cls.name, cls)
        names.append(cls.name)
        return cls

    yield register
    for n in set(names):
        sat.library.deregister(n)


def _strategies(task):
    return {g: (s.feasible, s.params, s.per_batch_time, s.interpolated)
            for g, s in sorted(task.strategies.items())}


@pytest.mark.parametrize("devices", ["fake", "cpu"])
def test_anchor_pruning_and_the_fill_match_jax(tmp_path, stub_lib, devices):
    stub = stub_lib(_stub(TIMES))
    pool = [FakeDev() for _ in range(8)] if devices == "fake" else [CPU] * 8
    task = _task(tmp_path)
    events = str(tmp_path / "events.jsonl")
    stats = sat.search([task], technique_names=["stub"], topology=SliceTopology(pool),
                       profile_cache=False, metrics_path=events, fusion=False)
    anchors = jevaluator._anchor_sizes([1, 2, 4, 8])
    assert anchors == evaluator._anchor_sizes([1, 2, 4, 8]) == {1, 4, 8}
    assert sorted(g for _, g, _, _ in stub.log) == sorted(anchors)
    assert stats["trials_run"] == 3 and stats["pruned"] == 0
    fit = jevaluator._fit_scaling_model([(g, TIMES[g]) for g in sorted(anchors)])
    got = _strategies(task)
    assert got[2][:2] == (True, {"g": 1}) and got[2][3] is True
    assert abs(got[2][2] - fit(2)) < 1e-12
    for g in anchors:
        assert got[g] == (True, {"g": g}, TIMES[g], False)
    interp = metrics.read_events(events, kind="trial_interpolated")
    assert [(e["size"], e["anchor_size"]) for e in interp] == [(2, 1)]
    mine = evaluator._fit_scaling_model([(1, 1.0), (2, 0.4), (4, 0.9)])
    theirs = jevaluator._fit_scaling_model([(1, 1.0), (2, 0.4), (4, 0.9)])
    assert [mine(g) for g in (1, 2, 3, 8)] == [theirs(g) for g in (1, 2, 3, 8)]


@pytest.mark.parametrize("devices,trialled,pruned", [
    # distinct devices: the memory verdict at 8 prunes 4 and 1 (and 2's fill)
    ("fake", [8], 2),
    # positions that share one device: no floor, every anchor runs
    ("cpu", [8, 4, 1], 0),
])
def test_the_memory_floor_prunes_only_on_distinct_devices(tmp_path, stub_lib, devices,
                                                          trialled, pruned):
    stub = stub_lib(_stub(TIMES, memory_at=(8,)))
    pool = [FakeDev() for _ in range(8)] if devices == "fake" else [CPU] * 8
    task = _task(tmp_path)
    stats = sat.search([task], technique_names=["stub"], topology=SliceTopology(pool),
                       profile_cache=False, fusion=False)
    assert [g for _, g, _, _ in stub.log] == trialled
    assert stats["pruned"] == pruned
    assert not task.strategies[8].feasible
    assert task.strategies[4].feasible == (devices == "cpu")


@pytest.mark.parametrize("devices,want", [
    ([cuda(i) for i in range(4)], 4),
    ([cuda(0)] * 8, 1),
    ([cuda(0), cuda(1), cuda(0), cuda(1)], 1),
    ([CPU] * 4, 1),
    ([FakeDev() for _ in range(4)], 1),
])
def test_default_parallelism(devices, want):
    assert evaluator._default_parallelism(SliceTopology(devices)) == want


def test_parallel_trials_on_disjoint_blocks_install_what_a_serial_sweep_does(tmp_path, stub_lib):
    pool = [FakeDev() for _ in range(4)]
    tables = {}
    for workers in (1, 2):
        calls = []
        stub = stub_lib(_stub(TIMES, delay=0.05, calls=calls))
        tasks = [_task(tmp_path / str(workers), name=f"t{i}") for i in range(3)]
        sat.search(tasks, technique_names=["stub"], topology=SliceTopology(pool),
                   profile_cache=False, fusion=False, parallel_trials=workers)
        tables[workers] = [_strategies(t) for t in tasks]
        assert stub.peak[1] == workers
        if workers == 2:
            # each trial held a block of its own while it ran
            threads = {c[3] for c in calls}
            assert any(name.startswith("trial-g1") for name in threads)
            for g in (1, 2):
                blocks = {c[2] for c in calls if c[1] == g}
                assert len(blocks) == 2 and not set.intersection(*map(set, blocks))
    assert tables[1] == tables[2]


def test_search_on_a_rehearsal_pool_runs_real_dp_trials(tmp_path):
    """The real dp at sizes 1, 2 and 4 of ``[cpu] * 4``: every size
    trialled (three sizes: no pruning), each with its replicas."""
    sat.library.register_default_library()
    task = _task(tmp_path)
    stats = sat.search([task], technique_names=["dp"], topology=SliceTopology([CPU] * 4),
                       profile_cache=False, fusion=False)
    assert stats["trials_run"] == 3
    for g in (1, 2, 4):
        s = task.strategies[g]
        assert s.feasible and s.per_batch_time > 0 and not s.interpolated
    tech = task.strategies[1].executor
    assert sorted({size for _, size, _, _, outcome in tech.trials if outcome == "ok"}) == [1, 2, 4]
    assert np.isfinite([task.strategies[g].runtime for g in (1, 2, 4)]).all()
