"""search -> orchestrate through the port on a CPU topology, and the port's
MILP against the JAX package's on the same strategy tables."""

import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.solver import milp as jmilp
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(tmp_path, lrs, batch_count=6):
    return [
        sat.Task(
            get_model=lambda **kw: build_gpt2("test-tiny", **kw),
            get_dataloader=lambda: make_lm_dataset(
                context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
            loss_fn=pretraining_loss,
            hparams=sat.HParams(lr=lr, batch_count=batch_count),
            name=f"lr{i}",
            save_dir=str(tmp_path),
        )
        for i, lr in enumerate(lrs)
    ]


def test_search_then_orchestrate_completes(tmp_path):
    sat.library.register_default_library()
    tasks = _tasks(tmp_path, [1e-3, 3e-3])
    topo = SliceTopology([torch.device("cpu")])
    stats = sat.search(tasks, technique_names=["dp"], topology=topo)
    # the two tasks differ only in lr: one trial, and the default profile
    # cache answers for the other
    assert stats["trials_run"] == 1 and stats["cache_hits"] == 1
    for t in tasks:
        s = t.strategies[1]
        assert s.feasible and s.per_batch_time > 0 and s.params["remat"] in (False, True)
    # a short interval: several rounds of forecast / execute / re-solve
    out = sat.orchestrate(tasks, interval=4 * tasks[0].strategies[1].per_batch_time,
                          topology=topo)
    assert sorted(out["completed"]) == ["lr0", "lr1"] and out["failed"] == {}
    for t in tasks:
        saved = ckpt.load(t.ckpt_path)
        assert saved["step"] == t.hparams.batch_count
        assert np.isfinite(t.last_losses).all()


@pytest.mark.parametrize("retries", [0, 1])
def test_search_raises_when_the_flash_kernel_fails(tmp_path, monkeypatch, retries):
    """A failing kernel reaches the caller: search never keeps the dense
    config in its place."""
    from saturn_tpu_torch.ops import flash

    def broken(*args, **kwargs):
        raise RuntimeError("flash_fwd kernel launch failed: CUDA error 700")

    monkeypatch.setattr(flash, "flash_supported", lambda cfg=None: True)
    monkeypatch.setattr(flash, "flash_fwd", broken)
    sat.library.register_default_library()
    tasks = _tasks(tmp_path, [1e-3], batch_count=2)
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch failed"):
        sat.search(tasks, technique_names=["dp"],
                   topology=SliceTopology([torch.device("cpu")]),
                   trial_retries=retries, retry_backoff_s=0.0)
    assert 1 not in tasks[0].strategies


def test_default_topology_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SliceTopology()


def test_unported_orchestrate_options_raise(tmp_path):
    tasks = _tasks(tmp_path, [1e-3])
    topo = SliceTopology([torch.device("cpu")])
    with pytest.raises(NotImplementedError, match="resume_dir"):
        sat.orchestrate(tasks, topology=topo, resume_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="fault_injector"):
        sat.orchestrate(tasks, topology=topo, fault_injector=object())
    with pytest.raises(NotImplementedError, match="trace_dir"):
        sat.orchestrate(tasks, topology=topo, trace_dir=str(tmp_path))


def test_fault_schedule_in_the_environment_raises(tmp_path, monkeypatch):
    """SATURN_TPU_FAULTS, from which the JAX orchestrate builds a fault
    injector when none is passed, raises in the port rather than running
    without the faults; a blank value is unset for both packages."""
    from saturn_tpu.resilience.faults import FaultInjector

    tasks = _tasks(tmp_path, [1e-3])
    topo = SliceTopology([torch.device("cpu")])
    monkeypatch.setenv("SATURN_TPU_FAULTS", "1:trial_crash:lr0")
    assert FaultInjector.from_env() is not None
    with pytest.raises(NotImplementedError, match="SATURN_TPU_FAULTS"):
        sat.orchestrate(tasks, topology=topo)
    monkeypatch.setenv("SATURN_TPU_FAULTS", "  ")
    assert FaultInjector.from_env() is None
    with pytest.raises(ValueError, match="no profiled strategies"):
        sat.orchestrate(tasks, topology=topo)


def test_library_path_in_the_environment_raises(tmp_path, monkeypatch):
    """SATURN_TPU_LIBRARY_PATH, under which the JAX library persists each
    registered technique with dill, makes the port's register raise; nothing
    is registered or written."""
    from saturn_tpu_torch.parallel.dp import DataParallel

    store = tmp_path / "udp"
    monkeypatch.setenv("SATURN_TPU_LIBRARY_PATH", str(store))
    with pytest.raises(NotImplementedError, match="SATURN_TPU_LIBRARY_PATH"):
        sat.library.register("dp-env", DataParallel)
    assert "dp-env" not in sat.library.registered_names() and not store.exists()
    with pytest.raises(TypeError):  # the type check still comes first, as in JAX
        sat.library.register("dp-env", object)


class _Job:
    """A solver-facing task stand-in: a name and a strategy table."""

    def __init__(self, name, strategies):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_milp_makespan_matches_jax(seed):
    """Same hand-built strategy tables on 4 devices: both exact MILPs reach
    the same makespan (HiGHS gap 1e-4, so compare to 1e-3 relative)."""
    rng = np.random.default_rng(seed)
    tables = []
    for i in range(5):
        base = float(rng.uniform(20, 200))
        tables.append((f"t{i}", {
            g: base / g ** float(rng.uniform(0.5, 1.0)) for g in (1, 2, 4)
            if rng.random() < 0.85 or g == 1
        }))
    marker = object()  # any non-None executor marks a strategy feasible
    jjobs = [_Job(n, {g: JStrategy(marker, g, {}, rt) for g, rt in tab.items()})
             for n, tab in tables]
    tjobs = [_Job(n, {g: sat.Strategy(marker, g, {}, rt) for g, rt in tab.items()})
             for n, tab in tables]
    want = jmilp.solve(jjobs, JSliceTopology([object() for _ in range(4)]),
                       time_limit=30.0)
    got = milp.solve(tjobs, SliceTopology(["dev0", "dev1", "dev2", "dev3"]),
                     time_limit=30.0)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-3)
    # the port's plan is valid: tasks sharing a device never overlap in time
    items = list(got.assignments.items())
    for i, (n1, a1) in enumerate(items):
        for n2, a2 in items[i + 1:]:
            if a1.block.overlaps(a2.block):
                assert (a1.start + a1.runtime <= a2.start + 1e-6
                        or a2.start + a2.runtime <= a1.start + 1e-6)

