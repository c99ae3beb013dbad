"""The port's interval pipeline against the JAX package's, on the CPU.

- The window ceiling (``max_window``) equals the JAX package's over the
  environment cases of ``tests/test_step_pipeline.py``; the port's K is that
  ceiling for every budget (the JAX package's ``choose_window`` shrinks it
  to a shorter budget), and an interval's tail and a short interval run
  through one-step windows.
- The JAX prefetcher's semantics (order, bounded depth, errors re-raised at
  their position, ``try_next``, ``close``, the shape contract), which the
  port replaces by staging each unit inline on the consumer's thread
  (``stage_tokens``).
- A ``test-tiny`` ``execute`` in windows of 4 over 10 batches equals the
  per-step run bitwise (losses and final state: the plain window runs the
  same steps), and its losses lie within 1e-4 of those of the JAX
  package's windowed ``execute`` from the same weights (f32 on both sides,
  both through the fused head with its bf16 logits stash; 1e-4 as in
  ``tests/test_torch_train.py``).
- Live state: a second interval with the same config restores nothing, a
  changed config restores; resuming equals an uninterrupted run; a read
  after ``save_async`` sees the new checkpoint; trials time a
  ``max_window()`` window.
"""

import functools
import threading
import types

import jax
import numpy as np
import pytest
import torch

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data import prefetch as jprefetch
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel import spmd_base as jspmd
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.resilience.crash import SimulatedKill
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel import spmd_base
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.utils import checkpoint as ckpt

TRAJ_TOL = 1e-4
CPU = [torch.device("cpu")]
ENV = "SATURN_TPU_MAX_WINDOW"


# ------------------------------------------------------------ window policy
@pytest.mark.parametrize("env", [None, "4", "1", "0", "12", "banana"])
def test_window_policy_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    assert spmd_base.DEFAULT_MAX_WINDOW == jspmd.DEFAULT_MAX_WINDOW
    assert spmd_base.max_window() == jspmd.max_window()
    task = types.SimpleNamespace(name="policy", hparams=HParams(batch_count=1))
    tech = DataParallel()
    # K is the ceiling whatever the budget; where the budget reaches it,
    # that is the JAX package's K too
    assert tech._window(task) == spmd_base.max_window()
    for n in range(spmd_base.max_window(), 41):
        assert tech._window(task) == jspmd.choose_window(n), n
    for size in range(13):
        assert tech._window(task, size) == max(1, size)


@pytest.mark.parametrize("n,k,warm", [
    (0, 1, False), (1, 1, False), (10, 1, True), (10, 4, False), (10, 4, True),
    (8, 8, False), (8, 8, True), (9, 8, True), (17, 8, True), (3, 3, True), (24, 8, False),
    (3, 8, True), (3, 8, False), (1, 8, True), (0, 8, True),
])
def test_unit_plan_runs_every_batch_once(n, k, warm):
    """K = 1: eager steps. Else windows of K, then a tail of one-step
    windows; with ``warm`` an eager step first."""
    units = spmd_base.unit_plan(n, k, warm)
    batches = [off + j for _, off, size in units for j in range(size)]
    assert batches == list(range(n))
    if k == 1:
        assert units == [("step", j, 1) for j in range(n)]
    else:
        lead = int(warm and n > 0)
        windows = (n - lead) // k
        assert [u[0] for u in units] == ["warm"] * lead + ["window"] * (n - lead - windows * (k - 1))
        assert [size for _, _, size in units] == [1] * lead + [k] * windows + [1] * (
            n - lead - windows * k)


# --------------------------------------------------------------- prefetcher
PREFETCHERS = [jprefetch.DevicePrefetcher]
IDS = ["jax"]


@pytest.mark.parametrize("cls", PREFETCHERS, ids=IDS)
def test_prefetcher_yields_in_order(cls):
    with cls(10, lambda i: i * i, depth=2) as pf:
        assert list(pf) == [i * i for i in range(10)]


@pytest.mark.parametrize("cls", PREFETCHERS, ids=IDS)
def test_prefetcher_bounded_depth(cls):
    staged = []

    def stage(i):
        staged.append(i)
        return i

    pf = cls(10, stage, depth=2)
    try:
        assert next(pf) == 0
        threading.Event().wait(0.3)  # time for the producer to overrun if it could
        # one consumed + at most depth in the queue + one in flight
        assert len(staged) <= 4
    finally:
        pf.close()


@pytest.mark.parametrize("cls", PREFETCHERS, ids=IDS)
@pytest.mark.parametrize("err", [ValueError("bad batch"), SimulatedKill("mid-staging")],
                         ids=["exception", "base-exception"])
def test_prefetcher_reraises_at_position(cls, err):
    def stage(i):
        if i == 3:
            raise err
        return i

    pf = cls(10, stage, depth=2)
    got = []
    try:
        with pytest.raises(type(err)):
            for v in pf:
                got.append(v)
    finally:
        pf.close()
    assert got == [0, 1, 2]  # everything before the fault arrived


@pytest.mark.parametrize("cls", PREFETCHERS, ids=IDS)
def test_prefetcher_close_unblocks_parked_producer(cls):
    pf = cls(100, lambda i: i, depth=1)
    next(pf)  # the producer starts and fills the queue
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


@pytest.mark.parametrize("mod", [jprefetch], ids=IDS)
def test_prefetcher_try_next(mod):
    gate = threading.Event()

    def stage(i):
        if i == 1:
            gate.wait(5.0)
        return i

    pf = mod.DevicePrefetcher(2, stage, depth=2)
    try:
        deadline = threading.Event()
        got = mod.NOT_READY
        for _ in range(50):
            got = pf.try_next()
            if got is not mod.NOT_READY:
                break
            deadline.wait(0.02)
        assert got == 0
        assert pf.try_next() is mod.NOT_READY  # unit 1 is parked on the gate
        gate.set()
        for _ in range(250):
            got = pf.try_next()
            if got is not mod.NOT_READY:
                break
            deadline.wait(0.02)
        assert got == 1
        with pytest.raises(StopIteration):
            pf.try_next()
    finally:
        gate.set()
        pf.close()


@pytest.mark.parametrize("mod", [jprefetch], ids=IDS)
def test_prefetcher_shape_contract(mod):
    pf = mod.DevicePrefetcher(2, lambda i: np.zeros((4, 2, 3) if i else (2, 3)),
                              expect_shapes=[(2, 3)])
    try:
        assert next(pf).shape == (2, 3)
        with pytest.raises(mod.ShapeContractError, match=r"staged unit 1 has shape \(4, 2, 3\)"):
            next(pf)
    finally:
        pf.close()


@pytest.mark.parametrize("shape", [(3, 4), (2, 3, 4)], ids=["step", "window"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_stage_tokens_on_the_cpu_is_the_host_batch(shape, dtype):
    host = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    got = spmd_base.stage_tokens(host, "cpu")
    assert got.dtype == torch.long and got.device.type == "cpu" and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), host)


# ------------------------------------------------------------------ execute
def _loader():
    return make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                           n_tokens=64 * 4 * 8)


def _task(tmp_path, name="t0", config=None, batch_count=10):
    task = Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **kw),
        get_dataloader=_loader,
        loss_fn=pretraining_loss,
        hparams=HParams(lr=1e-3, batch_count=batch_count,
                        kwargs={"dtype": torch.float32}),
        name=name,
        save_dir=str(tmp_path),
    )
    tech = DataParallel()
    task.strategies[1] = Strategy(tech, 1, config or {"remat": False}, 0.0)
    task.select_strategy(1)
    return task, tech


def _state_dict(task):
    return ckpt.load(task.ckpt_path)


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k], rtol=0, atol=0)
    for pa, pb in zip(a["opt_state"]["state"].values(), b["opt_state"]["state"].values()):
        for k in pa:
            torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


def _jax_windowed(save_dir, n, k):
    """The JAX package's windowed dp ``execute`` of ``test-tiny`` (f32) on
    one CPU device: its init params and the losses of its windows and tail,
    read from its programs' outputs."""
    spec = j_build_gpt2("test-tiny", dtype=jax.numpy.float32)
    jtask = JTask(get_model=lambda **kw: spec, get_dataloader=lambda: j_make_lm_dataset(
        context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
        loss_fn=j_pretraining_loss, hparams=JHParams(lr=1e-3, batch_count=n),
        name="jw", save_dir=save_dir)
    tech = JDataParallel()
    init_state, _ = tech.make_step_fns(spec, jtask, {}, None, jtask.get_dataset())
    params0 = jax.tree_util.tree_map(np.asarray, init_state()["params"])
    devs = jax.devices()[:1]
    jtask.strategies = {1: JStrategy(executor=tech, apportionment=1, params={},
                                     runtime=1.0, per_batch_time=0.1)}
    jtask.select_strategy(1)
    bundle = tech.build(jtask, devs, {})
    losses = []

    def recording(program):
        def run(state, batch):
            state, loss = program(state, batch)
            losses.extend(np.asarray(loss).reshape(-1).tolist())
            return state, loss
        return run

    bundle._fused[k] = recording(bundle.fused_compiled(k))
    bundle._compiled = recording(bundle.compiled)
    tech.execute(jtask, devs, 0, override_batch_count=n, window_size=k)
    jckpt.flush()
    return params0, losses


def test_windowed_execute_equals_per_step_and_jax(tmp_path, monkeypatch):
    from saturn_tpu.ops import ce as jce

    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))
    params0, want = _jax_windowed(str(tmp_path / "jax"), 10, 4)
    assert len(want) == 10
    runs = {}
    for k in (1, 4):
        task, tech = _task(tmp_path / f"k{k}")
        start = tech.build(task, CPU, {"remat": False}).empty()
        start["params"].load_state_dict(params_from_jax(params0))
        ckpt.save(task.ckpt_path, start)
        tech.execute(task, CPU, 0, override_batch_count=10, window_size=k)
        rec = tech.intervals[-1]
        assert (rec["k"], rec["windows"], rec["tail"], rec["warm"]) == (
            (1, 0, 10, False) if k == 1 else (4, 2, 2, False))
        runs[k] = (task.last_losses, _state_dict(task))
    assert runs[4][0] == runs[1][0]  # bitwise
    _assert_same_state(runs[4][1], runs[1][1])
    assert runs[4][1]["step"] == 10
    np.testing.assert_allclose(runs[4][0], want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("n", [3, 8, 11])
def test_k_is_the_ceiling_for_every_budget(tmp_path, monkeypatch, n):
    """With no ``window_size`` K is ``max_window()`` whatever the budget:
    ``n // K`` windows of K, the rest one-step windows, the losses and the
    final state those of one step at a time."""
    monkeypatch.setenv(ENV, "8")
    runs = {}
    for k in (None, 1):
        task, tech = _task(tmp_path / f"k{k}", batch_count=n)
        tech.execute(task, CPU, 0, override_batch_count=n, window_size=k)
        rec = tech.intervals[-1]
        assert (rec["k"], rec["windows"], rec["tail"]) == ((8, n // 8, n % 8) if k is None
                                                           else (1, 0, n))
        runs[k] = (task.last_losses, _state_dict(task))
    assert runs[None][0] == runs[1][0]  # bitwise
    _assert_same_state(runs[None][1], runs[1][1])


def test_live_state_skips_the_restore(tmp_path, monkeypatch):
    """Two intervals with one config: one restore (none at all here, the
    run starts fresh); a changed config restores; the trajectory equals an
    uninterrupted run with windows on."""
    restores = []
    real = ckpt.restore
    monkeypatch.setattr(ckpt, "restore", lambda *a: restores.append(a[0]) or real(*a))
    whole, tech = _task(tmp_path / "whole", batch_count=12)
    tech.execute(whole, CPU, 0, override_batch_count=12, window_size=4)

    task, tech = _task(tmp_path / "split", batch_count=12)
    losses = []
    for n in (5, 3):
        tech.execute(task, CPU, 0, override_batch_count=n, window_size=4)
        task.reconfigure(n)
        losses += task.last_losses
    assert restores == [] and [r["restored"] for r in tech.intervals] == [False, False]
    task.strategies[1] = Strategy(tech, 1, {"remat": True}, 0.0)
    task.select_strategy(1)
    tech.execute(task, CPU, 0, override_batch_count=4, window_size=4)
    assert restores == [task.ckpt_path] and tech.intervals[-1]["restored"]
    assert losses + task.last_losses == whole.last_losses
    _assert_same_state(_state_dict(task), _state_dict(whole))


def test_resume_equals_uninterrupted_with_windows(tmp_path):
    whole, tech = _task(tmp_path / "a", batch_count=10)
    tech.execute(whole, CPU, 0, override_batch_count=10, window_size=4)

    first, tech = _task(tmp_path / "b", batch_count=10)
    tech.execute(first, CPU, 0, override_batch_count=6, window_size=4)
    # a fresh process's view of the same job: cursor 0, checkpoint on disk
    again, tech = _task(tmp_path / "b", batch_count=10)
    assert again.current_batch == 0 and again.has_ckpt()
    tech.execute(again, CPU, 0, override_batch_count=4, window_size=4)
    assert again.current_batch == 6 and tech.intervals[-1]["restored"]
    assert first.last_losses + again.last_losses == whole.last_losses
    _assert_same_state(_state_dict(again), _state_dict(whole))


def test_read_after_save_async_sees_the_new_checkpoint(tmp_path, monkeypatch):
    task, tech = _task(tmp_path)
    state = tech.build(task, CPU, {"remat": False}).init()
    ckpt.save(task.ckpt_path, state)
    gate = threading.Event()
    real_write = ckpt._write

    def slow_write(path, payload):
        gate.wait(5.0)
        real_write(path, payload)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    state["step"] = 7
    with torch.no_grad():
        state["params"].wte.add_(1.0)
    want = state["params"].wte.detach().clone()
    ckpt.save_async(task.ckpt_path, state)
    with torch.no_grad():
        state["params"].wte.add_(1.0)  # after the snapshot: not saved
    threading.Timer(0.2, gate.set).start()
    saved = ckpt.load(task.ckpt_path)  # joins the write
    assert saved["step"] == 7
    torch.testing.assert_close(saved["params"]["wte"], want, rtol=0, atol=0)


def test_failed_async_write_raises_at_the_next_read(tmp_path, monkeypatch):
    task, tech = _task(tmp_path)
    state = tech.build(task, CPU, {"remat": False}).init()

    def broken(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_async(task.ckpt_path, state)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        task.has_ckpt()
    ckpt.flush()  # the failure was consumed by the read


@pytest.mark.parametrize("env,want", [(None, spmd_base.DEFAULT_MAX_WINDOW), ("3", 3), ("1", 1)])
def test_trial_times_a_max_window(tmp_path, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    task, tech = _task(tmp_path)
    seen = []
    real = spmd_base.timing.time_fused_window

    def spy(fused, state, stage, k, **kw):
        seen.append((k, tuple(stage(0).shape)))
        return real(fused, state, stage, k, **kw)

    monkeypatch.setattr(spmd_base.timing, "time_fused_window", spy)
    t = tech._try_config(task, CPU, {"remat": False})
    assert t > 0
    assert seen == ([(want, (want, 4, 64))] if want > 1 else [])


def test_user_optimizer_runs_one_step_at_a_time(tmp_path, caplog):
    task, tech = _task(tmp_path)
    task.hparams.optimizer = lambda params, lr: torch.optim.SGD(params, lr=lr)
    with caplog.at_level("INFO", logger="saturn_tpu_torch"):
        assert tech._window(task) == 1
        tech.execute(task, CPU, 0, override_batch_count=6, window_size=4)
    assert tech.intervals[-1]["k"] == 1 and tech.intervals[-1]["tail"] == 6
    assert sum("user optimizer callable" in r.message for r in caplog.records) == 1


def test_orchestrate_releases_finished_tasks(tmp_path):
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.core.mesh import SliceTopology

    sat.library.register_default_library()
    task, _ = _task(tmp_path, batch_count=6)
    task.strategies = {}
    topo = SliceTopology(CPU)
    sat.search([task], technique_names=["dp"], topology=topo)
    tech = task.strategies[1].executor
    sat.orchestrate([task], interval=1000.0, topology=topo)
    assert task._live_state is None and tech._bundles == {}
    assert ckpt.load(task.ckpt_path)["step"] == 6
    # 6 batches under K = 8: no window of 8; the tail runs as one-step windows
    assert [(r["k"], r["windows"], r["tail"]) for r in tech.intervals] == [
        (spmd_base.max_window(), 0, 6)]
