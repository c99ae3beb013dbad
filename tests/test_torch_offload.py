"""The port's host-offload technique (``parallel/offload.py``) against the JAX
package's ``HostOffload``, on the CPU.

The JAX side runs as its own tests run it here: real pinned-host placement is
off on the CPU, so its stream and bulk steps are the same math over device
memory (bulk through its fused head, falling back to dense math off the
TPU). Tolerances:

- 1e-4 for 5-step loss trajectories and, by relative norm, the final
  parameters against the JAX package (f32 on both sides; five AdamW steps
  of f32 sums taken in another order, as ``tests/test_torch_train.py``);
- bitwise for the pipeline composition against ``forward``, for the
  offload configs against each other, and for the first step's loss and
  gradients against the port's dp over the logits (the same ops in the
  same order on the CPU);
- 1e-6 for what the host's fused AdamW touches: the optimizer state against
  optax over three steps, and the offload trajectory against dp's, whose
  AdamW is torch's single-tensor loop (the same math, other roundings).
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models import bert as jbert
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.offload import HostOffload as JHostOffload
from saturn_tpu.solver import milp as jmilp
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models import bert as tbert
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel import offload
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.offload import HostOffload, Layout
from saturn_tpu_torch.solver import milp
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import timing

TRAJ, HOST = 1e-4, 1e-6
CPU = [torch.device("cpu")]
MODELS = ["test-tiny", "gptj-test-tiny", "bert-test-tiny"]
STREAM, BULK = {"stream": True, "remat": True}, {"stream": False, "remat": False}


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


def _bert(name):
    return name.startswith("bert")


def _port_spec(name, **kw):
    return (tbert.build_bert if _bert(name) else build_gpt2)(name, **kw)


def _untagged(logits, tokens):
    """pretraining_loss without its fused-head tag: dp runs it over the
    logits, as offload runs every loss."""
    return pretraining_loss(logits, tokens)


def _task(tmp_path, model="test-tiny", name="t0", loss_fn=None, lr=1e-3, batch_count=8,
          optimizer="adamw"):
    bert = _bert(model)
    return sat.Task(
        get_model=lambda **kw: _port_spec(model, **{"dtype": torch.float32, **kw}),
        get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                                               n_tokens=64 * 4 * 8, reserved_ids=int(bert)),
        loss_fn=loss_fn or (tbert.mlm_loss if bert else pretraining_loss),
        hparams=sat.HParams(lr=lr, batch_count=batch_count, optimizer=optimizer),
        name=name,
        save_dir=str(tmp_path),
    )


def _select(task, tech, config):
    task.strategies[1] = sat.Strategy(tech, 1, dict(config), 0.0)
    task.select_strategy(1)


def _jax_task(model, save_dir):
    bert = _bert(model)
    spec = (jbert.build_bert if bert else j_build_gpt2)(model, dtype=jnp.float32)
    return spec, JTask(
        get_model=lambda **kw: spec,
        get_dataloader=lambda: j_make_lm_dataset(context_length=64, batch_size=4,
                                                 vocab_size=256, n_tokens=64 * 4 * 8,
                                                 reserved_ids=int(bert)),
        loss_fn=jbert.mlm_loss if bert else j_pretraining_loss,
        hparams=JHParams(lr=1e-3, batch_count=8), save_dir=save_dir)


def _params(state_dict):
    return {k: v.detach().float().numpy() for k, v in state_dict.items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("model", MODELS + ["llama-test-tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pipeline_composition_is_forward(model, dtype):
    spec = _port_spec(model, dtype=dtype)
    net = spec.init_fn(torch.Generator().manual_seed(0))
    pipe = spec.hints["pipeline"]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 255, (2, 64)))
    with torch.no_grad():
        x = pipe["embed"](net, tokens)
        assert tuple(x.shape) == pipe["act_shape"](2, 64) and x.dtype == pipe["act_dtype"]
        for blk in net.blocks:
            x = pipe["block"](blk, x)
        got = pipe["head"](net, x)
        want = spec.apply_fn(net, tokens)
    assert torch.equal(got, want)
    assert spec.hints["embed_param_keys"] == (
        ("wte",) if spec.config.rotary else ("wte", "wpe"))


def test_layout_packs_each_block_contiguously():
    spec = build_gpt2("test-tiny")
    layout = Layout(spec.abstract_init(), "blocks")
    names = [e[0] for e in layout.entries]
    assert names == [n for n, _ in spec.abstract_init().named_parameters()]
    assert all(off % 64 == 0 for _, off, _, _ in layout.entries)
    (s0, e0), (s1, e1) = layout.blocks
    assert e0 == s1 and e1 - s1 == e0 - s0 == layout.block_numel
    # wte, wpe before the blocks and ln_f after them: two runs on the device
    assert [e[0] for e in layout.other] == ["wte", "wpe", "ln_f.scale", "ln_f.bias"]
    assert len(layout.runs) == 2 and layout.runs[1][2] == layout.runs[0][1]


# ------------------------------------------------------------ grid, screen
@pytest.mark.parametrize("model", MODELS)
def test_candidate_grid_matches_jax(tmp_path, model):
    _, jtask = _jax_task(model, str(tmp_path / "jax"))
    want = JHostOffload().candidate_configs(jtask, 1)
    got = HostOffload().candidate_configs(_task(tmp_path, model), 1)
    assert got == want == [STREAM, {"stream": False, "remat": True}, BULK]


def test_stream_mode_raises_on_an_aux_loss_model(tmp_path):
    task = _task(tmp_path)
    spec = task.get_model()
    aux = dataclasses.replace(spec, apply_with_aux_fn=lambda m, t: (spec.apply_fn(m, t), 0.0))
    task._get_model = lambda **kw: aux
    tech = HostOffload()
    assert all(not c.get("stream") for c in tech.candidate_configs(task, 1))
    with pytest.raises(ValueError, match="auxiliary loss"):
        tech.make_step_fns(aux, task, STREAM, torch.device("cpu"), task.get_dataset())


def test_stream_mode_raises_without_pipeline_hints(tmp_path):
    task = _task(tmp_path)
    spec = task.get_model()
    bare = dataclasses.replace(spec, hints={k: v for k, v in spec.hints.items()
                                            if k != "pipeline"})
    task._get_model = lambda **kw: bare
    tech = HostOffload()
    assert all(not c.get("stream") for c in tech.candidate_configs(task, 1))
    with pytest.raises(ValueError, match="pipeline hints"):
        tech.make_step_fns(bare, task, STREAM, torch.device("cpu"), task.get_dataset())


def test_gptj6b_dp_state_is_screened_out_without_an_init(tmp_path, monkeypatch):
    """GPT-J-6B at its published shape: 5,844,459,520 parameters, 87.1 GiB of
    fp32 params, grads and AdamW moments, over 92 % of an 80 GB card. The dp
    trial is refused before any init; offload's state lives on the host and
    is not screened."""
    limit = 85_520_809_984  # torch's total_memory of an H100 80GB HBM3
    monkeypatch.setattr(timing, "device_memory_bytes", lambda dev: limit)
    task = sat.Task(
        get_model=lambda **kw: build_gpt2("gptj-6b", **kw),
        get_dataloader=lambda: make_lm_dataset(context_length=512, batch_size=8,
                                               vocab_size=50304, n_tokens=512 * 8 * 2),
        loss_fn=pretraining_loss, hparams=sat.HParams(lr=1e-4, batch_count=4),
        name="gptj", save_dir=str(tmp_path))
    n = sum(p.numel() for p in task.get_model().abstract_init().parameters())
    assert n == 5_844_459_520
    dp = DataParallel()
    assert dp.state_bytes(task, {"remat": True}) == n * 4 * 4
    assert n * 16 / 2**30 == pytest.approx(87.1, abs=0.05)

    def no_trial(*args, **kwargs):
        raise AssertionError("a trial ran")

    monkeypatch.setattr(dp, "_try_config", no_trial)
    assert dp.search(task, CPU, 0) == (None, None)
    assert [t[-1] for t in dp.trials] == ["static", "static"]
    off = HostOffload()
    assert all(off._static_screen(task, CPU, c) for c in off.candidate_configs(task, 1))
    # a small model passes the same screen
    assert dp._static_screen(_task(tmp_path), CPU, {"remat": False})


# -------------------------------------------------------- against the JAX one
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("config", [STREAM, BULK], ids=["stream", "bulk"])
def test_trajectory_matches_jax(tmp_path, model, config):
    spec, jtask = _jax_task(model, str(tmp_path / "jax"))
    ds = jtask.get_dataset()
    init_state, train_step = JHostOffload().make_step_fns(spec, jtask, config, None, ds)
    state = init_state()
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(train_step)
    want = []
    for i in range(5):
        state, loss = step(state, jnp.asarray(ds.batch(i)))
        want.append(float(loss))
    want_params = params_from_jax(jax.tree_util.tree_map(np.asarray, state["params"]))

    task = _task(tmp_path, model)
    tech = HostOffload()
    _select(task, tech, config)
    start = tech.build(task, CPU, config).empty()
    start["params"].load_state_dict(params_from_jax(params0))
    ckpt.save(task.ckpt_path, start)
    del start
    tech.execute(task, CPU, 0, override_batch_count=5)
    np.testing.assert_allclose(task.last_losses, want, rtol=TRAJ, atol=TRAJ)
    got = _params(ckpt.load(task.ckpt_path)["params"])
    assert ckpt.load(task.ckpt_path)["step"] == 5
    d = spec.config.d_model
    for k, v in want_params.items():
        got_k, want_k = got[k], v.numpy()
        if k.endswith("qkv.bias"):
            # the key bias has a gradient of exactly zero in exact arithmetic
            # (the softmax over keys does not see it): AdamW turns each
            # side's rounding noise there into steps of about lr that no two
            # implementations share
            got_k, want_k = np.delete(got_k, np.s_[d:2 * d]), np.delete(want_k, np.s_[d:2 * d])
        assert _rel(got_k, want_k) <= TRAJ, k


# ------------------------------------------------------ against the port's dp
def _first_step(tech, task, config):
    """Loss and gradients of one step from the seed-0 init (the update
    skipped)."""
    bundle = tech.build(task, CPU, config)
    state = bundle.init()
    state["opt_state"].step = lambda: None
    model = state["params"]
    batch = torch.from_numpy(task.batch_at(0)).long()
    if isinstance(tech, HostOffload):
        _, loss = bundle.step(state, batch)
    else:
        loss = task.loss_fn(model(batch), batch)
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("config", [STREAM, BULK], ids=["stream", "bulk"])
def test_offload_against_dp(tmp_path, config):
    """Bitwise where the same ops run in the same order (the first step's
    loss and gradients), within HOST where the update differs (the host's
    fused AdamW against dp's single-tensor AdamW)."""
    dp_task = _task(tmp_path / "dp", loss_fn=_untagged)
    off_task = _task(tmp_path / "off", loss_fn=_untagged)
    loss_dp, grads_dp = _first_step(DataParallel(), dp_task, {"remat": False})
    loss_off, grads_off = _first_step(HostOffload(), off_task, config)
    assert loss_off == loss_dp
    for k, g in grads_dp.items():
        assert torch.equal(grads_off[k], g), k

    dp, off = DataParallel(), HostOffload()
    _select(dp_task, dp, {"remat": False})
    _select(off_task, off, config)
    dp.execute(dp_task, CPU, 0, override_batch_count=5)
    off.execute(off_task, CPU, 0, override_batch_count=5)
    assert off_task.last_losses[0] == dp_task.last_losses[0]
    np.testing.assert_allclose(off_task.last_losses, dp_task.last_losses, rtol=HOST, atol=HOST)


def test_offload_configs_agree_bitwise(tmp_path):
    losses = []
    for config in HostOffload().candidate_configs(_task(tmp_path), 1):
        task = _task(tmp_path / str(len(losses)))
        tech = HostOffload()
        _select(task, tech, config)
        tech.execute(task, CPU, 0, override_batch_count=4)
        losses.append(task.last_losses)
    assert losses[0] == losses[1] == losses[2]


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_host_optimizer_matches_optax(name):
    """``make_optimizer(host=True)`` (the fused CPU kernel) holds optax's math
    over three steps."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    tx = JHParams(lr=1e-2, batch_count=1, optimizer=name).make_optimizer()
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = sat.HParams(lr=1e-2, batch_count=1, optimizer=name).make_optimizer([tp], host=True)
    assert opt.defaults.get("fused", None) is (None if name == "sgd" else True)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=HOST, atol=HOST)


# ------------------------------------------------------------ host state
def test_host_state_is_one_buffer_per_kind(tmp_path):
    task = _task(tmp_path)
    state = HostOffload().build(task, CPU, STREAM).init()
    host, model, opt = state["host"], state["params"], state["opt_state"]
    assert set(host.buffers) == {"params", "grads", "exp_avg", "exp_avg_sq"}
    base = host.params.data_ptr()
    for (name, off, n, shape), (pname, p) in zip(host.layout.entries, model.named_parameters()):
        assert name == pname and p.data_ptr() == base + 4 * off and tuple(p.shape) == shape
        assert p.grad.data_ptr() == host.grads.data_ptr() + 4 * off
        st = opt.state[p]
        assert st["exp_avg"].data_ptr() == host.buffers["exp_avg"].flat.data_ptr() + 4 * off
        assert float(st["step"]) == 0.0
    # the seed-0 draw of every other technique
    want = DataParallel().build(task, CPU, {"remat": False}).init()["params"]
    for (k, a), b in zip(model.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_is_written_from_and_restored_into_the_host_buffers(tmp_path):
    task = _task(tmp_path)
    tech = HostOffload()
    _select(task, tech, BULK)
    tech.execute(task, CPU, 0, override_batch_count=2)
    live = task._live_state[1]
    # the live state stays on the host; the next interval runs on it
    assert all(p.device.type == "cpu" for p in live["params"].parameters())
    ptrs = {k: b.flat.data_ptr() for k, b in live["host"].buffers.items()}
    tech.execute(task, CPU, 0, override_batch_count=2)
    assert task._live_state[1] is live and tech.intervals[-1]["restored"] is False
    ckpt.wait(task.ckpt_path)
    saved = ckpt.load(task.ckpt_path)
    assert saved["step"] == 4
    for k, v in live["params"].state_dict().items():
        assert torch.equal(saved["params"][k], v), k

    fresh = tech.build(task, CPU, BULK).empty()
    ckpt.restore(task.ckpt_path, fresh)
    assert fresh["step"] == 4
    for (k, a), b in zip(fresh["params"].state_dict().items(), live["params"].state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(fresh["params"].parameters(), live["params"].parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh["opt_state"].state[p][key], live["opt_state"].state[q][key])
        # in place: the restored moments are still views of the state's buffers
        assert fresh["opt_state"].state[p]["exp_avg"].untyped_storage().data_ptr() == \
            fresh["host"].buffers["exp_avg"].flat.data_ptr()
    assert ptrs == {k: b.flat.data_ptr() for k, b in live["host"].buffers.items()}


def test_save_async_without_a_snapshot_needs_host_tensors(tmp_path):
    model = torch.nn.Linear(2, 2, device="meta")
    state = {"params": model, "opt_state": torch.optim.SGD(model.parameters()), "step": 0}
    with pytest.raises(ValueError, match="host memory"):
        ckpt.save_async(str(tmp_path / "x.pt"), state, snapshot=False)


@pytest.mark.parametrize("order", ["dp-then-offload", "offload-then-dp"])
def test_resume_across_techniques(tmp_path, order):
    """An interval under one technique, the next under the other, from its
    checkpoint at the same step: the trajectory is the uninterrupted dp run's
    within HOST (so the moments came across too)."""
    whole = _task(tmp_path / "whole", loss_fn=_untagged)
    dp = DataParallel()
    _select(whole, dp, {"remat": False})
    dp.execute(whole, CPU, 0, override_batch_count=6)

    task = _task(tmp_path / "switch", loss_fn=_untagged)
    techs = [(DataParallel(), {"remat": False}), (HostOffload(), STREAM)]
    if order == "offload-then-dp":
        techs.reverse()
    losses = []
    for tech, config in techs:
        _select(task, tech, config)
        tech.execute(task, CPU, 0, override_batch_count=3)
        task.reconfigure(3)
        losses += task.last_losses
        task.release_live_state()
    assert tech.intervals[-1]["restored"] is True
    assert ckpt.load(task.ckpt_path)["step"] == 6
    np.testing.assert_allclose(losses, whole.last_losses, rtol=HOST, atol=HOST)


def test_interleaved_offload_tasks_hold_one_host_state(tmp_path, monkeypatch):
    """Two offload tasks in turns on one device, as an orchestrated sweep
    runs them: no host state is allocated while another is alive (a
    GPT-J-6B state takes 65 GiB of a 96 GiB host), each task's later
    intervals restore its checkpoint in place, and each trajectory is its
    uninterrupted run's, bit for bit."""
    live = weakref.WeakSet()
    real_init = offload.HostState.__init__

    def tracked_init(self, *args, **kwargs):
        gc.collect()
        assert len(live) == 0, "a host state was allocated while another was alive"
        real_init(self, *args, **kwargs)
        live.add(self)

    def run(tasks, rounds, n):
        tech = HostOffload()
        for t in tasks:
            _select(t, tech, BULK)
        losses = {t.name: [] for t in tasks}
        for _ in range(rounds):
            for t in tasks:
                tech.execute(t, CPU, 0, override_batch_count=n)
                t.reconfigure(n)
                losses[t.name] += t.last_losses
        return tech, losses

    lrs = {"a": 1e-3, "b": 3e-3}
    whole = {}
    for name, lr in lrs.items():
        _, got = run([_task(tmp_path / "whole" / name, name=name, loss_fn=_untagged, lr=lr)], 1, 6)
        whole.update(got)
        offload.release_host_states()
    monkeypatch.setattr(offload.HostState, "__init__", tracked_init)
    tasks = [_task(tmp_path / name, name=name, loss_fn=_untagged, lr=lr)
             for name, lr in lrs.items()]
    tech, got = run(tasks, 3, 2)
    assert [r["restored"] for r in tech.intervals] == [False, False] + [True] * 4
    assert len(live) == 1 and tasks[1]._live_state is not None
    assert tasks[0]._live_state is None  # released when b's state was allocated
    for t in tasks:
        ckpt.wait(t.ckpt_path)
        assert ckpt.load(t.ckpt_path)["step"] == 6
        assert got[t.name] == whole[t.name], t.name


def test_a_new_config_drops_the_old_state_before_allocating(tmp_path, monkeypatch):
    """A task whose config changes between intervals: its old host state is
    released (and its checkpoint written) before the new one is made."""
    live = weakref.WeakSet()
    real_init = offload.HostState.__init__

    def tracked_init(self, *args, **kwargs):
        gc.collect()
        assert len(live) == 0, "a host state was allocated while another was alive"
        real_init(self, *args, **kwargs)
        live.add(self)

    monkeypatch.setattr(offload.HostState, "__init__", tracked_init)
    task = _task(tmp_path, loss_fn=_untagged)
    tech = HostOffload()
    for config in (BULK, STREAM):
        _select(task, tech, config)
        tech.execute(task, CPU, 0, override_batch_count=2)
        task.reconfigure(2)
    assert [r["restored"] for r in tech.intervals] == [False, True]
    assert len(live) == 1


def test_trials_share_one_host_state(tmp_path, monkeypatch):
    task = _task(tmp_path)
    tech = HostOffload()
    draws = []
    real = tech.build

    def counting_build(*args, **kwargs):
        bundle = real(*args, **kwargs)
        init = bundle.init
        bundle.init = lambda *a, **k: draws.append(1) or init(*a, **k)
        return bundle

    monkeypatch.setattr(tech, "build", counting_build)
    config, t = tech.search(task, CPU, 0)
    assert config in tech.candidate_configs(task, 1) and t > 0
    assert len(draws) == 1 and tech._shared == {}
    assert [o for *_, o in tech.trials] == ["ok", "ok", "ok"]
    assert tech._window(task) == 1  # a host state runs one step at a time
    assert len(tech.splits) == 3 * sum(HostOffload.trial_steps)
    split = tech.splits[-1]
    assert split["h2d_bytes"] > 0 and split["d2h_bytes"] > 0 and split["update_s"] > 0


# ----------------------------------------------------- the control path
class _Job:
    def __init__(self, name, strategies):
        self.name = name
        self.strategies = strategies

    def feasible_strategies(self):
        return {g: s for g, s in self.strategies.items() if s.feasible}


def test_sweep_over_dp_and_offload_matches_the_jax_plan(tmp_path):
    assert sat.library.register_default_library() == ["dp", "fsdp", "tp", "offload"]
    tasks = [_task(tmp_path, name=f"lr{i}", lr=lr, batch_count=6)
             for i, lr in enumerate((1e-3, 3e-3))]
    topo = SliceTopology([torch.device("cpu")])
    stats = sat.search(tasks, technique_names=["dp", "offload"], topology=topo)
    # one signature, two techniques: two trials, the second task's two are cache hits
    assert stats["trials_run"] == 2 and stats["cache_hits"] == 2
    for t in tasks:
        assert t.strategies[1].feasible
        assert t.strategies[1].executor.name in ("dp", "offload")

    marker = object()
    jjobs = [_Job(t.name, {1: JStrategy(marker, 1, {}, t.strategies[1].runtime)}) for t in tasks]
    tjobs = [_Job(t.name, {1: sat.Strategy(marker, 1, {}, t.strategies[1].runtime)})
             for t in tasks]
    want = jmilp.solve(jjobs, JSliceTopology([object()]), time_limit=5.0)
    got = milp.solve(tjobs, SliceTopology(["dev0"]), time_limit=5.0)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-6)
    assert sorted(got.assignments) == sorted(want.assignments)

    out = sat.orchestrate(tasks, interval=3 * max(t.strategies[1].per_batch_time for t in tasks),
                          topology=topo, solver_time_limit=1.0)
    assert sorted(out["completed"]) == ["lr0", "lr1"] and out["failed"] == {}
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == 6
        assert np.isfinite(t.last_losses).all()
