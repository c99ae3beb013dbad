"""The port's BERT encoder and masked-LM objective against the JAX package's.

Params come from the JAX init through ``models.convert.params_from_jax``;
tokens from a numpy seed, below the reserved [MASK] id. Tolerances: 1e-5 for
f32 logits and losses, 1e-4 between the fused MLM loss and ``mlm_loss`` over
the logits (another summation order), and 1e-4 for the 5-step dp trajectory
(f32 on both sides; both take the fused head with a bf16 logits stash, the
JAX side through its Pallas kernels in interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models import bert as jbert
from saturn_tpu.ops import ce as jce
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models import bert as tbert
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.ops import ce as tce
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))


F32, FUSED, TRAJ = 1e-5, 1e-4, 1e-4
CPU = [torch.device("cpu")]


@pytest.fixture
def jax_ce_interpret(monkeypatch):
    """The JAX models import fused_linear_cross_entropy at call time: run its
    Pallas kernels in interpret mode, as tests/test_ce.py does."""
    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))


def _tokens(cfg, seed=1, batch=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size - 1, (batch, cfg.seq_len))


def _port_model(spec, params):
    model = spec.meta_init_fn().to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def test_presets_match_jax():
    assert tbert.BERT_PRESETS == jbert.BERT_PRESETS
    assert (tbert.MASK_STRIDE, tbert.MASK_OFFSET) == (jbert.MASK_STRIDE, jbert.MASK_OFFSET)
    spec = tbert.build_bert("bert-test-tiny")
    assert spec.config.causal is False and spec.fused_loss_objective == "mlm"
    assert tbert.mlm_loss.supports_fused_head == "mlm"
    with pytest.raises(KeyError, match="BERT preset"):
        tbert.build_bert("gpt2-small")


def test_logits_and_mlm_loss_match_jax_f32():
    jspec = jbert.build_bert("bert-test-tiny", dtype=jnp.float32, attention="dense")
    params = jspec.init_fn(jax.random.PRNGKey(0))
    tokens = _tokens(jspec.config)
    jlogits = jspec.apply_fn(params, jnp.asarray(tokens, jnp.int32))
    want_loss = float(jbert.mlm_loss(jlogits, jnp.asarray(tokens, jnp.int32)))

    tspec = tbert.build_bert("bert-test-tiny", dtype=torch.float32, attention="dense")
    model = _port_model(tspec, params)
    with torch.no_grad():
        logits = tspec.apply_fn(model, torch.tensor(tokens))
        loss = tbert.mlm_loss(logits, torch.tensor(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=F32, atol=F32)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=F32, atol=F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_mlm_loss_matches_logits_path(dtype):
    spec = tbert.build_bert("bert-test-tiny", dtype=dtype)
    model = spec.init_fn(torch.Generator().manual_seed(0))
    tokens = torch.tensor(_tokens(spec.config))
    with torch.no_grad():
        want = tbert.mlm_loss(spec.apply_fn(model, tokens), tokens)
        got = spec.fused_loss_fn(model, tokens)
        total, count = spec.fused_loss_parts_fn(model, tokens)
    torch.testing.assert_close(got, want, rtol=FUSED, atol=0)
    # 6 of every 7 positions are ignored
    T = spec.config.seq_len
    assert int(count) == 2 * sum(1 for t in range(T) if t % tbert.MASK_STRIDE == tbert.MASK_OFFSET)


def test_unmasked_positions_get_no_gradient():
    """The fused MLM loss only reaches the hidden states at masked positions."""
    spec = tbert.build_bert("bert-test-tiny", dtype=torch.float32)
    model = spec.init_fn(torch.Generator().manual_seed(0))
    tokens = torch.tensor(_tokens(spec.config))
    hidden = spec.hidden_fn(model, tokens).detach().requires_grad_(True)
    labels = torch.where(tbert._mask(tokens.shape[1], "cpu")[None, :], tokens, -1)
    tce.fused_linear_cross_entropy(hidden, model.wte, labels).backward()
    masked = tbert._mask(tokens.shape[1], "cpu")
    assert torch.count_nonzero(hidden.grad[:, ~masked]) == 0
    assert torch.count_nonzero(hidden.grad[:, masked]) > 0


def _loader():
    return make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                           n_tokens=64 * 4 * 8, reserved_ids=1)


def _bert_task(tmp_path, name="bert", lr=1e-3, batch_count=8, **kwargs):
    return sat.Task(
        get_model=lambda **kw: tbert.build_bert("bert-test-tiny", **kw),
        get_dataloader=_loader,
        loss_fn=tbert.mlm_loss,
        hparams=sat.HParams(lr=lr, batch_count=batch_count, kwargs=kwargs),
        name=name,
        save_dir=str(tmp_path),
    )


def test_dp_trajectory_matches_jax(tmp_path, jax_ce_interpret):
    spec = jbert.build_bert("bert-test-tiny", dtype=jnp.float32)
    jtask = JTask(get_model=lambda **kw: spec, get_dataloader=lambda: j_make_lm_dataset(
        context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8,
        reserved_ids=1), loss_fn=jbert.mlm_loss, hparams=JHParams(lr=1e-3, batch_count=8),
        save_dir=str(tmp_path / "jax"))
    ds = jtask.get_dataset()
    init_state, train_step = JDataParallel().make_step_fns(spec, jtask, {}, None, ds)
    state = init_state()
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(train_step)
    want = []
    for i in range(5):
        state, loss = step(state, jnp.asarray(ds.batch(i)))
        want.append(float(loss))

    task = _bert_task(tmp_path, dtype=torch.float32)
    tech = DataParallel()
    task.strategies[1] = sat.Strategy(tech, 1, {"remat": False}, 0.0)
    task.select_strategy(1)
    start = tech.build(task, CPU, {"remat": False}).empty()
    start["params"].load_state_dict(params_from_jax(params0))
    ckpt.save(task.ckpt_path, start)
    tech.execute(task, CPU, 0, override_batch_count=5)
    np.testing.assert_allclose(task.last_losses, want, rtol=TRAJ, atol=TRAJ)


def test_mixed_gpt2_bert_sweep_completes(tmp_path):
    sat.library.register_default_library()
    gpt = sat.Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **kw),
        get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4,
                                               vocab_size=256, n_tokens=64 * 4 * 8),
        loss_fn=pretraining_loss,
        hparams=sat.HParams(lr=1e-3, batch_count=6),
        name="gpt",
        save_dir=str(tmp_path),
    )
    tasks = [gpt, _bert_task(tmp_path, batch_count=6)]
    topo = SliceTopology([torch.device("cpu")])
    sat.search(tasks, technique_names=["dp"], topology=topo)
    out = sat.orchestrate(tasks, interval=4 * max(t.strategies[1].per_batch_time for t in tasks),
                          topology=topo)
    assert sorted(out["completed"]) == ["bert", "gpt"] and out["failed"] == {}
    for t in tasks:
        assert ckpt.load(t.ckpt_path)["step"] == t.hparams.batch_count
        assert np.isfinite(t.last_losses).all()
