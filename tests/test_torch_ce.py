"""The port's fused linear-cross-entropy head against the JAX package's.

The JAX side runs its Pallas CE kernels as ``tests/test_ce.py`` runs them on
the CPU: in interpret mode with ``block_n=64, block_v=128``. The port's
wrappers take their plain versions on CPU tensors; in stash mode these round
the logits to bf16 where the kernel's stash does. Inputs come from a numpy
seed. Tolerances, each no looser than the band of ``tests/test_ce.py``:

- loss: rtol 1e-5 (f32 sums in another order; the JAX band is 2e-3);
- f32 gradients, recompute mode: rtol 1e-4, atol 1e-6 (f32 scores on both
  sides; the JAX band is 2e-3 / 1e-5);
- f32 gradients, stash mode, and every bf16 gradient: rtol 2e-2, atol 3e-4,
  the JAX stash band (a logit whose f32 value lies next to a bf16 rounding
  boundary may round the other way, and bf16 results differ by one ulp).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saturn_tpu.models import gpt2 as jgpt2
from saturn_tpu.ops import ce as jce
from saturn_tpu_torch import HParams
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.ops import ce as tce
from saturn_tpu_torch.parallel.dp import DataParallel

LOSS = dict(rtol=1e-5, atol=0)
RECOMPUTE = dict(rtol=1e-4, atol=1e-6)
BAND = dict(rtol=2e-2, atol=3e-4)


def _case(n=128, d=64, v=256, masked=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[n - masked:] = -1
    return x, w, labels


def _jax(x, w, labels, dtype, **kw):
    def f(a, b):
        return jce.fused_linear_cross_entropy(a, b, jnp.asarray(labels), block_n=64,
                                              block_v=128, interpret=True, **kw)

    loss, grads = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x, dtype),
                                                       jnp.asarray(w))
    return [np.asarray(a, np.float32) for a in (loss, *grads)]


def _torch(x, w, labels, dtype, **kw):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = tce.fused_linear_cross_entropy(xt, wt, torch.tensor(labels), **kw)
    loss.backward()
    assert xt.grad.dtype == dtype and wt.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (loss, xt.grad, wt.grad)]


# v 300 is not a multiple of the JAX vocab block: its kernels pad and mask
@pytest.mark.parametrize("v", [256, 300])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax(v, stash, dtype):
    x, w, labels = _case(v=v, seed=v)
    want = _jax(x, w, labels, getattr(jnp, dtype), stash=stash)
    got = _torch(x, w, labels, getattr(torch, dtype), stash=stash)
    grad_tol = RECOMPUTE if (dtype == "float32" and not stash) else BAND
    for name, a, b, tol in zip(("loss", "dx", "dw"), got, want, (LOSS, grad_tol, grad_tol)):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


#: The JAX op's (block_n, block_v, bn_dw, bv_dw) in these tests.
JAX_BLOCKS = (64, 128, 64, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_versions_match_jax_vjp_under_random_g(dtype):
    """ce_dx_reference and ce_dw_reference, on the stash and lse of
    ce_fwd_reference, against the VJP of the JAX ``_fused_ce`` (its Pallas
    kernels in interpret mode) in stash mode at V 300 (ragged against the
    vocab block), under a non-uniform per-token cotangent g, 0 on the ignored
    rows: every other case here takes the mean's uniform g."""
    v = 300
    x, w, labels = _case(v=v, seed=11)
    g = (np.random.default_rng(12).uniform(0.1, 2.0, len(labels)) * (labels >= 0))
    g = g.astype(np.float32)
    lab_j = jnp.asarray(labels)[:, None]
    _, vjp = jax.vjp(lambda a, b: jce._fused_ce(a, b, lab_j, JAX_BLOCKS, v, True, True),
                     jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g)[:, None])]

    xt = torch.tensor(x, dtype=getattr(torch, dtype))
    wc, lab, gt = torch.tensor(w).to(xt.dtype), torch.tensor(labels), torch.tensor(g)
    _, lse, s = tce.ce_fwd_reference(xt, wc, lab, stash=True)
    dx = tce.ce_dx_reference(xt, wc, lab, lse, gt, s)
    dw = tce.ce_dw_reference(xt, wc, lab, lse, gt, s)
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32
    for name, a, b in (("dx", dx, want[0]), ("dw", dw, want[1])):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name, **BAND)


def test_plain_versions_match_dense():
    """Each plain kernel version against autograd through the dense op."""
    x, w, labels = _case(v=300, seed=3)
    xt, wt, lab = torch.tensor(x), torch.tensor(w), torch.tensor(labels)
    loss, lse, _ = tce.ce_fwd_reference(xt, wt, lab, stash=False)
    valid = lab >= 0
    g = valid.float() / valid.sum()
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    tce.dense_linear_cross_entropy(xr, wr, lab).backward()
    torch.testing.assert_close((loss * g).sum(), tce.dense_linear_cross_entropy(xt, wt, lab),
                               **LOSS)
    torch.testing.assert_close(tce.ce_dx_reference(xt, wt, lab, lse, g), xr.grad, **RECOMPUTE)
    torch.testing.assert_close(tce.ce_dw_reference(xt, wt, lab, lse, g), wr.grad, **RECOMPUTE)


def test_batch_shaped_input():
    x, w, labels = _case(n=128)
    flat = tce.fused_linear_cross_entropy(torch.tensor(x), torch.tensor(w), torch.tensor(labels))
    batched = tce.fused_linear_cross_entropy(torch.tensor(x).reshape(2, 64, -1), torch.tensor(w),
                                             torch.tensor(labels).reshape(2, 64))
    torch.testing.assert_close(batched, flat, rtol=1e-6, atol=0)


def test_sum_count_matches_jax():
    x, w, labels = _case(masked=24)
    total, count = tce.fused_linear_cross_entropy(torch.tensor(x), torch.tensor(w),
                                                  torch.tensor(labels), reduction="sum_count")
    want_total, want_count = jce.fused_linear_cross_entropy(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), block_n=64, block_v=128,
        interpret=True, reduction="sum_count")
    assert int(count) == int(want_count) == 128 - 24
    np.testing.assert_allclose(float(total), float(want_total), **LOSS)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_masked_rows_have_zero_gradient(stash):
    x, w, labels = _case(masked=16)
    xt = torch.tensor(x, requires_grad=True)
    tce.fused_linear_cross_entropy(xt, torch.tensor(w), torch.tensor(labels),
                                   stash=stash).backward()
    assert torch.count_nonzero(xt.grad[-16:]) == 0
    assert torch.count_nonzero(xt.grad[:-16]) > 0


def test_rejects_what_jax_rejects():
    x, w, labels = (torch.tensor(a) for a in _case())
    with pytest.raises(ValueError, match="ignore_index"):
        tce.fused_linear_cross_entropy(x, w, labels, ignore_index=0)
    with pytest.raises(ValueError, match="reduction"):
        tce.fused_linear_cross_entropy(x, w, labels, reduction="sum")


def test_cpu_tensors_launch_nothing():
    tce.reset_launch_counts()
    x, w, labels = _case()
    xt = torch.tensor(x, requires_grad=True)
    tce.fused_linear_cross_entropy(xt, torch.tensor(w), torch.tensor(labels)).backward()
    assert tce.LAUNCHES == {"ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


def test_ce_supported_off_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tce.ce_supported()
    assert not tce.ce_supported(tgpt2.config_for("gpt2-small"))
    # without a card the specs offer the fused loss through the plain version
    assert tgpt2.build_gpt2("test-tiny").fused_loss_fn is not None


def test_f32_on_the_card_keeps_the_logits_path(monkeypatch):
    """ce_supported decides by rule: a capable card with f32 compute gets no
    fused loss, bf16 compute gets it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    assert tgpt2.build_gpt2("test-tiny", dtype=torch.float32).fused_loss_fn is None
    spec = tgpt2.build_gpt2("test-tiny")
    assert spec.fused_loss_fn is not None and spec.fused_loss_objective == "causal-lm"


# ------------------------------------------------------------- GPT-2 spec
def _tokens(cfg, seed=1, batch=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, cfg.seq_len))


def test_gpt2_fused_loss_matches_logits_path():
    spec = tgpt2.build_gpt2("test-tiny")
    model = spec.init_fn(torch.Generator().manual_seed(0))
    tokens = torch.tensor(_tokens(spec.config))
    with torch.no_grad():
        want = pretraining_loss(spec.apply_fn(model, tokens), tokens)
        got = spec.fused_loss_fn(model, tokens)
        total, count = spec.fused_loss_parts_fn(model, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert int(count) == 2 * (spec.config.seq_len - 1)
    torch.testing.assert_close(total / count, got, rtol=1e-6, atol=0)


def test_gpt2_fused_loss_and_wte_grad_match_jax(monkeypatch):
    """Same params (through params_from_jax), same tokens, f32 compute; the
    JAX spec's fused loss runs its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))
    jspec = jgpt2.build_gpt2("test-tiny", dtype=jnp.float32)
    params = jspec.init_fn(jax.random.PRNGKey(0))
    tokens = _tokens(jspec.config)
    want, grads = jax.value_and_grad(jspec.fused_loss_fn)(params, jnp.asarray(tokens, jnp.int32))

    tspec = tgpt2.build_gpt2("test-tiny", dtype=torch.float32)
    model = tspec.meta_init_fn().to_empty(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = tspec.fused_loss_fn(model, torch.tensor(tokens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS)
    np.testing.assert_allclose(model.wte.grad.numpy(), np.asarray(grads["wte"]), **BAND)


def _routed_losses(spec, loss_fn, technique=None):
    """Run one port train step of ``spec`` under ``loss_fn``; returns how many
    times the fused loss ran."""
    calls = {"fused": 0}
    orig = spec.fused_loss_fn
    if orig is not None:
        def counting(model, tokens):
            calls["fused"] += 1
            return orig(model, tokens)

        spec.fused_loss_fn = counting
    task = types.SimpleNamespace(loss_fn=loss_fn, hparams=HParams(lr=1e-3, batch_count=1))
    tech = technique or DataParallel()
    init_state, step = tech.step_fns_from_forward(spec, task, spec.apply_fn,
                                                  device=torch.device("cpu"))
    tokens = torch.tensor(_tokens(spec.config, batch=2))
    _, loss = step(init_state(), tokens)
    assert torch.isfinite(loss)
    return calls["fused"]


def test_dp_step_routes_pretraining_loss_through_the_fused_head():
    assert _routed_losses(tgpt2.build_gpt2("test-tiny"), pretraining_loss) == 1


def test_untagged_loss_keeps_the_logits_path():
    assert _routed_losses(tgpt2.build_gpt2("test-tiny"),
                          lambda lg, t: pretraining_loss(lg, t)) == 0


def test_technique_without_fused_loss_keeps_the_logits_path():
    class NoFused(DataParallel):
        fused_loss_ok = False

    assert _routed_losses(tgpt2.build_gpt2("test-tiny"), pretraining_loss, NoFused()) == 0


def test_bert_routes_mlm_loss_only():
    """A BERT spec driven with pretraining_loss keeps the logits path: the
    objective tags differ (JAX ``test_ce.py::test_objective_tag_mismatch_
    keeps_logits_path``); driven with mlm_loss it takes the fused head."""
    from saturn_tpu_torch.models.bert import build_bert, mlm_loss

    assert _routed_losses(build_bert("bert-test-tiny"), pretraining_loss) == 0
    assert _routed_losses(build_bert("bert-test-tiny"), mlm_loss) == 1
