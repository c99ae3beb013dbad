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


def _jax_auto_stash(N, V, D, block_v=None):
    """The JAX package's ``stash=None`` decision (JAX ``ce.py:454-492``),
    from its own block choice and ``_padded_vocab``."""
    if block_v is not None:
        bv = bv_dw = block_v
    elif V >= 2048:
        bv, bv_dw = 512, jce._auto_bv_dw(D)
    else:
        bv = bv_dw = ((V + 127) // 128) * 128
    return N * jce._padded_vocab(V, (None, bv, None, bv_dw)) * 2 <= jce.STASH_BYTES_MAX


@pytest.mark.parametrize("V,D,block_v", [
    (50304, 768, None), (50304, 1024, None), (50257, 1600, None), (32000, 4096, None),
    (256, 64, None), (300, 64, None), (1999, 128, None), (2048, 768, None),
    (50304, 768, 128), (300, 64, 128),
])
def test_auto_stash_matches_jax(V, D, block_v):
    """The auto stash decision equals the JAX package's, across the N where
    the padded vocab moves it (GPT-2's 50304 pads to 51200 at D 768: N 5243
    to 5336 recompute in both)."""
    edge = tce.STASH_BYTES_MAX // (2 * V)
    Ns = sorted({1, 4096, 5242, 5243, 5300, 5336, 5337, 8192, 65536,
                 edge - 1, edge, edge + 1, tce.STASH_BYTES_MAX // (2 * tce.padded_vocab(V, D, block_v))})
    for N in Ns:
        assert tce.auto_stash(N, V, D, block_v) == _jax_auto_stash(N, V, D, block_v), (N, V, D)
    if (V, D, block_v) == (50304, 768, None):
        assert [tce.auto_stash(N, V, D) for N in (5242, 5243, 5300, 5336)] == [
            True, False, False, False]


# ------------------------------------------------ recompute mode's vocab slabs
@pytest.mark.parametrize("N,V,want,last", [
    (4096, 50304, 16384, 1152),   # at the cap: 4096 x 16384 x 2 bytes = 128 MiB
    (8192, 50304, 8192, 1152),    # GPT-2-small at b8 x 1024
    (6000, 50257, 11008, 6225),   # 43 tiles fit, not 44; a ragged last slab
    (128, 50304, 50432, 50304),   # the whole vocab in one slab (rounded up to a tile)
    (64, 300, 512, 300),
    (64, 100, 256, 100),          # a vocab smaller than one tile
    (1 << 20, 50304, 256, 128),   # at least one tile, even past the cap
])
def test_slab_width(N, V, want, last):
    """The largest multiple of SLAB_COLS whose bf16 (N, slab) scratch fits
    in SLAB_BYTES_MAX, no wider than the vocab rounded up to a tile, at
    least one tile; ``last`` is the width of the last slab."""
    vs = tce.slab_width(N, V)
    assert vs == want and vs % tce.SLAB_COLS == 0
    assert vs == tce.SLAB_COLS or N * vs * 2 <= tce.SLAB_BYTES_MAX
    assert vs >= V or N * (vs + tce.SLAB_COLS) * 2 > tce.SLAB_BYTES_MAX
    assert V - (-(-V // vs) - 1) * vs == last


def test_ds_slabs_tile_the_softmax_gradient():
    """ce_ds_slab (its plain version on CPU tensors) over consecutive slabs,
    side by side, is the gradient of the g-weighted per-token loss with
    respect to the f32 logits, from autograd: (softmax - onehot(label)) g,
    labels at the slab edges, ignored rows 0."""
    v, vs = 1000, 256
    x, w, labels = _case(v=v, seed=21)
    labels[:4] = [0, 255, 256, 999]
    g = (np.random.default_rng(22).uniform(0.1, 2.0, len(labels)) * (labels >= 0))
    xt, wt, lab, gt = (torch.tensor(a) for a in (x, w, labels, g.astype(np.float32)))
    logits = (xt @ wt.t()).requires_grad_()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, lab.long().clamp_min(0)[:, None])[:, 0]
    ((lse - picked) * gt).sum().backward()
    got = torch.cat([tce.ce_ds_slab(xt, wt, lab, lse.detach(), gt, v0, min(v, v0 + vs))
                     for v0 in range(0, v, vs)], dim=1)
    torch.testing.assert_close(got, logits.grad, **RECOMPUTE)


def _slab_backward(x, w, labels, lse, g, vs):
    """dx and dW as the recompute-mode kernels form them: per vocab slab of
    ``vs`` columns the slab's ds (ce_ds_slab), dx's slab products summed in
    slab order in f32, each slab's dW rows written at their offset."""
    N, V = x.shape[0], w.shape[0]
    dx = torch.zeros((N, x.shape[1]))
    dw = torch.empty((V, x.shape[1]))
    for v0 in range(0, V, vs):
        v1 = min(V, v0 + vs)
        ds = tce.ce_ds_slab(x, w, labels, lse, g, v0, v1).float()
        dx += ds @ w[v0:v1].float()
        dw[v0:v1] = ds.t() @ x.float()
    return dx.to(x.dtype), dw


@pytest.mark.parametrize("v", [300, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_backward_matches_plain_and_jax_recompute_vjp(monkeypatch, dtype, v):
    """Slab by slab (the cap set to one tile: 2 slabs at V 300, 4 at V 1000,
    the last ragged), under a non-uniform g, 0 on the ignored rows, and
    labels at the slab edges: dx and dW equal ce_dx_reference /
    ce_dw_reference and the VJP of the JAX ``_fused_ce`` in recompute mode
    (its Pallas kernels in interpret mode)."""
    x, w, labels = _case(v=v, seed=v + 1)
    monkeypatch.setattr(tce, "SLAB_BYTES_MAX", 2 * len(labels) * tce.SLAB_COLS)
    vs = tce.slab_width(len(labels), v)
    assert vs == tce.SLAB_COLS and -(-v // vs) == (2 if v == 300 else 4)
    edges = [c for v0 in range(0, v, vs) for c in (v0, min(v, v0 + vs) - 1)]
    labels[:len(edges)] = edges
    g = (np.random.default_rng(v + 2).uniform(0.1, 2.0, len(labels)) * (labels >= 0))
    g = g.astype(np.float32)
    lab_j = jnp.asarray(labels)[:, None]
    _, vjp = jax.vjp(lambda a, b: jce._fused_ce(a, b, lab_j, JAX_BLOCKS, v, True, False),
                     jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g)[:, None])]

    xt = torch.tensor(x, dtype=getattr(torch, dtype))
    wc, lab, gt = torch.tensor(w).to(xt.dtype), torch.tensor(labels), torch.tensor(g)
    _, lse, _ = tce.ce_fwd_reference(xt, wc, lab, stash=False)
    dx, dw = _slab_backward(xt, wc, lab, lse, gt, vs)
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32
    tol = RECOMPUTE if dtype == "float32" else BAND
    plain = (tce.ce_dx_reference(xt, wc, lab, lse, gt), tce.ce_dw_reference(xt, wc, lab, lse, gt))
    for name, got, ref, jax_ref in (("dx", dx, plain[0], want[0]), ("dw", dw, plain[1], want[1])):
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), err_msg=name, **tol)
        np.testing.assert_allclose(got.float().numpy(), jax_ref, err_msg=name, **tol)
