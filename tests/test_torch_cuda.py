"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA card. On the card (which has no
JAX, hence no ``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

bf16 inputs. The flash kernels are held to their plain versions at the
bounds of ``chip_smoke.check_kernels`` (lse absolute, o within one bf16 step,
gradients by relative norm), the dQ kernel also at its edges (one tile to
walks of 32, D 64 and 128, grouped queries, a planted score per row in a
late kv tile); the end-to-end attention gradients in the bf16 band of
``tests/test_flash.py`` (2e-2). The CE kernels by relative norm,
the stash-mode dx and dW kernels at their edges (D tile widths, V and N that
no tile divides, ignored rows, the softmax part alone, a non-uniform g)
within the bound of ``chip_smoke.check_ce``; the CE forward at its edges (D
of 1 to 16 chunks, V and N that no tile divides, labels at the first, last
and ragged columns, a running max that moves across vocab tiles and splits)
within the bounds of ``chip_smoke.check_ce`` (loss and lse absolute, the
stash within one bf16 step).
"""

import numpy as np
import pytest
import torch

from saturn_tpu_torch.ops import ce, flash

BF16 = 2e-2
#: flash lse (f32, the same arithmetic in another order), absolute.
FLASH_LSE_ATOL = 1e-5
#: flash o: one bf16 step of the plain value (rtol 2^-7) plus this; both
#: versions round P to bf16, at different running maxima.
FLASH_O_ATOL = 2.0 ** -8
#: flash dq, dk and dv against their plain versions, by relative norm.
FLASH_GRAD_REL = 2e-3


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run with -m cuda on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "causal,H,KV,D,T",
    [(True, 4, 4, 64, 256), (False, 4, 2, 64, 256), (True, 8, 2, 128, 256),
     (False, 4, 4, 128, 256),
     # one tile; T % 128 == 64; head dim 128 with grouped queries
     (True, 4, 4, 64, 64), (False, 4, 2, 64, 64), (True, 4, 2, 64, 320),
     (False, 4, 4, 64, 320), (True, 8, 2, 128, 320), (False, 8, 2, 128, 320),
     (False, 8, 2, 128, 64)],
)
def test_kernels_match_plain(cuda_device, causal, H, KV, D, T):
    rng = np.random.default_rng(H + KV + D + T)

    def mk(n):
        return torch.tensor(rng.standard_normal((n, T, D)), dtype=torch.bfloat16,
                            device=cuda_device)

    q, k, v, do = mk(2 * H), mk(2 * KV), mk(2 * KV), mk(2 * H)
    before = dict(flash.LAUNCHES)
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    got = [o, lse, flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV),
           *flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV)]
    want = [*flash.flash_fwd_reference(q, k, v, causal, H, KV),
            flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV),
            *flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV)]
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=FLASH_LSE_ATOL)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2.0 ** -7,
                               atol=FLASH_O_ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert _rel_err(a, b) <= FLASH_GRAD_REL, (name, _rel_err(a, b))
    assert {n: flash.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 1)], ids=["mha", "gqa4"])
@pytest.mark.parametrize("D", [64, 128])
# one tile; three tiles (more than the ring's stages); walks of 5 and 32 tiles
@pytest.mark.parametrize("T", [64, 192, 320, 2048])
def test_flash_dq_edges(cuda_device, T, D, H, KV, causal):
    """The dQ kernel (dq_kernel) against flash_dq_reference, with lse and
    delta from the forward kernel on the same inputs. k has a scale that
    grows along D and v is drawn apart from k, so a descriptor that swaps or
    transposes an operand gives another result. Key 64 j of every head
    carries a w_j (w_j a unit vector per kv tile) and q row r carries a
    w_{j(r)}, with j(r) the row's diagonal tile (causal) or the last tile,
    both scaled by a = ((ln T + 3) sqrt(D))^(1/2): one planted score of
    ln T + 3 per row in the latest kv tile it sees, so P is near 1 there
    (median 0.85-0.95) and near 0 elsewhere. Not higher: with P at 1, dS =
    P (dP - delta) cancels to rounding noise."""
    B, a = 2, ((np.log(T) + 3) * D ** 0.5) ** 0.5
    rng = np.random.default_rng(T + D + H + KV + causal)
    n_t = T // 64
    w = rng.standard_normal((n_t, D))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    q = rng.standard_normal((B * H, T, D))
    k = rng.standard_normal((B * KV, T, D)) * np.linspace(0.5, 1.5, D)
    v = rng.standard_normal((B * KV, T, D))
    do = rng.standard_normal((B * H, T, D))
    k[:, ::64] = a * w
    target = np.arange(T) // 64 if causal else np.full(T, n_t - 1)
    q += a * w[target]
    q, k, v, do = (torch.tensor(x, dtype=torch.bfloat16, device=cuda_device)
                   for x in (q, k, v, do))
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    before = flash.LAUNCHES["flash_dq"]
    dq = flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV)
    launched = flash.LAUNCHES["flash_dq"] - before
    want = flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16 and launched == 1
    assert torch.isfinite(dq.float()).all()
    assert _rel_err(dq, want) <= FLASH_GRAD_REL, _rel_err(dq, want)
    # P at the planted key, from the forward kernel's lse: near 1 for most rows
    kv_of = (torch.arange(B * H, device=cuda_device) // H) * KV + (
        torch.arange(B * H, device=cuda_device) % H) // (H // KV)
    planted = torch.as_tensor(target * 64, device=cuda_device)
    s = (q.float() * k[kv_of][:, planted].float()).sum(-1) / D ** 0.5
    assert torch.exp(s - lse).median().item() >= 0.8


@pytest.mark.cuda
def test_attention_grads_match_reference(cuda_device):
    """flash_attention's autograd (the three kernels) against the plain
    reference's autograd, GQA, causal."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                            device=cuda_device, requires_grad=True)
               for s in ((2, 8, 512, 64), (2, 2, 512, 64), (2, 2, 512, 64)))
    g = torch.tensor(rng.standard_normal((2, 8, 512, 64)), dtype=torch.bfloat16,
                     device=cuda_device)
    out = []
    for fn in (flash.flash_attention, flash.flash_attention_reference):
        o = fn(q, k, v, causal=True)
        out.append([o, *torch.autograd.grad(o, (q, k, v), g)])
    for a, b in zip(*out):
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16, atol=BF16)


@pytest.mark.cuda
def test_restore_keeps_optimizer_steps_on_the_host(cuda_device, tmp_path):
    """A restored AdamW keeps its moments on the card and its step counts on
    the host, as a fresh one does (a step count on the card costs one
    readback per parameter per step)."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    def state():
        model = torch.nn.Linear(8, 8, device=cuda_device)
        return {"params": model, "opt_state": torch.optim.AdamW(model.parameters()),
                "step": 0}

    s = state()
    s["params"](torch.ones(2, 8, device=cuda_device)).sum().backward()
    s["opt_state"].step()
    ckpt.save(str(tmp_path / "ckpt.pt"), s)
    restored = ckpt.restore(str(tmp_path / "ckpt.pt"), state())
    for per_param in restored["opt_state"].state.values():
        assert per_param["step"].device.type == "cpu"
        assert per_param["exp_avg"].device == cuda_device
        assert per_param["exp_avg_sq"].device == cuda_device


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 2, 128, 64, device=cuda_device)  # float32
    with pytest.raises(TypeError, match="bfloat16"):
        flash.flash_attention(q, q, q)
    q = q.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="tile"):
        flash.flash_attention(q, q, q, block_q=128, block_k=128)


def _ce_case(N, D, V, device, seed=0, tail=40):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((N, D)) * 0.5, dtype=torch.bfloat16, device=device)
    w = torch.tensor(rng.standard_normal((V, D)) * 0.5, dtype=torch.bfloat16, device=device)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[N - tail:] = -1  # a tail of ignored rows
    return x, w, torch.tensor(labels, device=device)


#: CE loss and lse (f32, the same arithmetic in another order), absolute.
CE_ROW_ATOL = 1e-4
#: CE dx and dW against their plain versions (the same bf16 rounding of ds),
#: by relative norm.
CE_GRAD_REL = 1e-2


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize("D,V", [(64, 300), (128, 1000), (64, 1000), (128, 300)])
def test_ce_kernels_match_plain(cuda_device, stash, D, V):
    """Each CE kernel against its plain version, with g = 1 per counted row
    (the cotangent of a summed loss) so the gradients are O(1); dx and dW
    once with the labels and once with every label ignored and g = 1 (the
    softmax part alone, which the one-hot term would otherwise hide)."""
    N, tail = 256, 40
    x, w, labels = _ce_case(N, D, V, cuda_device, seed=D + V, tail=tail)
    g = (labels >= 0).float()
    none, ones = torch.full_like(labels, -1), torch.ones_like(g)
    before = dict(ce.LAUNCHES)
    loss, lse, s = ce.ce_fwd(x, w, labels, stash)
    dx = ce.ce_dx(x, w, labels, lse, g, s)
    dw = ce.ce_dw(x, w, labels, lse, g, s)
    launched = {n: ce.LAUNCHES[n] - before[n] for n in before}
    soft = (ce.ce_dx(x, w, none, lse, ones, s), ce.ce_dw(x, w, none, lse, ones, s))
    loss_r, lse_r, s_r = ce.ce_fwd_reference(x, w, labels, stash)
    dx_r = ce.ce_dx_reference(x, w, labels, lse, g, s_r)
    dw_r = ce.ce_dw_reference(x, w, labels, lse, g, s_r)
    soft_r = (ce.ce_dx_reference(x, w, none, lse, ones, s_r),
              ce.ce_dw_reference(x, w, none, lse, ones, s_r))
    torch.cuda.synchronize()
    for name, a, b in (("loss", loss, loss_r), ("lse", lse, lse_r)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=CE_ROW_ATOL,
                                   msg=lambda m: f"{name}: {m}")
    if stash:  # one bf16 step of the plain value
        torch.testing.assert_close(s.float(), s_r.float(), rtol=2.0 ** -7, atol=CE_ROW_ATOL)
    for name, a, b in (("dx", dx, dx_r), ("dw", dw, dw_r), ("softmax dx", soft[0], soft_r[0]),
                       ("softmax dw", soft[1], soft_r[1])):
        assert _rel_err(a, b) <= CE_GRAD_REL, (name, _rel_err(a, b))
    # the counted rows get a gradient, the ignored tail nothing
    assert (dx[:N - tail].float().abs().sum(1) > 0).all()
    assert torch.count_nonzero(dx[-tail:]) == 0
    assert (dw.abs().sum(1) > 0).all() and (soft[1].abs().sum(1) > 0).all()
    assert launched == {"ce_fwd": 1, "ce_dx": 1, "ce_dw": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize(
    "N,D,V",
    # D of 1, 2, 3, 5, 12 and 16 chunks of 64; V of one partial vocab tile
    # (200), a partial second tile (300), four tiles (1000) and GPT-2's vocab
    # (50257: split over blocks, its last tile partial); N below one token
    # tile, two tiles, and 31 tiles with a ragged 32 rows
    [(100, 64, 200), (256, 128, 300), (100, 192, 1000), (256, 320, 1000), (256, 768, 300),
     (100, 1024, 200), (4000, 768, 50257), (4000, 64, 50257), (256, 1024, 50257)],
)
def test_ce_fwd_edges(cuda_device, N, D, V, stash):
    """The forward kernel (ce_fwd_sm90_kernel) against ce_fwd_reference. x has
    a scale that grows along D and W another, so a descriptor that swaps or
    transposes an operand gives another result. Rows r with r % 4 == k carry
    10 u_k (u_k a unit vector), which W's planted column c_k = V (5 + k) / 8
    - 1, equal to u_k, picks up: one large logit per row in a late vocab tile,
    so the running max moves across tiles and, at V 50257, across vocab
    splits. Labels at column 0, at V - 1, inside the last partial vocab tile
    and at a planted column, an ignored tail of N / 8 rows."""
    rng = np.random.default_rng(N + D + V)
    u = rng.standard_normal((4, D))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    planted = [V * (5 + k) // 8 - 1 for k in range(4)]
    x_np = rng.standard_normal((N, D)) * np.linspace(0.5, 1.5, D) + 10.0 * u[np.arange(N) % 4]
    w_np = rng.standard_normal((V, D)) * 0.05
    w_np[planted] = u
    labels_np = rng.integers(0, V, N).astype(np.int32)
    labels_np[:4] = [0, V - 1, (V - 1) // 256 * 256 + V % 256 // 2, planted[3]]
    tail = N // 8
    labels_np[N - tail:] = -1
    x = torch.tensor(x_np, dtype=torch.bfloat16, device=cuda_device)
    w = torch.tensor(w_np, dtype=torch.bfloat16, device=cuda_device)
    labels = torch.tensor(labels_np, device=cuda_device)
    before = ce.LAUNCHES["ce_fwd"]
    loss, lse, s = ce.ce_fwd(x, w, labels, stash)
    launched = ce.LAUNCHES["ce_fwd"] - before
    loss_r, lse_r, s_r = ce.ce_fwd_reference(x, w, labels, stash)
    torch.cuda.synchronize()
    assert launched == 1
    for t in (loss, lse):
        assert t.shape == (N,) and t.dtype == torch.float32 and torch.isfinite(t).all()
    torch.testing.assert_close(lse, lse_r, rtol=0.0, atol=CE_ROW_ATOL)
    torch.testing.assert_close(loss, loss_r, rtol=0.0, atol=CE_ROW_ATOL)
    # the planted logit (about 10) is the max of nearly every row
    top = (x.float() @ w.float().t()).argmax(1).cpu().numpy()
    assert np.mean(top == np.asarray(planted)[np.arange(N) % 4]) >= 0.9
    assert torch.equal(loss[N - tail:], lse[N - tail:])  # an ignored row's label logit is 0
    if stash:
        assert s.shape == (N, V) and s.dtype == torch.bfloat16
        torch.testing.assert_close(s.float(), s_r.float(), rtol=2.0 ** -7, atol=CE_ROW_ATOL)
    else:
        assert s is None and s_r is None


#: The stash-mode dW kernel against its plain version on the same stash, by
#: relative norm (the bound of ``chip_smoke.check_ce``).
CE_DW_REL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tail", "softmax", "random_g"])
@pytest.mark.parametrize(
    "N,D,V",
    # D tiles of 64, 128, 256 (3 and 4 of them), 192 and 64 (of D 320); V and
    # N that no tile or token chunk divides
    [(256, 64, 300), (256, 128, 1000), (256, 768, 1000), (256, 1024, 300),
     (100, 192, 1000), (100, 320, 300), (4000, 768, 50257)],
)
def test_ce_dw_stash_edges(cuda_device, N, D, V, mode):
    """The stash-mode dW kernel (ce_dw_sm90_kernel) against ce_dw_reference
    on the kernel's own stash, with an ignored tail and g = 1 per counted row
    (``tail``), every label ignored and g = 1 (``softmax``: the softmax part
    alone), or a random non-uniform g (``random_g``). x has a scale that
    grows along D and W another, so a descriptor that swaps or transposes an
    operand gives another result."""
    rng = np.random.default_rng(N + D + V)
    x = torch.tensor(rng.standard_normal((N, D)) * np.linspace(1.0, 2.0, D),
                     dtype=torch.bfloat16, device=cuda_device)
    w = torch.tensor(rng.standard_normal((V, D)) * 0.05, dtype=torch.bfloat16,
                     device=cuda_device)
    labels_np = rng.integers(0, V, N).astype(np.int32)
    labels_np[N - N // 8:] = -1
    g_np = (labels_np >= 0).astype(np.float32)
    if mode == "softmax":
        labels_np[:], g_np[:] = -1, 1.0
    elif mode == "random_g":
        g_np *= rng.uniform(0.1, 2.0, N).astype(np.float32)
    labels = torch.tensor(labels_np, device=cuda_device)
    g = torch.tensor(g_np, device=cuda_device)
    _, lse, s = ce.ce_fwd(x, w, labels, True)
    before = ce.LAUNCHES["ce_dw"]
    dw = ce.ce_dw(x, w, labels, lse, g, s)
    launched = ce.LAUNCHES["ce_dw"] - before
    want = ce.ce_dw_reference(x, w, labels, lse, g, s)
    torch.cuda.synchronize()
    assert dw.shape == (V, D) and dw.dtype == torch.float32 and launched == 1
    assert torch.isfinite(dw).all()
    assert _rel_err(dw, want) <= CE_DW_REL, _rel_err(dw, want)
    assert (dw.abs().sum(1) > 0).all()


#: The stash-mode dx kernel against its plain version on the same stash, by
#: relative norm (the bound of ``chip_smoke.check_ce``).
CE_DX_REL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tail", "softmax", "random_g"])
@pytest.mark.parametrize(
    "N,D,V",
    # D tiles of 64, 128, 256 (3 and 4 of them), 192 and 64 (of D 320); V and
    # N that no vocab chunk or token tile divides
    [(256, 64, 300), (256, 128, 1000), (256, 768, 1000), (256, 1024, 300),
     (100, 192, 1000), (100, 320, 300), (4000, 768, 50257)],
)
def test_ce_dx_stash_edges(cuda_device, N, D, V, mode):
    """The stash-mode dx kernel (ce_dx_sm90_kernel) against ce_dx_reference
    on the kernel's own stash, with an ignored tail and g = 1 per counted row
    (``tail``), every label ignored and g = 1 (``softmax``: the softmax part
    alone), or a random non-uniform g (``random_g``). x has a scale that
    grows along D and W another, so a descriptor that swaps or transposes an
    operand gives another result."""
    rng = np.random.default_rng(N + D + V)
    x = torch.tensor(rng.standard_normal((N, D)) * np.linspace(1.0, 2.0, D),
                     dtype=torch.bfloat16, device=cuda_device)
    w = torch.tensor(rng.standard_normal((V, D)) * 0.05, dtype=torch.bfloat16,
                     device=cuda_device)
    labels_np = rng.integers(0, V, N).astype(np.int32)
    tail = N // 8
    labels_np[N - tail:] = -1
    g_np = (labels_np >= 0).astype(np.float32)
    if mode == "softmax":
        labels_np[:], g_np[:] = -1, 1.0
    elif mode == "random_g":
        g_np *= rng.uniform(0.1, 2.0, N).astype(np.float32)
    labels = torch.tensor(labels_np, device=cuda_device)
    g = torch.tensor(g_np, device=cuda_device)
    _, lse, s = ce.ce_fwd(x, w, labels, True)
    before = ce.LAUNCHES["ce_dx"]
    dx = ce.ce_dx(x, w, labels, lse, g, s)
    launched = ce.LAUNCHES["ce_dx"] - before
    want = ce.ce_dx_reference(x, w, labels, lse, g, s)
    torch.cuda.synchronize()
    assert dx.shape == (N, D) and dx.dtype == torch.bfloat16 and launched == 1
    assert torch.isfinite(dx.float()).all()
    assert _rel_err(dx, want) <= CE_DX_REL, _rel_err(dx, want)
    counted = N if mode == "softmax" else N - tail
    assert (dx[:counted].float().abs().sum(1) > 0).all()
    assert torch.count_nonzero(dx[counted:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_fused_ce_grads_match_dense(cuda_device, stash):
    """fused_linear_cross_entropy's autograd (the three kernels) against the
    dense op's autograd, f32 head weight as on the training path. The dense
    op keeps the softmax gradient in f32 where the kernels round it to bf16:
    the gradients agree by relative norm within the bf16 band."""
    x, w, labels = _ce_case(512, 128, 1000, cuda_device, seed=7)
    out = []
    for fn, kw in ((ce.fused_linear_cross_entropy, {"stash": stash}),
                   (ce.dense_linear_cross_entropy, {})):
        xg = x.detach().clone().requires_grad_(True)
        wg = w.float().detach().clone().requires_grad_(True)
        loss = fn(xg, wg, labels, **kw)
        out.append([loss, *torch.autograd.grad(loss, (xg, wg))])
    (loss, dx, dw), (loss_r, dx_r, dw_r) = out
    assert dw.dtype == torch.float32
    torch.testing.assert_close(loss, loss_r, rtol=0.0, atol=CE_ROW_ATOL)
    for name, a, b in (("dx", dx, dx_r), ("dw", dw, dw_r)):
        assert _rel_err(a, b) <= BF16, (name, _rel_err(a, b))
    assert (dx[:-40].float().abs().sum(1) > 0).all() and torch.count_nonzero(dx[-40:]) == 0
    assert (dw.abs().sum(1) > 0).all()


@pytest.mark.cuda
def test_ce_rejects_what_the_kernels_do_not_take(cuda_device):
    x, w, labels = _ce_case(128, 64, 300, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ce.ce_fwd(x.float(), w, labels, True)
    with pytest.raises(ValueError, match="d_model"):
        ce.ce_fwd(x[:, :48].contiguous(), w[:, :48].contiguous(), labels, True)
    with pytest.raises(NotImplementedError, match="tile"):
        ce.fused_linear_cross_entropy(x, w, labels, block_n=64)
    # every tensor on the card of x: labels, the row statistics, the stash
    with pytest.raises(ValueError, match="must be on"):
        ce.ce_fwd(x, w, labels.cpu(), True)
    with pytest.raises(ValueError, match="must be on"):
        ce.fused_linear_cross_entropy(x, w.float(), labels.cpu())
    loss, lse, s = ce.ce_fwd(x, w, labels, True)
    g = (labels >= 0).float()
    with pytest.raises(ValueError, match="must be on"):
        ce.ce_dx(x, w, labels, lse.cpu(), g, s)
    with pytest.raises(ValueError, match="must be on"):
        ce.ce_dw(x, w, labels, lse, g.cpu(), s)
    with pytest.raises(ValueError, match="must be on"):
        ce.ce_dw(x, w, labels, lse, g, s.cpu())
