"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA card. On the card (which has no
JAX, hence no ``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

bf16 inputs. The flash kernels are held to their plain versions at the
bounds of ``chip_smoke.check_kernels`` (lse absolute, o within one bf16 step,
gradients by relative norm), the dQ kernel also at its edges (one tile to
walks of 32, D 64 and 128, grouped queries, a planted score per row in a
late kv tile), the head-dim-256 forward (``fwd_pingpong_kernel``) at its
edges (one tile, T % 128 == 64 with grouped queries, walks of 16, a grid of
four blocks), with dQ and dK/dV on its lse, and run twice bitwise equal;
the head-dim-256 dK/dV (``dkv_wide_kernel``) and dQ (``dq_wide_kernel``)
at the same edges and at walks of 32 and grids where each persistent block
walks several tiles, with a planted score per row in a late kv tile, and
run twice bitwise equal;
the end-to-end attention gradients in the bf16 band of
``tests/test_flash.py`` (2e-2). The CE kernels by relative norm,
the dx and dW kernels at their edges in both modes (D tile widths, V and N
that no tile divides, ignored rows, the softmax part alone, a non-uniform
g; in recompute mode also several vocab slabs, the last ragged, labels at
their edge columns) within the bound of ``chip_smoke.check_ce``; the
recompute-mode ds kernel alone within one bf16 step; the CE forward at its edges (D
of 1 to 16 chunks, V and N that no tile divides, labels at the first, last
and ragged columns, a running max that moves across vocab tiles and splits)
within the bounds of ``chip_smoke.check_ce`` (loss and lse absolute, the
stash within one bf16 step). The K-step window on a small GPT-2 (head dim
64, flash and the CE head): its CUDA graph against eager steps within
``WINDOW_ATOL`` per step (the bound of ``chip_smoke``'s phase 4), exact
launch counts under replay (also with the CE head in recompute mode), a
capture after a restore and beside a
staging thread, ``release_task`` giving the pool back; one step of each
optimizer ``HParams.make_optimizer`` builds, replayed from a graph, against
the same optimizer without ``capturable`` within 1e-6. Host offload on the
same model over the logits: stream and bulk against dp within 1e-4 per step
(the first loss bitwise) with exact flash launches, the host state pinned
with no moment on the card, two block buffers in stream mode, and a bulk
trial that runs out of device memory infeasible with its memory returned.
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
     (False, 8, 2, 128, 64),
     # head dim 256 (GPT-J's): the forward and dK/dV on two consumer warpgroups
     (True, 4, 4, 256, 256), (False, 4, 2, 256, 320), (True, 8, 2, 256, 64),
     (False, 4, 4, 256, 64)],
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
@pytest.mark.parametrize("D", [64, 128, 256])
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
    B = 2
    q, k, v, do, target = _planted_inputs(B, H, KV, T, D, causal, cuda_device,
                                          T + D + H + KV + causal)
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


def _planted_inputs(B, H, KV, T, D, causal, device, seed):
    """bf16 q, k, v, do of (B*H or B*KV, T, D) and each q row's planted kv
    tile (the dQ edge test's docstring says how)."""
    a = ((np.log(T) + 3) * D ** 0.5) ** 0.5
    rng = np.random.default_rng(seed)
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
    q, k, v, do = (torch.tensor(x, dtype=torch.bfloat16, device=device)
                   for x in (q, k, v, do))
    return q, k, v, do, target


def _flash_d256_inputs(B, H, KV, T, device, seed):
    rng = np.random.default_rng(seed)

    def mk(n):
        return torch.tensor(rng.standard_normal((n, T, 256)), dtype=torch.bfloat16,
                            device=device)

    return mk(B * H), mk(B * KV), mk(B * KV), mk(B * H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,causal", [
    # one tile: the second warpgroup of the block has no rows
    (2, 4, 4, 64, True), (2, 4, 4, 64, False),
    # T % 128 == 64 with grouped queries: the last block's second warpgroup has no rows
    (2, 8, 2, 192, True), (2, 8, 2, 192, False), (2, 8, 2, 320, True), (2, 8, 2, 320, False),
    # walks of 16: the rings' parities wrap four times
    (1, 4, 4, 1024, True), (1, 4, 4, 1024, False),
    # four blocks, a grid far smaller than the card
    (1, 1, 1, 512, True), (1, 1, 1, 512, False),
])
def test_flash_fwd_d256_edges(cuda_device, B, H, KV, T, causal):
    """The head-dim-256 forward (fwd_pingpong_kernel: 128 q rows a block on
    two warpgroups) against flash_fwd_reference at the bounds of
    ``chip_smoke.check_kernels``, at its edges; the dQ and dK/dV kernels run
    on its lse and are held to their plain versions."""
    q, k, v, do = _flash_d256_inputs(B, H, KV, T, cuda_device, B + H + KV + T + causal)
    before = flash.LAUNCHES["flash_fwd"]
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    launched = flash.LAUNCHES["flash_fwd"] - before
    o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV)
    dk, dv = flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV)
    dq_ref = flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV)
    dk_ref, dv_ref = flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV)
    torch.cuda.synchronize()
    assert launched == 1
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=FLASH_LSE_ATOL)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2.0 ** -7, atol=FLASH_O_ATOL)
    for name, a, b in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert _rel_err(a, b) <= FLASH_GRAD_REL, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fwd_d256_is_deterministic(cuda_device, causal):
    """Two runs of the head-dim-256 forward on the same inputs give bitwise
    equal o and lse (GPT-J's heads at T 512)."""
    q, k, v, _ = _flash_d256_inputs(2, 16, 16, 512, cuda_device, 5)
    first = flash.flash_fwd(q, k, v, causal, 16, 16)
    second = flash.flash_fwd(q, k, v, causal, 16, 16)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,causal", [
    # one tile: every walk is one step
    (2, 4, 4, 64, True), (2, 4, 4, 64, False),
    # grouped queries (rep 4): four q heads read each kv head
    (2, 8, 2, 192, True), (2, 8, 2, 192, False), (2, 8, 2, 320, True), (2, 8, 2, 320, False),
    # walks of 16 and 32: the rings' and the dS buffers' parities wrap
    (1, 4, 4, 1024, True), (1, 4, 4, 1024, False), (1, 8, 2, 1024, True),
    (1, 2, 2, 2048, True), (1, 2, 2, 2048, False),
    # eight tiles, a grid far smaller than the card
    (1, 1, 1, 512, True), (1, 1, 1, 512, False),
    # 1024 and 256 tiles: each persistent block walks several, heavy with light when causal
    (4, 16, 4, 1024, True), (2, 8, 8, 1024, False),
])
def test_flash_dq_d256_edges(cuda_device, B, H, KV, T, causal):
    """The head-dim-256 dQ (dq_wide_kernel: persistent blocks of one q
    tile at a time, one consumer warpgroup forming the scores and dS, the
    other dq += dS K) against flash_dq_reference within FLASH_GRAD_REL, one
    launch a call, at its edges, with the dQ edge test's inputs: a planted
    score of ln T + 3 per q row in the latest kv tile it sees, so that P is
    near 1 there and dS is far from uniform; lse and delta from the forward
    kernel on the same inputs."""
    q, k, v, do, target = _planted_inputs(B, H, KV, T, 256, causal, cuda_device,
                                          B + H + KV + T + causal)
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
    s = (q.float() * k[kv_of][:, planted].float()).sum(-1) / 256 ** 0.5
    assert torch.exp(s - lse).median().item() >= 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_dq_d256_is_deterministic(cuda_device, causal):
    """Two runs of the head-dim-256 dQ on the same inputs give bitwise
    equal dq (GPT-J's heads at T 512): no atomics, a fixed order."""
    q, k, v, do = _flash_d256_inputs(2, 16, 16, 512, cuda_device, 7)
    o, lse = flash.flash_fwd(q, k, v, causal, 16, 16)
    delta = (do.float() * o.float()).sum(-1)
    first = flash.flash_dq(q, k, v, do, lse, delta, causal, 16, 16)
    second = flash.flash_dq(q, k, v, do, lse, delta, causal, 16, 16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,causal", [
    # one tile
    (2, 4, 4, 64, True), (2, 4, 4, 64, False),
    # T % 128 == 64 with grouped queries (rep 4): the walk sums four q heads
    (2, 8, 2, 192, True), (2, 8, 2, 192, False), (2, 8, 2, 320, True), (2, 8, 2, 320, False),
    # walks of 16 (64 with the group): the ring's and the P buffers' parities wrap
    (1, 4, 4, 1024, True), (1, 4, 4, 1024, False), (1, 8, 2, 1024, True),
    # eight tiles, a grid far smaller than the card
    (1, 1, 1, 512, True), (1, 1, 1, 512, False),
    # 256 tiles: each persistent block walks two, the heavy with the light when causal
    (4, 16, 4, 1024, True), (2, 8, 8, 1024, False),
])
def test_flash_dkv_d256_edges(cuda_device, B, H, KV, T, causal):
    """The head-dim-256 dK/dV (dkv_wide_kernel: persistent blocks of one
    kv tile at a time, one consumer warpgroup forming P and dv, the other dS
    and dk) against
    flash_dkv_reference within FLASH_GRAD_REL, one launch a call, at its
    edges, with the dQ edge test's inputs: a planted score of ln T + 3 per q
    row in the latest kv tile it sees, so that P is near 1 there and the
    kv tile's P^T and dS^T are far from uniform; lse and delta from the
    forward kernel on the same inputs."""
    q, k, v, do, _ = _planted_inputs(B, H, KV, T, 256, causal, cuda_device,
                                     B + H + KV + T + causal)
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    before = flash.LAUNCHES["flash_dkv"]
    dk, dv = flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV)
    launched = flash.LAUNCHES["flash_dkv"] - before
    dk_ref, dv_ref = flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV)
    torch.cuda.synchronize()
    assert launched == 1
    for name, got, want in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.shape == k.shape and got.dtype == torch.bfloat16, name
        assert torch.isfinite(got.float()).all(), name
        assert _rel_err(got, want) <= FLASH_GRAD_REL, (name, _rel_err(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_dkv_d256_is_deterministic(cuda_device, causal):
    """Two runs of the head-dim-256 dK/dV on the same inputs give bitwise
    equal dk and dv (GPT-J's heads at T 512): no atomics, a fixed order."""
    q, k, v, do = _flash_d256_inputs(2, 16, 16, 512, cuda_device, 6)
    o, lse = flash.flash_fwd(q, k, v, causal, 16, 16)
    delta = (do.float() * o.float()).sum(-1)
    first = flash.flash_dkv(q, k, v, do, lse, delta, causal, 16, 16)
    second = flash.flash_dkv(q, k, v, do, lse, delta, causal, 16, 16)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


#: The recompute-mode dx and dW (a ds kernel and the product kernel per vocab
#: slab) against their plain versions, by relative norm (the bound of
#: ``chip_smoke.check_ce``).
CE_RECOMPUTE_REL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tail", "softmax", "random_g"])
@pytest.mark.parametrize(
    "N,D,V,slab",
    # D tiles of 64, 128, 256 (3 and 4 of them), 192 and 64 (of D 320); V and
    # N that no tile divides; slabs of 256 or 512 columns forced through a
    # smaller cap (2 and 4 slabs, the last ragged), or the cap's own (one
    # slab; 4 and 5 slabs at GPT-2's vocab)
    [(256, 64, 300, 256), (256, 128, 1000, 512), (256, 768, 1000, 256), (256, 1024, 300, None),
     (100, 192, 1000, 256), (100, 320, 300, None), (4000, 768, 50257, None),
     (6000, 768, 50257, None)],
)
def test_ce_recompute_edges(cuda_device, monkeypatch, N, D, V, slab, mode):
    """Recompute-mode dx and dW against ce_dx_reference / ce_dw_reference,
    with an ignored tail and g = 1 per counted row (``tail``), every label
    ignored and g = 1 (``softmax``: the softmax part alone), or a random
    non-uniform g (``random_g``). The first rows' labels sit at the first and
    last column of every slab. x has a scale that grows along D and W
    another, so a descriptor that swaps or transposes an operand gives
    another result. One launch of each wrapper, whatever the slab count."""
    if slab is not None:
        monkeypatch.setattr(ce, "SLAB_BYTES_MAX", 2 * N * slab)
    vs = ce.slab_width(N, V)
    assert slab is None or vs == slab
    edges = [c for v0 in range(0, V, vs) for c in (v0, min(V, v0 + vs) - 1)]
    rng = np.random.default_rng(N + D + V)
    x = torch.tensor(rng.standard_normal((N, D)) * np.linspace(1.0, 2.0, D),
                     dtype=torch.bfloat16, device=cuda_device)
    w = torch.tensor(rng.standard_normal((V, D)) * 0.05, dtype=torch.bfloat16,
                     device=cuda_device)
    labels_np = rng.integers(0, V, N).astype(np.int32)
    labels_np[:len(edges)] = edges
    tail = N // 8
    labels_np[N - tail:] = -1
    g_np = (labels_np >= 0).astype(np.float32)
    if mode == "softmax":
        labels_np[:], g_np[:] = -1, 1.0
    elif mode == "random_g":
        g_np *= rng.uniform(0.1, 2.0, N).astype(np.float32)
    labels = torch.tensor(labels_np, device=cuda_device)
    g = torch.tensor(g_np, device=cuda_device)
    _, lse, s = ce.ce_fwd(x, w, labels, False)
    before = dict(ce.LAUNCHES)
    dx = ce.ce_dx(x, w, labels, lse, g)
    dw = ce.ce_dw(x, w, labels, lse, g)
    launched = {n: ce.LAUNCHES[n] - before[n] for n in ("ce_dx", "ce_dw")}
    dx_r = ce.ce_dx_reference(x, w, labels, lse, g)
    dw_r = ce.ce_dw_reference(x, w, labels, lse, g)
    torch.cuda.synchronize()
    assert s is None and launched == {"ce_dx": 1, "ce_dw": 1}
    assert dx.shape == (N, D) and dx.dtype == torch.bfloat16
    assert dw.shape == (V, D) and dw.dtype == torch.float32
    assert torch.isfinite(dx.float()).all() and torch.isfinite(dw).all()
    for name, got, want in (("dx", dx, dx_r), ("dw", dw, dw_r)):
        assert _rel_err(got, want) <= CE_RECOMPUTE_REL, (name, _rel_err(got, want))
    counted = N if mode == "softmax" else N - tail
    assert (dx[:counted].float().abs().sum(1) > 0).all()
    assert torch.count_nonzero(dx[counted:]) == 0
    assert (dw.abs().sum(1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V,v0,v1", [(256, 64, 1000, 256, 512), (100, 128, 300, 256, 300),
                                         (4000, 768, 50257, 49920, 50257)])
def test_ce_ds_slab_matches_plain(cuda_device, N, D, V, v0, v1):
    """The ds kernel alone on one vocab slab (ce_ds_slab) against
    ce_ds_slab_reference: both form ds in f32 and round it to bf16 once, so
    each value lies within one bf16 step of the plain one (ex2.approx
    flushes what falls below the smallest normal float). Labels at the
    slab's first and last column and just outside it, a non-uniform g, an
    ignored tail. The entry point counts no launch."""
    rng = np.random.default_rng(N + v0)
    x = torch.tensor(rng.standard_normal((N, D)), dtype=torch.bfloat16, device=cuda_device)
    w = torch.tensor(rng.standard_normal((V, D)) * 0.05, dtype=torch.bfloat16,
                     device=cuda_device)
    labels_np = rng.integers(0, V, N).astype(np.int32)
    labels_np[:4] = [v0, v1 - 1, v0 - 1, min(v1, V - 1)]
    labels_np[N - N // 8:] = -1
    labels = torch.tensor(labels_np, device=cuda_device)
    g = torch.tensor(rng.uniform(0.1, 2.0, N) * (labels_np >= 0), dtype=torch.float32,
                     device=cuda_device)
    _, lse, _ = ce.ce_fwd(x, w, labels, False)
    before = dict(ce.LAUNCHES)
    ds = ce.ce_ds_slab(x, w, labels, lse, g, v0, v1)
    want = ce.ce_ds_slab_reference(x, w, labels, lse, g, v0, v1)
    torch.cuda.synchronize()
    assert ce.LAUNCHES == before
    assert ds.shape == (N, v1 - v0) and ds.dtype == torch.bfloat16
    torch.testing.assert_close(ds.float(), want.float(), rtol=2.0 ** -7, atol=2.0 ** -126)
    assert (ds[:2].float().min(1).values < 0).all()  # the one-hot term at both edges


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


# ---------------------------------------------------------------- windows
#: Windowed against eager losses, absolute per step (the bound of
#: chip_smoke's phase 4; the same kernels in the same order give equality).
WINDOW_ATOL = 1e-5
#: The flash and CE kernels' width: head dim 64, d_model 128, T 128.
SMALL = dict(d_model=128, n_heads=2, n_layers=2, seq_len=128, vocab_size=512)


def _small_task(tmp_path, name, optimizer="adamw"):
    from saturn_tpu_torch import HParams, Strategy, Task
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss
    from saturn_tpu_torch.parallel.dp import DataParallel

    task = Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **{**SMALL, **kw}),
        get_dataloader=lambda: make_lm_dataset(context_length=128, batch_size=4,
                                               vocab_size=512, n_tokens=128 * 4 * 16),
        loss_fn=pretraining_loss,
        hparams=HParams(lr=1e-3, batch_count=40, optimizer=optimizer),
        name=name, save_dir=str(tmp_path / name),
    )
    tech = DataParallel()
    task.strategies[1] = Strategy(tech, 1, {"remat": False, "attention": "flash"}, 0.0)
    task.select_strategy(1)
    return task, tech


def _counts():
    return {**flash.LAUNCHES, **ce.LAUNCHES}


def _run(task, tech, device, n, k):
    before = _counts()
    tech.execute(task, [device], 0, override_batch_count=n, window_size=k)
    task.reconfigure(n)
    return task.last_losses, {name: c - before[name] for name, c in _counts().items()}


@pytest.mark.cuda
def test_graphed_window_matches_eager_steps(cuda_device, tmp_path):
    """execute in windows of 4 (an eager step, the captures, two windows and
    a tail of one one-step window) against one step at a time: the same
    losses and the exact launch counts (one of each flash kernel per layer
    per step, one of each CE kernel per step) in both."""
    runs = {}
    for k in (4, 1):
        task, tech = _small_task(tmp_path, f"k{k}")
        runs[k] = _run(task, tech, cuda_device, 10, k)
        rec = tech.intervals[-1]
        assert (rec["windows"], rec["tail"], rec["warm"]) == ((2, 1, True) if k > 1 else (0, 10, False))
    want = {"flash_fwd": 20, "flash_dq": 20, "flash_dkv": 20, "ce_fwd": 10, "ce_dx": 10, "ce_dw": 10}
    assert runs[4][1] == want and runs[1][1] == want
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=0, atol=WINDOW_ATOL)


@pytest.mark.cuda
def test_recompute_graphed_window_matches_eager_steps(cuda_device, tmp_path, monkeypatch):
    """The graphed window with the CE head in recompute mode (the stash limit
    set to 0, as above it) over two vocab slabs of 256 columns (the slab
    cap set to one tile): the captured slab loop, its ds scratch taken from
    the graph's pool, against one step at a time, with the exact launch
    counts in both."""
    monkeypatch.setattr(ce, "STASH_BYTES_MAX", 0)
    monkeypatch.setattr(ce, "SLAB_BYTES_MAX", 2 * 4 * 128 * ce.SLAB_COLS)
    assert not ce.auto_stash(4 * 128, 512, 128) and ce.slab_width(4 * 128, 512) == 256
    runs = {}
    for k in (4, 1):
        task, tech = _small_task(tmp_path, f"recompute-k{k}")
        runs[k] = _run(task, tech, cuda_device, 10, k)
        rec = tech.intervals[-1]
        assert (rec["windows"], rec["tail"], rec["warm"]) == ((2, 1, True) if k > 1 else (0, 10, False))
    want = {"flash_fwd": 20, "flash_dq": 20, "flash_dkv": 20, "ce_fwd": 10, "ce_dx": 10, "ce_dw": 10}
    assert runs[4][1] == want and runs[1][1] == want
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=0, atol=WINDOW_ATOL)


@pytest.mark.cuda
def test_graph_replay_counts_launches_exactly(cuda_device, tmp_path):
    """Later intervals replay, on the live state, the graphs captured
    earlier: the second interval captures only its one-step window, the
    third nothing. Each replay adds the launches it holds, and the 9 + 10 +
    3 steps of the three intervals equal 22 steps taken one at a time from
    the same init."""
    whole, tech = _small_task(tmp_path, "replay-whole")
    ref, _ = _run(whole, tech, cuda_device, 22, 1)

    task, tech = _small_task(tmp_path, "replay")
    bundle = tech.build(task, [cuda_device], dict(task.selected_strategy.params))
    got = []
    for n, plan in ((9, (2, 0, True)), (10, (2, 2, False)), (3, (0, 3, False))):
        losses, launched = _run(task, tech, cuda_device, n, 4)
        rec = tech.intervals[-1]
        assert (rec["windows"], rec["tail"], rec["warm"]) == plan and not rec["restored"]
        assert launched == {"flash_fwd": 2 * n, "flash_dq": 2 * n, "flash_dkv": 2 * n,
                            "ce_fwd": n, "ce_dx": n, "ce_dw": n}
        live = task._live_state[1]
        assert bundle.fused(4).captured_on(live) and (n == 9 or bundle.fused(1).captured_on(live))
        got += losses
    np.testing.assert_allclose(got, ref, rtol=0, atol=WINDOW_ATOL)


@pytest.mark.cuda
def test_restore_then_capture_again(cuda_device, tmp_path):
    """A restore replaces the optimizer's state tensors: the window is
    captured anew on the restored state, and the trajectory equals the
    uninterrupted one-step-at-a-time run."""
    whole, tech = _small_task(tmp_path, "whole")
    ref, _ = _run(whole, tech, cuda_device, 18, 1)

    task, tech = _small_task(tmp_path, "split")
    first, _ = _run(task, tech, cuda_device, 9, 4)
    bundle = tech.build(task, [cuda_device], dict(task.selected_strategy.params))
    live = task._live_state[1]
    assert bundle.fused(4).captured_on(live)
    task.release_live_state()
    second, _ = _run(task, tech, cuda_device, 9, 4)
    rec = tech.intervals[-1]
    assert rec["restored"] and rec["warm"] and (rec["windows"], rec["tail"]) == (2, 0)
    assert not bundle.fused(4).captured_on(live)
    np.testing.assert_allclose(first + second, ref, rtol=0, atol=WINDOW_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_capturable_optimizer_step_matches_plain(cuda_device, name):
    """make_optimizer's optimizer on the card (capturable AdamW and Adam;
    SGD as it is), one eager step then two replays of a captured step,
    against the same optimizer without ``capturable`` stepping eagerly."""
    from saturn_tpu_torch import HParams

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 48)).astype(np.float32)
    grads = [torch.tensor(rng.standard_normal((64, 48)), dtype=torch.float32,
                          device=cuda_device) for _ in range(3)]
    lr = 1e-2
    tp = torch.nn.Parameter(torch.tensor(p0, device=cuda_device))
    opt = HParams(lr=lr, batch_count=1, optimizer=name).make_optimizer([tp])
    plain_p = torch.nn.Parameter(torch.tensor(p0, device=cuda_device))
    plain = {"adamw": lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                                   weight_decay=1e-4),
             "adam": lambda ps: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8),
             "sgd": lambda ps: torch.optim.SGD(ps, lr=lr)}[name]([plain_p])
    if name != "sgd":
        assert opt.param_groups[0]["capturable"]
    static_grad = torch.zeros_like(tp)
    tp.grad = static_grad
    static_grad.copy_(grads[0])
    opt.step()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        opt.step()
    for g in grads[1:]:
        static_grad.copy_(g)
        graph.replay()
    for g in grads:
        plain_p.grad = g.clone()
        plain.step()
    torch.cuda.synchronize()
    torch.testing.assert_close(tp.detach(), plain_p.detach(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_restore_puts_capturable_steps_on_the_card(cuda_device, tmp_path):
    from saturn_tpu_torch import HParams
    from saturn_tpu_torch.utils import checkpoint as ckpt

    def state():
        model = torch.nn.Linear(8, 8, device=cuda_device)
        opt = HParams(batch_count=1).make_optimizer(model.parameters())
        return {"params": model, "opt_state": opt, "step": 0}

    s = state()
    s["params"](torch.ones(2, 8, device=cuda_device)).sum().backward()
    s["opt_state"].step()
    ckpt.save(str(tmp_path / "ckpt.pt"), s)
    restored = ckpt.restore(str(tmp_path / "ckpt.pt"), state())
    for per_param in restored["opt_state"].state.values():
        assert per_param["step"].device == cuda_device


@pytest.mark.cuda
def test_capture_while_another_thread_stages(cuda_device, tmp_path):
    """A window is captured while another thread pins host memory and copies
    batches to the card (what another task's ``execute`` does): the capture
    holds, and the windowed losses equal the eager ones."""
    import threading

    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    stop = threading.Event()
    staged = []

    def stager():
        rng = np.random.default_rng(1)
        size = 1 << 12
        while not stop.is_set():
            size = size * 2 if size < (1 << 22) else 1 << 12  # new pinned blocks
            staged.append(stage_tokens(rng.integers(0, 512, size, dtype=np.int32),
                                       cuda_device).sum())

    runs = {}
    for k in (4, 1):
        task, tech = _small_task(tmp_path, f"thread-k{k}")
        thread = threading.Thread(target=stager, daemon=True)
        stop.clear()
        thread.start()
        try:
            runs[k], _ = _run(task, tech, cuda_device, 9, k)
        finally:
            stop.set()
            thread.join()
    torch.cuda.synchronize()
    assert len(staged) > 0
    np.testing.assert_allclose(runs[4], runs[1], rtol=0, atol=WINDOW_ATOL)


@pytest.mark.cuda
def test_release_task_returns_the_pool(cuda_device, tmp_path):
    """The live state, the window's graph and its memory pool go back to the
    device once the task is released (measured on a second task, after the
    first made the libraries' lasting per-stream state)."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    for name in ("release-warm", "release"):
        task, tech = _small_task(tmp_path, name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(cuda_device)
        _run(task, tech, cuda_device, 9, 4)
        ckpt.flush()
        held = torch.cuda.memory_reserved(cuda_device)
        task.release_live_state()
        task.release_compiled()
        after = torch.cuda.memory_reserved(cuda_device)
    print(f"reserved: before {before}, with the task {held}, after release {after}")
    assert tech._bundles == {}
    assert held > before and after <= before


# ---------------------------------------------------------------- offload
#: offload against dp over the logits, relative per step (the repo's
#: trajectory tolerance; the host's fused AdamW rounds otherwise than dp's).
OFFLOAD_REL = 1e-4
OFFLOAD_STREAM = {"stream": True, "remat": True}
OFFLOAD_BULK = {"stream": False, "remat": False}


def _untagged(logits, tokens):
    from saturn_tpu_torch.models.loss import pretraining_loss

    return pretraining_loss(logits, tokens)


def _offload_task(tmp_path, name, config, **model):
    """``_small_task``'s model and data over the logits, under offload
    (``config``) or dp (``config`` None)."""
    from saturn_tpu_torch import Strategy
    from saturn_tpu_torch.parallel.offload import HostOffload

    task, tech = _small_task(tmp_path, name)
    task.loss_fn = _untagged
    if model:
        from saturn_tpu_torch.models.gpt2 import build_gpt2

        task._get_model = lambda **kw: build_gpt2("test-tiny", **{**SMALL, **model, **kw})
    if config is not None:
        tech = HostOffload()
        task.strategies[1] = Strategy(tech, 1, dict(config), 0.0)
        task.select_strategy(1)
    return task, tech


@pytest.mark.cuda
@pytest.mark.parametrize("config", [OFFLOAD_STREAM, OFFLOAD_BULK], ids=["stream", "bulk"])
def test_offload_losses_match_dp_over_the_logits(cuda_device, tmp_path, config):
    """Four steps from one init: offload against dp over the logits within
    OFFLOAD_REL, the first loss bitwise (the same kernels on the same
    weights), exact flash launches (the forward twice where the blocks are
    recomputed)."""
    dp_task, dp = _offload_task(tmp_path, "dp", None)
    want, _ = _run(dp_task, dp, cuda_device, 4, 1)
    task, tech = _offload_task(tmp_path, "offload", config)
    got, launched = _run(task, tech, cuda_device, 4, 1)
    print(f"offload {config}: {got}; dp {want}")
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=OFFLOAD_REL, atol=0)
    layers = SMALL["n_layers"] * 4
    assert launched == {"flash_fwd": layers * (2 if config["stream"] else 1),
                        "flash_dq": layers, "flash_dkv": layers,
                        "ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


@pytest.mark.cuda
def test_offload_state_is_pinned_and_stays_on_the_host(cuda_device, tmp_path):
    """After a step every host buffer is pinned, the parameters, gradients and
    AdamW moments are views of them, no optimizer tensor is on the card, and
    the card holds nothing of the state."""
    task, tech = _offload_task(tmp_path, "pinned", OFFLOAD_BULK)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    _run(task, tech, cuda_device, 2, 1)
    state = task._live_state[1]
    host = state["host"]
    assert host.pinned() and set(host.buffers) == {"params", "grads", "exp_avg", "exp_avg_sq"}
    for p in state["params"].parameters():
        assert p.device.type == "cpu" and p.is_pinned() and p.grad.is_pinned()
        for v in state["opt_state"].state[p].values():
            assert v.device.type == "cpu"
            assert v.dim() == 0 or v.is_pinned()
    # the staged batch and the losses are all that may remain on the card
    assert torch.cuda.memory_allocated(cuda_device) - base < 2**20


@pytest.mark.cuda
def test_stream_prefetch_holds_two_block_buffers(cuda_device, tmp_path, monkeypatch):
    """Stream mode fetches every block into one of two device buffers of one
    block each, and frees them with the step."""
    from saturn_tpu_torch.parallel import offload

    streamers, copies = [], []
    init, h2d = offload._Streamer.__init__, offload._Mover.h2d

    def spy_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        streamers.append(self)

    def spy_h2d(self, dst, src, after=None):
        copies.append((dst.data_ptr(), dst.numel()))
        return h2d(self, dst, src, after)

    monkeypatch.setattr(offload._Streamer, "__init__", spy_init)
    monkeypatch.setattr(offload._Mover, "h2d", spy_h2d)
    task, tech = _offload_task(tmp_path, "stream", OFFLOAD_STREAM, n_layers=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    _run(task, tech, cuda_device, 1, 1)
    (streamer,) = streamers
    layout = task._live_state[1]["host"].layout
    assert len(streamer.bufs) == 2
    assert all(b.numel() == layout.block_numel for b in streamer.bufs)
    slots = {b.data_ptr() for b in streamer.bufs}
    block_copies = [c for c in copies if c[0] in slots]
    # forward fetches each of the 4 blocks once; backward fetches again all
    # but the two its buffers still hold
    assert len(block_copies) == 4 + 2
    assert len(copies) == len(block_copies) + len(layout.runs)
    del streamer, streamers[:]
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) - base < 2**20


@pytest.mark.cuda
def test_oversized_bulk_config_is_infeasible_and_gives_memory_back(cuda_device, tmp_path):
    """A bulk trial that runs out of device memory makes its config
    infeasible, and the memory its step held goes back."""
    task, tech = _offload_task(tmp_path, "oom", OFFLOAD_BULK, d_model=512, n_heads=8,
                               n_layers=4, vocab_size=8192)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    base = torch.cuda.memory_allocated(cuda_device)
    cap = torch.cuda.memory_reserved(cuda_device) + 32 * 2**20  # under the 67 MB shadow
    torch.cuda.set_per_process_memory_fraction(cap / total, cuda_device)
    try:
        assert tech._try_config(task, [cuda_device], OFFLOAD_BULK) is None
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda_device)
    tech._shared.clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) <= base
