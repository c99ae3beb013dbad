"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA card. On the card (which has no
JAX, hence no ``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

bf16 inputs, compared in the bf16 band of ``tests/test_flash.py`` (2e-2).
"""

import numpy as np
import pytest
import torch

from saturn_tpu_torch.ops import flash

BF16 = 2e-2


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run with -m cuda on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "causal,H,KV,D",
    [(True, 4, 4, 64), (False, 4, 2, 64), (True, 8, 2, 128), (False, 4, 4, 128)],
)
def test_kernels_match_plain(cuda_device, causal, H, KV, D):
    rng = np.random.default_rng(H + KV + D)
    T = 256

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
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16, atol=BF16,
                                   msg=lambda m: f"{name}: {m}")
    assert {n: flash.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


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
