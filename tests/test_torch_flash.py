"""The port's flash attention against the JAX package's Pallas kernel.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode. The port's wrappers take their plain versions on CPU
tensors. Tolerances: 1e-5 for the f32 forward, 1e-4 for f32 gradients (sums
in another order over T = 128), and the bf16 band of ``tests/test_flash.py``
(2e-2) for bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saturn_tpu.ops import flash as jflash
from saturn_tpu_torch.ops import flash as tflash

F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2


def _inputs(B=2, H=4, KV=4, T=128, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    g = rng.standard_normal((B, H, T, D)).astype(np.float32)  # output cotangent
    return q, k, v, g


def _jax(q, k, v, g, causal, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_attention(a, b, c, causal=causal,
                                               block_q=64, block_k=64), *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x, dtype=np.float32) for x in (out, *grads)]


def _torch(q, k, v, g, causal, dtype, fn=tflash.flash_attention, **kw):
    args = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = fn(*args, causal=causal, **kw)
    out.backward(torch.tensor(g, dtype=dtype))
    return [t.detach().float().numpy() for t in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax(causal, kv_heads, dtype):
    q, k, v, g = _inputs(KV=kv_heads, seed=1 + kv_heads)
    want = _jax(q, k, v, g, causal, getattr(jnp, dtype))
    got = _torch(q, k, v, g, causal, getattr(torch, dtype), block_q=64, block_k=64)
    assert got[2].shape == k.shape and got[3].shape == v.shape
    for name, a, b, tol in zip(
        ("o", "dq", "dk", "dv"), got, want,
        (F32_FWD, F32_GRAD, F32_GRAD, F32_GRAD) if dtype == "float32" else (BF16,) * 4,
    ):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_wrapper(causal):
    """flash_attention_reference (plain autograd) and the wrapper's
    forward / dQ / dK/dV plain versions agree in f32."""
    q, k, v, g = _inputs(KV=2, seed=7)
    a = _torch(q, k, v, g, causal, torch.float32)
    b = _torch(q, k, v, g, causal, torch.float32, fn=tflash.flash_attention_reference)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=F32_GRAD, atol=F32_GRAD)


def test_lse_matches_jax():
    q, k, v, _ = _inputs(KV=2, seed=3)
    B, H, T, D = q.shape
    _, jlse = jflash._fwd(
        jnp.asarray(q.reshape(B * H, T, D)), jnp.asarray(k.reshape(B * 2, T, D)),
        jnp.asarray(v.reshape(B * 2, T, D)), block_q=64, block_k=64,
        scale=1.0 / np.sqrt(D), causal=True, h=H, kv=2,
    )
    _, tlse = tflash.flash_fwd(
        torch.tensor(q.reshape(B * H, T, D)), torch.tensor(k.reshape(B * 2, T, D)),
        torch.tensor(v.reshape(B * 2, T, D)), True, H, 2,
    )
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=F32_FWD, atol=F32_FWD)


def test_same_errors_as_jax():
    q, k, v, _ = _inputs(T=100)
    for mod, conv in ((jflash, jnp.asarray), (tflash, torch.tensor)):
        with pytest.raises(ValueError, match="not divisible"):
            mod.flash_attention(conv(q), conv(k), conv(v), block_q=64, block_k=64)
    q, k, v, _ = _inputs(KV=2)
    _, k3, v3, _ = _inputs(KV=3)
    for mod, conv in ((jflash, jnp.asarray), (tflash, torch.tensor)):
        with pytest.raises(ValueError, match="match and divide"):
            mod.flash_attention(conv(q), conv(k[:, :1]), conv(v), block_q=64, block_k=64)
        with pytest.raises(ValueError, match="match and divide"):
            mod.flash_attention(conv(q), conv(k3), conv(v3), block_q=64, block_k=64)


def test_cpu_tensors_count_no_launch():
    tflash.reset_launch_counts()
    q, k, v, g = _inputs(KV=2)
    _torch(q, k, v, g, True, torch.bfloat16)
    assert tflash.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_flash_supported_off_the_card(monkeypatch):
    """Without a card, 'auto' resolves to dense by rule."""
    from saturn_tpu_torch.models.gpt2 import build_gpt2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tflash.flash_supported()
    assert build_gpt2("test-tiny").config.attention == "dense"
