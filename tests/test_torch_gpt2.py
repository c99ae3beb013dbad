"""The port's GPT-2 family against the JAX package's, on the same weights.

Params come from the JAX init and reach the port through
``models.convert.params_from_jax``; tokens come from a numpy seed. In f32
(``dtype=float32`` on both sides) the logits agree to 1e-5; the bf16 model
agrees within the bf16 band of ``tests/test_flash.py`` (2e-2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saturn_tpu.models import gpt2 as jgpt2
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.convert import params_from_jax, params_to_jax

F32, BF16 = 1e-5, 2e-2


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The JAX init of a preset (fp32 params whatever the compute dtype),
    as numpy leaves; shared by the tests of this file."""
    params = jgpt2.build_gpt2(name).init_fn(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(name, jax_kw, torch_kw, seed=0):
    """(JAX logits, port logits) for one preset on shared params/tokens."""
    jspec = jgpt2.build_gpt2(name, **jax_kw)
    params = _jax_params(name)
    cfg = jspec.config
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, cfg.seq_len))
    want = np.asarray(jspec.apply_fn(params, jnp.asarray(tokens, jnp.int32)))
    tspec = tgpt2.build_gpt2(name, **torch_kw)
    model = tspec.meta_init_fn().to_empty(device="cpu")
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = tspec.apply_fn(model, torch.tensor(tokens)).numpy()
    return want, got


def test_presets_match_jax_table():
    # importing the JAX BERT module adds its encoder presets to the GPT-2
    # table at run time, whichever modules this worker has imported; the
    # port keeps them in its own BERT table. Compare the rest.
    from saturn_tpu.models.bert import BERT_PRESETS as JBERT
    from saturn_tpu_torch.models.bert import BERT_PRESETS as TBERT

    def decoders(table):
        return {k: v for k, v in table.items() if k not in JBERT and k not in TBERT}

    assert decoders(tgpt2.PRESETS) == decoders(jgpt2.PRESETS)
    assert set(decoders(tgpt2.PRESETS)) == set(tgpt2.PRESETS)


@pytest.mark.parametrize("name", ["test-tiny", "gptj-test-tiny", "llama-test-tiny"])
def test_params_round_trip(name):
    tree = _jax_params(name)
    model = tgpt2.build_gpt2(name).meta_init_fn().to_empty(device="cpu")
    model.load_state_dict(params_from_jax(tree))  # strict: every leaf mapped
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize(
    "name,attention",
    [("test-tiny", "dense"), ("test-tiny", "flash"), ("gptj-test-tiny", "dense"),
     ("llama-test-tiny", "dense"), ("llama-test-tiny", "flash")],
)
def test_logits_match_jax_f32(name, attention):
    want, got = _pair(name, dict(dtype=jnp.float32, attention=attention),
                      dict(dtype=torch.float32, attention=attention))
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


@pytest.mark.parametrize("name", ["test-tiny", "llama-test-tiny"])
def test_logits_match_jax_bf16(name):
    want, got = _pair(name, {}, {}, seed=2)
    np.testing.assert_allclose(got, want, rtol=BF16, atol=BF16)


def test_remat_same_gradients():
    """Per-block checkpointing changes memory, not the gradients."""
    tokens = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 64)))
    grads = []
    for remat in (False, True):
        spec = tgpt2.build_gpt2("test-tiny", dtype=torch.float32, remat=remat)
        model = spec.init_fn(torch.Generator().manual_seed(0))
        spec.apply_fn(model, tokens).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="moe"):
        tgpt2.config_for("moe-test-tiny")
    with pytest.raises(NotImplementedError, match="seq_axis"):
        tgpt2.config_for("test-tiny", seq_axis="seq")
    with pytest.raises(NotImplementedError, match="pretrained"):
        tgpt2.build_gpt2("test-tiny", pretrained={})
