"""The port's pretrained-weight ingest (``saturn_tpu_torch/models/ingest.py``,
``build_gpt2(pretrained=...)``) against the JAX package's
(``saturn_tpu/models/ingest.py``).

State dicts in HF naming come from ``chip_smoke.py``'s writers (numpy seed),
at ``test-tiny`` / ``gptj-test-tiny`` widths. Tolerances:

- GPT-2: the port's mapping equals ``params_from_jax`` of JAX's mapping
  exactly, and its f32 logits agree with JAX's model on that tree to 1e-5.
- GPT-J: the port permutes each head's q and k rotary lanes from HF's
  interleaved order to split halves; its mapping equals ``params_from_jax``
  of JAX's mapping of a state dict whose q/k rows were so permuted first,
  exactly. Its f32 logits agree to 1e-4 with a plain forward that rotates
  HF's interleaved lane pairs (f32 sums in another order), and differ from
  one that rotates split halves of HF's lanes (what a mapping without the
  permutation computes) by at least WRONG_ROTARY_MIN (5) times that.
- Offload's pretrained host state is bitwise the dp init's weights.
"""

import importlib.util
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from saturn_tpu.models import ingest as jingest
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models import ingest
from saturn_tpu_torch.models.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32, GPTJ_F32 = 1e-5, 1e-4


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh_cache():
    ingest.release_cache()
    yield
    ingest.release_cache()


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].contiguous(), want[k]), k


def _gpt2_sd(smoke, seed=0, vocab=256, n_positions=64):
    return smoke.hf_gpt2_state_dict(tgpt2.config_for("test-tiny"), seed, vocab=vocab,
                                    n_positions=n_positions)


def _gptj_sd(smoke, seed=0, dtype=torch.float32, vocab=256):
    return smoke.hf_gptj_state_dict(tgpt2.config_for("gptj-test-tiny"), seed, vocab=vocab,
                                    dtype=dtype)


@pytest.mark.parametrize("vocab,positions", [(256, 64), (250, 128)])
def test_gpt2_mapping_matches_jax(smoke, vocab, positions):
    """Conv1D weights transposed into (out, in), fused qkv, the vocab padded
    with zero rows and positions cut to seq_len, as JAX maps them; HF's
    tied ``lm_head.weight`` is reported unused."""
    cfg = tgpt2.config_for("test-tiny")
    sd = _gpt2_sd(smoke, vocab=vocab, n_positions=positions)
    got, unused = ingest.gpt2_params_from_state_dict(sd, cfg)
    jtree, junused = jingest.gpt2_params_from_state_dict(_np(sd), cfg)
    _assert_same(got, params_from_jax(jtree))
    assert unused == junused == ["lm_head.weight"]
    assert torch.equal(got["wte"][vocab:], torch.zeros(256 - vocab, 64))


def test_gpt2_logits_match_jax(smoke, tmp_path):
    """``build_gpt2(pretrained=path)`` on a torch file against JAX's on the
    same file, f32, within 1e-5."""
    path = str(tmp_path / "gpt2.pt")
    torch.save(_gpt2_sd(smoke, seed=1), path)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 64))
    jspec = j_build_gpt2("test-tiny", pretrained=path, dtype=jax.numpy.float32,
                         attention="dense")
    want = np.asarray(jspec.apply_fn(jspec.init_fn(jax.random.PRNGKey(0)),
                                     jax.numpy.asarray(tokens, jax.numpy.int32)))
    spec = tgpt2.build_gpt2("test-tiny", pretrained=path, dtype=torch.float32,
                            attention="dense")
    model = spec.init_fn(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = spec.apply_fn(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


@pytest.mark.parametrize("tie", [False, True])
def test_gptj_mapping_matches_jax_on_permuted_lanes(smoke, tie):
    """JAX's mapping of the state dict with each head's q/k rotary rows put
    in split-half order is the port's mapping of the unpermuted one. The
    matrix not picked for ``wte`` and ``lm_head.bias`` are reported unused
    (JAX drops them without reporting them, against its own docstring)."""
    cfg = tgpt2.config_for("gptj-test-tiny")
    sd = _gptj_sd(smoke, seed=2)
    got, unused = ingest.gptj_params_from_state_dict(sd, cfg, tie_from_lm_head=tie)
    rows = ingest.rotary_rows(cfg.n_heads, cfg.head_dim, cfg.rotary_dim)
    permuted = _np(sd)
    for i in range(cfg.n_layers):
        for n in ("q", "k"):
            key = f"transformer.h.{i}.attn.{n}_proj.weight"
            permuted[key] = permuted[key][rows.numpy()]
    jtree, junused = jingest.gptj_params_from_state_dict(permuted, cfg, tie_from_lm_head=tie)
    _assert_same(got, params_from_jax(jtree))
    assert junused == []
    assert unused == ["lm_head.bias", "wte.weight" if tie else "lm_head.weight"]
    src = "lm_head.weight" if tie else "transformer.wte.weight"
    assert torch.equal(got["wte"], sd[src])
    D = cfg.d_model
    v = got["blocks.1.qkv.weight"][2 * D:]
    assert torch.equal(v, sd["transformer.h.1.attn.v_proj.weight"])  # v is not permuted


def test_rotary_rows_turn_pairs_into_halves():
    rows = ingest.rotary_rows(2, 8, 4)
    assert rows.tolist() == [0, 2, 1, 3, 4, 5, 6, 7, 8, 10, 9, 11, 12, 13, 14, 15]
    full = ingest.rotary_rows(1, 8, 8)
    assert full.tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_gptj_logits_match_the_interleaved_forward(smoke, tmp_path):
    """The ingested GPT-J computes HF's interleaved-rotary function (f32,
    1e-4); without the lane permutation the logits are at least 5 times
    further from it."""
    cfg = tgpt2.config_for("gptj-test-tiny")
    sd = _gptj_sd(smoke, seed=3)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 64)))
    ref = smoke.interleaved_gptj_logits(sd, cfg, tokens)
    split = smoke.interleaved_gptj_logits(sd, cfg, tokens, interleaved=False)
    spec = tgpt2.build_gpt2("gptj-test-tiny", pretrained=sd, dtype=torch.float32,
                            attention="dense")
    model = spec.init_fn(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = spec.apply_fn(model, tokens)
        # the same weights with HF's lanes left in place
        rows = ingest.rotary_rows(cfg.n_heads, cfg.head_dim, cfg.rotary_dim)
        undo = torch.empty_like(rows)
        undo[rows] = torch.arange(rows.numel())
        D = cfg.d_model
        for blk in model.blocks:
            blk.qkv.weight[:D] = blk.qkv.weight[:D][undo]
            blk.qkv.weight[D:2 * D] = blk.qkv.weight[D:2 * D][undo]
        unpermuted = spec.apply_fn(model, tokens)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=GPTJ_F32, atol=GPTJ_F32)
    np.testing.assert_allclose(unpermuted.numpy(), split.numpy(), rtol=GPTJ_F32, atol=GPTJ_F32)
    err = smoke.rel_norm(got, ref)
    wrong = smoke.rel_norm(unpermuted, ref)
    assert wrong >= smoke.WRONG_ROTARY_MIN * max(err, GPTJ_F32), (err, wrong)


def test_fp16_file_keeps_its_dtype_until_loaded(smoke, tmp_path):
    """A torch file is memory-mapped and mapped in its own dtype; the model
    casts on load, as JAX's init casts to the param dtype."""
    cfg = tgpt2.config_for("gptj-test-tiny")
    sd = _gptj_sd(smoke, seed=4, dtype=torch.float16)
    path = str(tmp_path / "gptj.pt")
    torch.save(sd, path)
    mapped, unused = ingest.cached_params_from_path(path, cfg)
    assert {t.dtype for t in mapped.values()} == {torch.float16}
    assert unused == ["lm_head.bias", "lm_head.weight"]
    assert ingest.cached_params_from_path(path, cfg)[0] is mapped  # size-1 cache hit
    spec = tgpt2.build_gpt2("gptj-test-tiny", pretrained=path)
    model = spec.init_fn(torch.Generator().manual_seed(0))
    assert model.wte.dtype == torch.float32
    assert torch.equal(model.wte, sd["transformer.wte.weight"].float())
    jtree, _ = jingest.cached_params_from_path(path, cfg)
    assert jtree["wte"].dtype == np.float16
    ingest.release_cache()
    assert ingest.cached_params_from_path(path, cfg)[0] is not mapped


def test_npz_and_module_files_load(smoke, tmp_path):
    sd = _gpt2_sd(smoke, seed=5)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **_np(sd))
    got = ingest.load_torch_state_dict(npz)
    jgot = jingest.load_torch_state_dict(npz)
    assert sorted(got) == sorted(jgot)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), jgot[k])
    legacy = str(tmp_path / "legacy.bin")
    torch.save(sd, legacy, _use_new_zipfile_serialization=False)  # not a zip: no mmap
    for k, v in ingest.load_torch_state_dict(legacy).items():
        assert torch.equal(v, sd[k])


@pytest.mark.parametrize("case", ["positions", "vocab", "family", "options", "preset"])
def test_errors_match_jax(smoke, case):
    """The JAX error cases, with its error types and messages."""
    cfg = tgpt2.config_for("test-tiny")
    if case == "positions":
        sd, match, exc = _gpt2_sd(smoke, n_positions=32), "positions", ValueError
    elif case == "vocab":
        sd, match, exc = _gpt2_sd(smoke, vocab=512), "vocab_size", ValueError
    elif case == "family":
        sd, match, exc = {"encoder.layer.0.w": torch.zeros(1)}, "unrecognized", ValueError
    elif case == "options":
        sd, match, exc = _gpt2_sd(smoke), "takes no options", TypeError
    else:
        sd, match, exc = _gpt2_sd(smoke), "wte", ValueError
    kw = {"tie_from_lm_head": True} if case == "options" else {}
    for mapper in (ingest.params_from_state_dict, jingest.params_from_state_dict):
        arg = sd if mapper is ingest.params_from_state_dict else _np(sd)
        with pytest.raises(exc, match=match):
            if case == "preset":
                mapped, _ = mapper(arg, cfg)
                if mapper is ingest.params_from_state_dict:
                    ingest.validate_against(
                        mapped, tgpt2.build_gpt2("test-tiny", d_model=32).abstract_init())
                else:
                    spec = j_build_gpt2("test-tiny", d_model=32)
                    jingest.validate_against(mapped, jax.eval_shape(
                        lambda: spec.init_fn(jax.random.PRNGKey(0))))
            else:
                mapper(arg, cfg, **kw)
    if case == "preset":
        with pytest.raises(ValueError, match="wte: got"):
            tgpt2.build_gpt2("test-tiny", pretrained=sd, d_model=32)


def test_pretrained_through_task_kwargs_under_dp_and_offload(smoke, tmp_path):
    """``HParams(kwargs={"pretrained": path})``: dp's init and offload's
    host state (filled after the buffers are allocated, the ingest cache
    released around it) hold the file's weights, bitwise equal."""
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.loss import pretraining_loss
    from saturn_tpu_torch.parallel import offload
    from saturn_tpu_torch.parallel.dp import DataParallel

    sd = _gptj_sd(smoke, seed=6, dtype=torch.float16)
    path = str(tmp_path / "gptj.pt")
    torch.save(sd, path)
    task = sat.Task(
        get_model=lambda **kw: tgpt2.build_gpt2("gptj-test-tiny", **kw),
        get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                                               n_tokens=64 * 4 * 4),
        loss_fn=pretraining_loss,
        hparams=sat.HParams(lr=1e-3, batch_count=2, kwargs={"pretrained": path}),
        save_dir=str(tmp_path / "ck"))
    cpu = [torch.device("cpu")]
    dp_model = DataParallel().build(task, cpu, {"remat": False}).init()["params"]
    state = offload.make_host_state(task.get_model(), task, pin=False, materialize=True)
    try:
        assert ingest._cache_val is None  # released after the fill
        host_model = state["params"]
        want = dp_model.state_dict()
        for name, t in host_model.state_dict().items():
            assert torch.equal(t, want[name]), name
        assert torch.equal(host_model.wte, sd["transformer.wte.weight"].float())
        flat = state["host"].params
        assert any(p.data_ptr() == flat.data_ptr() for p in host_model.parameters())
    finally:
        del state
        offload.release_host_states()
