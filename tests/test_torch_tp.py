"""The port's tensor parallelism against the JAX package's, and against the
port's dp; and the TP half of ``ops/collective_matmul.py``.

- A 5-step loss trajectory of the port's tp ``execute`` on ``[cpu] * n``
  matches the JAX package's compiled ``TensorParallel`` step over a
  ``(data, model)`` mesh of n host devices, from the same init (the JAX
  init, written by the JAX package's checkpoint and restored by the
  port's) and the same batches: n = 2 (tp 2) and n = 4 (tp 2 x data 2, and
  tp 4); the plain, ``zero`` and ``overlap`` configs; GPT-2 ``test-tiny``,
  ``llama-test-tiny`` (GQA and SwiGLU; at tp 4 two positions read one kv
  group) and BERT ``mlm_loss``. Both packages run f32; 1e-4 is the bound
  of ``tests/test_torch_fsdp.py`` (five optimizer steps of f32 sums taken
  in another order).
- tp against the port's dp on the same block and inputs: the losses within
  1e-5, and the parameters after SGD steps within 1e-5 by relative norm
  (the row-parallel sums reassociate). SGD, because AdamW's first steps
  move an element by about lr whatever the size of its gradient: the key
  bias's gradient is zero but for rounding (softmax ignores a constant
  added to a row of scores), so its elements move by +-lr on either
  side's rounding noise.
- Every position holds only its extent of each leaf the rule splits over
  ``model`` (shapes), attention runs on H / tp heads, and the replicated
  leaves stay bitwise equal across the positions after every step.
- The grid is the JAX package's ``candidate_configs`` for n in 1, 2, 4, 8.
- ``ring_all_gather`` and ``allgather_matmul`` (serial and overlapped, S in
  1, 2, 4) against the JAX package's inside ``shard_map`` on host devices.

Every case runs one intra-op torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import TokenDataset as JTokenDataset
from saturn_tpu.models import bert as jbert
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.ops.shmap_compat import shard_map
from saturn_tpu.parallel.tp import TensorParallel as JTP
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.data.lm_dataset import TokenDataset
from saturn_tpu_torch.models import bert as tbert
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.ops import collective_matmul as cm
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP
from saturn_tpu_torch.parallel.spmd_base import full_params, replicas
from saturn_tpu_torch.parallel.tp import TensorParallel
from saturn_tpu_torch.utils import checkpoint as ckpt

TRAJ_TOL = 1e-4
DP_TOL = 1e-5
STEPS, B, T, VOCAB = 5, 4, 64, 256
CPU = torch.device("cpu")
PLAIN2 = {"tp": 2, "remat": False, "zero": False}
ZERO2 = {"tp": 2, "remat": True, "zero": True}
OVERLAP2 = {"tp": 2, "remat": False, "zero": True, "overlap": True}
PLAIN4 = {"tp": 4, "remat": False, "zero": False}
ZERO4 = {"tp": 4, "remat": True, "zero": True}


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed=0, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab - 1, size=4 * STEPS * B * T).astype(np.int32)


def _untagged(fn):
    def loss(logits, tokens):
        return fn(logits, tokens)
    return loss


UNEVEN = dict(d_model=96, n_heads=6, n_kv_heads=3)
# dimensions tp does not divide, so the rule leaves the leaf whole: wte at
# tp 2 and 4, the MLP at tp 4; and qkv (36 + 2 x 9 = 54 columns) at tp 4
ODD = dict(vocab_size=251, d_ff=250)
ODD_QKV = dict(d_model=36, n_heads=4, n_kv_heads=1, attention="dense")

CASES = {
    # name: (port model, port loss, JAX model, JAX loss)
    "gpt2": (lambda **kw: tgpt2.build_gpt2("test-tiny", **kw), pretraining_loss,
             lambda: j_build_gpt2("test-tiny", dtype=jnp.float32), j_pretraining_loss),
    "llama": (lambda **kw: tgpt2.build_gpt2("llama-test-tiny", **kw), pretraining_loss,
              lambda: j_build_gpt2("llama-test-tiny", dtype=jnp.float32), j_pretraining_loss),
    # GQA whose heads read their kv groups unevenly at tp 2: position 0's
    # heads 0-2 read groups 0, 0, 1
    "llama-uneven": (lambda **kw: tgpt2.build_gpt2("llama-test-tiny", **dict(UNEVEN, **kw)),
                     pretraining_loss,
                     lambda: j_build_gpt2("llama-test-tiny", dtype=jnp.float32, **UNEVEN),
                     j_pretraining_loss),
    "gpt2-odd": (lambda **kw: tgpt2.build_gpt2("test-tiny", **dict(ODD, **kw)),
                 pretraining_loss,
                 lambda: j_build_gpt2("test-tiny", dtype=jnp.float32, **ODD),
                 j_pretraining_loss),
    "gpt2-odd-qkv": (lambda **kw: tgpt2.build_gpt2("test-tiny", **dict(ODD_QKV, **kw)),
                     pretraining_loss,
                     lambda: j_build_gpt2("test-tiny", dtype=jnp.float32, **ODD_QKV),
                     j_pretraining_loss),
    "bert": (lambda **kw: tbert.build_bert("bert-test-tiny", attention="dense", **kw),
             tbert.mlm_loss,
             lambda: jbert.build_bert("bert-test-tiny", dtype=jnp.float32, attention="dense"),
             jbert.mlm_loss),
}


def _vocab(case):
    return ODD["vocab_size"] if case == "gpt2-odd" else VOCAB


def _port_task(case, tmp_path, name="t", loss=None, batch_count=4 * STEPS, **hp):
    model, tloss, _, _ = CASES[case]
    tokens = _tokens(vocab=_vocab(case))
    return Task(get_model=model, get_dataloader=lambda: TokenDataset(tokens, T, B),
                loss_fn=loss or tloss,
                hparams=HParams(**dict(dict(lr=1e-3, batch_count=batch_count,
                                            kwargs={"dtype": torch.float32}), **hp)),
                name=name, save_dir=str(tmp_path))


def _jax_task(case, save_dir):
    _, _, model, loss = CASES[case]
    spec = model()
    tokens = _tokens(vocab=_vocab(case))
    return JTask(get_model=lambda **kw: spec, get_dataloader=lambda: JTokenDataset(tokens, T, B),
                 loss_fn=loss, hparams=JHParams(lr=1e-3, batch_count=4 * STEPS),
                 save_dir=save_dir)


def _run(tech, task, n, config, steps=STEPS):
    task.strategies[n] = Strategy(tech, n, dict(config), 0.0)
    task.select_strategy(n)
    tech.execute(task, [CPU] * n, 0, override_batch_count=steps)
    task.reconfigure(steps)  # the engine's cursor advance after an interval
    return list(task.last_losses)


def _jax_init(case, tmp_path, n, config):
    """The JAX package's tp init on n host devices, written by its
    checkpoint; and the bundle and state."""
    jtask = _jax_task(case, str(tmp_path / "jax"))
    bundle = JTP().build(jtask, jax.devices()[:n], dict(config))
    state = bundle.init()
    path = str(tmp_path / "init.npz")
    jckpt.save(path, state)
    return jtask, bundle, state, path


JAX_CASES = [
    ("gpt2", 2, PLAIN2), ("gpt2", 2, ZERO2), ("gpt2", 2, OVERLAP2),
    ("gpt2", 4, PLAIN2), ("gpt2", 4, ZERO2), ("gpt2", 4, PLAIN4), ("gpt2", 4, OVERLAP2),
    ("llama", 2, PLAIN2), ("llama", 4, PLAIN4), ("llama", 4, ZERO2),
    ("llama-uneven", 2, PLAIN2), ("bert", 2, PLAIN2), ("bert", 4, ZERO2),
    ("gpt2-odd", 2, PLAIN2), ("gpt2-odd", 4, ZERO2), ("gpt2-odd", 4, PLAIN4),
    ("gpt2-odd-qkv", 4, PLAIN4), ("gpt2-odd-qkv", 8, ZERO4),
]


@pytest.mark.parametrize("case,n,config", JAX_CASES,
                         ids=[f"{c}-n{n}-{'overlap' if k.get('overlap') else 'zero' if k['zero'] else 'plain'}-tp{k['tp']}"
                              for c, n, k in JAX_CASES])
def test_tp_matches_jax_tp(case, n, config, tmp_path):
    jtask, bundle, state, init_path = _jax_init(case, tmp_path, n, config)
    ds = jtask.get_dataset()
    want = []
    for i in range(STEPS):
        state, loss = bundle.compiled(state, jax.device_put(ds.batch(i), bundle.batch_sharding))
        want.append(float(loss))
    task = _port_task(case, tmp_path / "port")
    tech = TensorParallel()
    init = ckpt.restore(init_path, tech.build(task, [CPU] * n, config).empty())
    ckpt.save(task.ckpt_path, init)
    del init
    got = _run(tech, task, n, config)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert ckpt.saved_step(task.ckpt_path) == STEPS
    task.release_live_state()


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


@pytest.mark.parametrize("case,n,config", [
    ("gpt2", 2, PLAIN2), ("gpt2", 4, ZERO2), ("gpt2", 4, PLAIN4),
    ("llama", 2, ZERO2), ("llama", 4, PLAIN4), ("llama-uneven", 2, PLAIN2),
    ("bert", 4, PLAIN2),
], ids=["gpt2-n2", "gpt2-n4-zero", "gpt2-n4-tp4", "llama-n2-zero", "llama-n4-tp4",
        "llama-uneven-n2", "bert-n4"])
def test_tp_matches_dp_and_holds_its_extents(case, n, config, tmp_path):
    """The same block, inputs and loss route (the logits); each position's
    split leaves at their shard shapes, its replicated leaves bitwise every
    other position's after every step."""
    _, tloss, _, _ = CASES[case]
    task = _port_task(case, tmp_path, loss=_untagged(tloss), optimizer="sgd", lr=0.1)
    bd = DataParallel().build(task, [CPU] * n, {"remat": False})
    bt = TensorParallel().build(task, [CPU] * n, config)
    sd, st = bd.init(), bt.init()
    cfg = task.get_model().config
    tp = config["tp"]
    D, F, V = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    for rep in replicas(st):
        named = dict(rep["params"].named_parameters())
        assert named["wte"].shape == (V // tp, D)
        assert named["blocks.0.mlp_in.weight"].shape == (F // tp, D)
        assert named["blocks.0.mlp_in.bias"].shape == (F // tp,)
        assert named["blocks.0.attn_out.weight"].shape == (D, D // tp)
        assert named["blocks.0.mlp_out.weight"].shape == (D, F // tp)
        # qkv's column blocks, JAX's extents, gathered whole for compute
        assert rep["shards"]["blocks.0.qkv.weight"].shape == ((D + 2 * kv) // tp, D)
        assert named["blocks.0.qkv.weight"].shape == (D + 2 * kv, D)
        if cfg.mlp_act == "swiglu":
            assert named["blocks.0.mlp_gate.weight"].shape == (F // tp, D)
    replicated = [name for name, p in replicas(sd)[0]["params"].named_parameters()
                  if all(tuple(dict(rep["params"].named_parameters())[name].shape) == tuple(p.shape)
                         and name not in rep["shards"] for rep in replicas(st))]
    assert "ln_f.scale" in replicated and "blocks.0.attn_out.bias" in replicated
    for i in range(STEPS):
        sd, ld = bd.step(sd, bd.stage(task.batch_at(i)))
        st, lt = bt.step(st, bt.stage(task.batch_at(i)))
        assert abs(float(ld) - float(lt)) <= DP_TOL * abs(float(ld)), (i, float(ld), float(lt))
        reps = replicas(st)
        for name in replicated:
            first = dict(reps[0]["params"].named_parameters())[name]
            for rep in reps[1:]:
                assert torch.equal(first, dict(rep["params"].named_parameters())[name]), name
    want, got = full_params(sd), full_params(st)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel_norm(want[k], got[k]) <= DP_TOL, (k, _rel_norm(want[k], got[k]))


ODD_CASES = [("gpt2-odd", 2, PLAIN2, ["wte"]),
             ("gpt2-odd", 4, ZERO2, ["wte"]),
             ("gpt2-odd", 4, PLAIN4, ["wte", "blocks.0.mlp_in.weight", "blocks.0.mlp_out.weight"]),
             ("gpt2-odd-qkv", 4, PLAIN4, ["blocks.0.qkv.weight", "blocks.0.qkv.bias"]),
             ("gpt2-odd-qkv", 8, ZERO4, ["blocks.0.qkv.weight", "blocks.0.qkv.bias"])]


@pytest.mark.parametrize("case,n,config,whole", ODD_CASES,
                         ids=[f"{c}-n{n}-{'zero' if k['zero'] else 'plain'}-tp{k['tp']}"
                              for c, n, k, _ in ODD_CASES])
def test_a_leaf_the_rule_leaves_whole_is_computed_in_parts(case, n, config, whole, tmp_path):
    """tp does not divide the vocabulary, d_ff or qkv's width: the rule
    leaves those leaves whole over ``model`` (with ``zero`` qkv's kernel
    is split over ``data`` instead). Every position holds them whole and
    computes with its part; the step matches dp (on at most B positions:
    dp splits the batch over all of them), and every leaf a position holds
    whole stays bitwise equal across the positions."""
    _, tloss, _, _ = CASES[case]
    task = _port_task(case, tmp_path, loss=_untagged(tloss), optimizer="sgd", lr=0.1)
    bd = DataParallel().build(task, [CPU] * min(n, B), {"remat": False})
    bt = TensorParallel().build(task, [CPU] * n, config)
    sd, st = bd.init(), bt.init()
    shapes = {name: tuple(p.shape) for name, p in replicas(sd)[0]["params"].named_parameters()}
    held = [name for name in shapes
            if all(tuple(dict(rep["params"].named_parameters())[name].shape) == shapes[name]
                   for rep in replicas(st))]
    assert set(whole) <= set(held), sorted(set(whole) - set(held))
    for i in range(STEPS):
        sd, ld = bd.step(sd, bd.stage(task.batch_at(i)))
        st, lt = bt.step(st, bt.stage(task.batch_at(i)))
        assert abs(float(ld) - float(lt)) <= DP_TOL * abs(float(ld)), (i, float(ld), float(lt))
        reps = replicas(st)
        for name in held:
            first = dict(reps[0]["params"].named_parameters())[name]
            for rep in reps[1:]:
                assert torch.equal(first, dict(rep["params"].named_parameters())[name]), name
    want, got = full_params(sd), full_params(st)
    for k in want:
        assert _rel_norm(want[k], got[k]) <= DP_TOL, (k, _rel_norm(want[k], got[k]))


def test_attention_runs_on_the_positions_heads(tmp_path, monkeypatch):
    """Each position's attention sees H / tp query heads and the kv groups
    they read: llama-test-tiny (H 4, kv 2) at tp 4 gives every position one
    query head and one kv head, positions 2m and 2m + 1 reading group m."""
    seen = []
    orig = tgpt2._attend_heads

    def spy(cfg, qkv, n_q, n_kv, expand=None):
        seen.append((n_q, n_kv))
        return orig(cfg, qkv, n_q, n_kv, expand)

    monkeypatch.setattr(tgpt2, "_attend_heads", spy)
    task = _port_task("llama", tmp_path)
    bt = TensorParallel().build(task, [CPU] * 4, PLAIN4)
    st = bt.init()
    bt.step(st, bt.stage(task.batch_at(0)))
    cfg = task.get_model().config
    assert seen == [(1, 1)] * 4 * cfg.n_layers
    assert [tgpt2.tp_head_split(cfg, 4, m)[0][1] for m in range(4)] == [
        (64, 80), (64, 80), (80, 96), (80, 96)]
    # six heads over three kv groups at tp 2: heads 0-2 read groups 0, 0, 1
    # and heads 3-5 groups 1, 2, 2, so each position repeats its kv heads
    uneven = tgpt2.config_for("llama-test-tiny", **UNEVEN)
    assert [tgpt2.tp_head_split(uneven, 2, m)[1:] for m in range(2)] == [
        (3, 2, (0, 2, 0)), (3, 2, (3, 2, 1))]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_the_grid_is_jaxs(case, n, tmp_path):
    want = JTP().candidate_configs(_jax_task(case, str(tmp_path / "jax")), n)
    got = TensorParallel().candidate_configs(_port_task(case, tmp_path), n)
    assert got == want
    assert (got == []) == (n == 1)


def test_tp_is_a_builtin_technique_infeasible_on_one_position(tmp_path):
    from saturn_tpu_torch import library
    from saturn_tpu_torch.parallel import BUILTIN_TECHNIQUES

    assert BUILTIN_TECHNIQUES["tp"] is TensorParallel and TensorParallel.name == "tp"
    assert "tp" in library.register_default_library()
    task = _port_task("gpt2", tmp_path)
    tech = TensorParallel()
    assert tech.search(task, [CPU], 0) == (None, None)
    assert tech.search_report(task.name, 1) == {"memory_infeasible": False}
    # the JAX package's build refuses the mesh as well
    with pytest.raises(ValueError, match="does not divide a block of 1"):
        tech.build(task, [CPU], PLAIN2)


def test_a_config_the_block_cannot_factor_is_skipped(tmp_path):
    """batch 4 over a block of 8: tp 2 leaves a data axis of 4 (feasible),
    tp 4 one of 2; the ZeRO-3 points need the batch over all 8 and are not
    in the grid. JAX's search skips what its build refuses; so does the
    port's, before any trial."""
    task = _port_task("gpt2", tmp_path)
    tech = TensorParallel()
    assert tech._config_refusal(task, 8, PLAIN2) is None
    assert "batch_size 4 not divisible by data*model=8" in tech._config_refusal(task, 8, OVERLAP2)
    assert "n_heads 4" in tech._config_refusal(task, 8, {"tp": 8})


def test_the_static_screen_prices_one_positions_extents(tmp_path):
    task = _port_task("gpt2", tmp_path)
    tech, dp = TensorParallel(), DataParallel()
    full = dp.state_bytes(task, PLAIN2)
    assert tech.state_bytes(task, PLAIN2, 1) == full
    two = tech.state_bytes(task, PLAIN2, 2)
    assert full // 2 < two < full
    st = tech.build(task, [CPU] * 2, PLAIN2).init()
    rep = replicas(st)[0]
    held = sum(p.numel() * 4 for p in rep["params"].parameters())
    apart = sum(s.numel() * 4 for name, s in rep["shards"].items()
                if s is not dict(rep["params"].named_parameters())[name])
    stepped = sum(p.numel() * 4 for g in rep["opt_state"].param_groups for p in g["params"])
    assert two == 2 * held + 2 * apart + 2 * stepped


# ------------------------------------------------- collective matmul
def _jax_ring(x, S):
    from saturn_tpu.ops.collective_matmul import ring_all_gather

    mesh = Mesh(np.array(jax.devices()[:S]), ("data",))
    sm = shard_map(lambda xs: ring_all_gather(xs, axis_name="data", axis_size=S, axis=0),
                   mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(sm)(x))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_ring_all_gather_matches_jaxs(S):
    x = np.random.default_rng(S).standard_normal((8, 6)).astype(np.float32)
    parts = [torch.from_numpy(c.copy()) for c in np.split(x, S)]
    got = cm.ring_all_gather(parts, axis=0)
    want = _jax_ring(x, S)
    assert len(got) == S
    for g in got:
        assert g.numpy().tobytes() == want.tobytes() == x.tobytes()


def test_ring_all_gather_places_by_source_along_any_axis():
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    got = cm.ring_all_gather(list(x.chunk(3, dim=1)), axis=1)
    for g in got:
        assert torch.equal(g, x)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_allgather_matmul_matches_jaxs(S, overlap):
    from saturn_tpu.ops.collective_matmul import allgather_matmul

    rng = np.random.default_rng(10 + S)
    K, N, Bx = 16, 10, 5
    x = rng.standard_normal((Bx, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:S]), ("data",))
    sm = shard_map(lambda ws: allgather_matmul(jnp.asarray(x), ws, axis_name="data",
                                               axis_size=S, overlap=overlap),
                   mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(sm)(w))
    got = cm.allgather_matmul([torch.from_numpy(x)] * S,
                              [torch.from_numpy(c.copy()) for c in np.split(w, S)],
                              overlap=overlap)
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    if not overlap:
        # the serial form is the ring gather then one product: bitwise the
        # product of the whole weight
        assert got[0].numpy().tobytes() == (torch.from_numpy(x) @ torch.from_numpy(w)).numpy().tobytes()


# ------------------------------------------------- checkpoints
def _table(manifest):
    return {k: (e["shape"], e["dtype"], e["stored_dtype"],
                sorted(sh["index"] for sh in e["shards"]))
            for k, e in manifest["leaves"].items()}


@pytest.mark.parametrize("n,config", [(2, PLAIN2), (4, ZERO2), (4, PLAIN4), (4, OVERLAP2)],
                         ids=["n2", "n4-zero", "n4-tp4", "n4-overlap"])
def test_tp_manifests_of_both_packages_match(n, config, tmp_path):
    jtask, _, _, jpath = _jax_init("gpt2", tmp_path, n, config)
    task = _port_task("gpt2", tmp_path / "port")
    state = TensorParallel().build(task, [CPU] * n, config).init()
    ckpt.save(task.ckpt_path, state)
    jm, pm = jckpt._read_manifest(jpath), ckpt._read_manifest(task.ckpt_path)
    assert _table(pm) == _table(jm)
    assert pm["pspec_fingerprint"] == jm["pspec_fingerprint"]
    # the port's tp init is the JAX package's draw only through a
    # checkpoint; the port's restores it onto its own tp block bitwise
    got = ckpt.restore(jpath, TensorParallel().build(task, [CPU] * n, config).empty())
    want = jckpt.load_arrays(jpath)
    assert full_params(got)["wte"].numpy().tobytes() == want["params/wte"].tobytes()


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("tech,n,config", [(TensorParallel, 2, PLAIN2),
                                           (TensorParallel, 4, ZERO2),
                                           (DataParallel, 1, {"remat": False})],
                         ids=["tp2", "tp2x2-zero", "dp1"])
def test_a_jax_tp_checkpoint_restores_in_the_port(tech, n, config, tmp_path):
    _, _, _, jpath = _jax_init("gpt2", tmp_path, 4, ZERO2)
    task = _port_task("gpt2", tmp_path / "port")
    state = ckpt.restore(jpath, tech().build(task, [CPU] * n, config).empty())
    want = jckpt.load_arrays(jpath)
    from saturn_tpu_torch.models.convert import params_to_jax

    for k, v in _flat(params_to_jax(full_params(state)), "params/").items():
        assert np.ascontiguousarray(v).tobytes() == want[k].tobytes(), k
    # and the state steps from there
    bundle = tech().build(task, [CPU] * n, config)
    state, loss = bundle.step(state, bundle.stage(task.batch_at(0)))
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("n,config", [(2, PLAIN2), (4, ZERO2)], ids=["tp2", "tp2x2-zero"])
def test_a_port_tp_checkpoint_reads_in_jax(n, config, tmp_path):
    from saturn_tpu_torch.models.convert import params_to_jax

    task = _port_task("gpt2", tmp_path)
    bundle = TensorParallel().build(task, [CPU] * n, config)
    state = bundle.init()
    for i in range(2):
        state, _ = bundle.step(state, bundle.stage(task.batch_at(i)))
    ckpt.save(task.ckpt_path, state)
    assert jckpt.verify(task.ckpt_path)
    arrays = jckpt.load_arrays(task.ckpt_path)
    for k, v in _flat(params_to_jax(full_params(state)), "params/").items():
        assert arrays[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    assert int(arrays["step"]) == 2 and int(arrays["opt_state/0/count"]) == 2
    # the JAX package places it on its own tp mesh and steps on
    jtask = _jax_task("gpt2", str(tmp_path / "jax"))
    jb = JTP().build(jtask, jax.devices()[:n], dict(config))
    jstate = jckpt.restore_sharded(task.ckpt_path, jb.state_shapes, jb.state_shardings)
    assert np.asarray(jstate["params"]["wte"]).tobytes() == arrays["params/wte"].tobytes()
    jstate, loss = jb.compiled(jstate, jax.device_put(jtask.get_dataset().batch(2),
                                                      jb.batch_sharding))
    assert np.isfinite(float(loss))


CHAINS = {
    "tp-dp-tp": lambda: [(TensorParallel(), 2, PLAIN2), (DataParallel(), 2, {"remat": False}),
                         (TensorParallel(), 4, ZERO2)],
    # the JAX package's dp -> fsdp -> tp columns (tests/test_ckpt_sharded.py)
    "dp-fsdp-tp": lambda: [(DataParallel(), 4, {"remat": False}),
                           (FSDP(), 4, {"remat": False, "offload": False}),
                           (TensorParallel(), 4, PLAIN4)],
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_a_chain_of_techniques_restores_bitwise(chain, tmp_path):
    """Switches between intervals: each interval restores the checkpoint
    the previous one wrote; each restore placed onto the next technique's
    block and written again is the same bytes."""
    task = _port_task("gpt2", tmp_path, name="chain")
    plan = CHAINS[chain]()
    for i, (tech, n, config) in enumerate(plan):
        _run(tech, task, n, config, steps=2)
        ckpt.flush()
        nxt = plan[(i + 1) % len(plan)]
        placed = ckpt.restore(task.ckpt_path, nxt[0].build(task, [CPU] * nxt[1], nxt[2]).empty())
        again = str(tmp_path / f"again{i}.pt")
        ckpt.save(again, placed)
        want, got = ckpt.load_arrays(task.ckpt_path), ckpt.load_arrays(again)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].tobytes() == got[k].tobytes(), (i, k)
    assert [r["restored"] for r in plan[0][0].intervals + plan[1][0].intervals
            + plan[2][0].intervals] == [False, True, True]
    assert ckpt.saved_step(task.ckpt_path) == 6
    task.release_live_state()


# ------------------------------------------------- the control plane
@pytest.mark.parametrize("pool", [2, 4])
def test_search_dp_fsdp_tp_then_orchestrate(pool, tmp_path):
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.utils import metrics

    task = _port_task("gpt2", tmp_path, loss=_untagged(pretraining_loss), batch_count=6)
    events = str(tmp_path / "events.jsonl")
    topo = SliceTopology([CPU] * pool)
    sat.library.register_default_library()
    sat.search([task], technique_names=["dp", "fsdp", "tp"], topology=topo,
               metrics_path=events, fusion=False)
    trials = [e for e in metrics.read_events(events) if e["kind"] == "trial"]
    assert {e["technique"] for e in trials} == {"dp", "fsdp", "tp"}
    tp_sizes = {e["size"] for e in trials if e["technique"] == "tp"}
    assert tp_sizes == set(range(1, pool + 1)) & {1, 2, 4}
    feasible = {g: s for g, s in task.feasible_strategies().items()}
    assert all(g in feasible for g in (1, pool))
    out = sat.orchestrate([task], interval=1e9, topology=topo, fusion=False)
    assert out["completed"] == [task.name] and ckpt.saved_step(task.ckpt_path) == 6
    task.release_live_state()
    # a tp-only sweep over the same pool: tp trains the plan to its budget
    task2 = _port_task("gpt2", tmp_path / "tp", name="only-tp",
                       loss=_untagged(pretraining_loss), batch_count=6)
    sat.search([task2], technique_names=["tp"], topology=topo, fusion=False)
    assert 1 not in task2.feasible_strategies() and pool in task2.feasible_strategies()
    out = sat.orchestrate([task2], interval=1e9, topology=topo, fusion=False)
    assert out["completed"] == ["only-tp"] and ckpt.saved_step(task2.ckpt_path) == 6
    assert task2.selected_strategy.executor.name == "tp"
    task2.release_live_state()


def test_a_kill_at_mid_interval_under_tp_resumes_where_a_whole_run_ends(tmp_path, monkeypatch):
    import saturn_tpu_torch as sat
    from saturn_tpu_torch import resilience as res
    from saturn_tpu_torch.core.mesh import SliceTopology

    monkeypatch.setattr(Task, "apply_realized_feedback", lambda self: None)
    topo = SliceTopology([CPU] * 2)

    def tasks(save):
        t = _port_task("gpt2", save, name="k", batch_count=8)
        t.strategies = {2: Strategy(TensorParallel(), 2, dict(PLAIN2), 8.0, 1.0)}
        return [t]

    ref = tasks(tmp_path / "ref")
    sat.orchestrate(ref, interval=3.5, topology=topo, resume_dir=str(tmp_path / "A"))
    root, save = str(tmp_path / "B"), tmp_path / "kill"
    first = tasks(save)
    with pytest.raises(res.SimulatedKill) as info:
        sat.orchestrate(first, interval=3.5, topology=topo, resume_dir=root,
                        crash_barrier=res.CrashInjector("mid-interval", hit=1).barrier)
    import traceback

    traceback.clear_frames(info.value.__traceback__)
    for t in first:
        t.release_live_state()
        t.release_compiled()
    del info, first
    again = tasks(save)
    out = sat.orchestrate(again, interval=3.5, topology=topo, resume_dir=root)
    assert out["completed"] == ["k"] and out["failed"] == {}
    want, got = ckpt.load_arrays(ref[0].ckpt_path), ckpt.load_arrays(again[0].ckpt_path)
    assert int(got["step"]) == int(want["step"]) == 8
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k
    for t in ref + again:
        t.release_live_state()


class HeldTP(TensorParallel):
    """The port's tp; a held call waits for the loss first (the elastic
    harness's ``HeldDP`` rule)."""

    def __init__(self, seen=None, hold=None):
        import threading

        super().__init__()
        self.seen, self.hold = seen, hold or {}
        self.calls, self.count, self.lock = [], {}, threading.Lock()

    def execute(self, task, devices, tid, override_batch_count=None, window_size=None):
        with self.lock:
            self.count[task.name] = k = self.count.get(task.name, 0) + 1
            self.calls.append((task.name, len(devices)))
        need = self.hold.get(task.name, {}).get(k)
        if need is not None:
            assert self.seen.wait(need), "the held run saw no loss"
        super().execute(task, devices, tid, override_batch_count, window_size)


def test_an_elastic_shrink_of_a_tp_task_to_one_position_fails_as_jaxs(tmp_path, monkeypatch):
    """A 2-position pool loses position 1 with no return (the seeded
    schedule of ``tests/test_torch_multidevice_elastic.py``): the task's
    only profiled size is tp's 2, so the replanner synthesizes size 1 with
    tp's config, as the JAX package's does. tp cannot run on one position:
    the JAX package's build raises there (its mesh of 1 // 2 x 2), and so
    does the port's, so the task is retried once and fails in both
    packages, its checkpoint at the steps it had. The JAX side runs the
    harness's checkpointing fake, raising at size 1 what JAX's tp raises."""
    import test_torch_multidevice_elastic as mde

    jtask = _jax_task("gpt2", str(tmp_path / "jaxcheck"))
    with pytest.raises(ValueError, match="do not multiply to 1 devices"):
        JTP().build(jtask, jax.devices()[:1], dict(PLAIN2))

    port_task = mde._port_task

    def tp_task(name, total, pbts, tech, save_dir):
        task = port_task(name, total, pbts, tech, save_dir)
        for s in task.strategies.values():
            s.params = dict(PLAIN2)
        return task

    fake_tech = mde._fake_tech

    def failing_fake(seen, ckpt_dir, hold):
        fake = fake_tech(seen, ckpt_dir, hold)
        run = fake.execute

        def execute(task, devices, tid, override_batch_count=None):
            if len(devices) == 1:
                with fake.lock:
                    fake.calls.append((task.name, 1))
                raise ValueError("axis sizes [0, 2] do not multiply to 1 devices")
            return run(task, devices, tid, override_batch_count)

        fake.execute = execute
        return fake

    monkeypatch.setattr(mde, "HeldDP", HeldTP)
    monkeypatch.setattr(mde, "_port_task", tp_task)
    monkeypatch.setattr(mde, "_fake_tech", failing_fake)
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_GROW_HYSTERESIS", "SATURN_TPU_SOLVE_DEADLINE",
                 "SATURN_TPU_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)
    import saturn_tpu.resilience.health as jhealth
    from saturn_tpu.executor import engine as jengine

    from saturn_tpu_torch.resilience import health

    losses = {"torch": mde.Losses(), "jax": mde.Losses()}
    for key, cls in (("torch", health.FleetHealthMonitor), ("jax", jhealth.FleetHealthMonitor)):
        orig = cls.mark_lost

        def mark_lost(self, idx, cause="device_loss", orig=orig, seen=losses[key]):
            orig(self, idx, cause=cause)
            with seen.cond:
                seen.monitors.append(self)
                seen.n += 1
                seen.cond.notify_all()

        monkeypatch.setattr(cls, "mark_lost", mark_lost)
    orig_execute = jengine.execute

    def jexecute(run_tasks, batches, interval, plan, topology, *a, **kw):
        for t in run_tasks:
            t._block = plan.assignments[t.name].block
        return orig_execute(run_tasks, batches, interval, plan, topology, *a, **kw)

    monkeypatch.setattr(jengine, "execute", jexecute)
    specs = [("pair", 10, {2: mde.PER_BATCH})]
    out = mde._run_both(tmp_path, losses, specs, n_devices=2, seed=27,
                        hold={"pair": {2: 1}}, interval=0.15)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["synthesized"] == [{"pair": [1]}]
    assert got["failed"] == ["pair"] and got["completed"] == []
    sizes = [size for _, size in out["torch_calls"]]
    assert sizes[:2] == [2, 2] and set(sizes[2:]) == {1}
    assert [size for _, size in out["jax_calls"]] == sizes


@pytest.mark.parametrize("n,config", [(2, PLAIN2), (4, ZERO2)], ids=["tp2", "tp2x2-zero"])
def test_a_jax_tp_state_and_the_ports_map_leaf_for_leaf(n, config, tmp_path):
    """Each JAX device's blocks of the params (``addressable_shards``)
    through ``params_from_jax``'s extent form are, bitwise, what the port's
    position of the same mesh coordinate holds after restoring the same
    init; ``params_to_jax`` of a position's tensors gives its blocks back."""
    from saturn_tpu.utils.treepath import path_str

    from saturn_tpu_torch.models.convert import params_from_jax, params_to_jax

    _, _, jstate, path = _jax_init("gpt2", tmp_path, n, config)
    task = _port_task("gpt2", tmp_path / "port")
    state = ckpt.restore(path, TensorParallel().build(task, [CPU] * n, config).empty())
    devices = jax.devices()[:n]
    for r, rep in enumerate(replicas(state)):
        blocks, exts = {}, {}
        for p, leaf in jax.tree_util.tree_flatten_with_path(jstate["params"])[0]:
            key = path_str(p)
            shard = next(s for s in leaf.addressable_shards if s.device == devices[r])
            node = blocks
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(shard.data)
            exts[key] = tuple((0 if sl.start is None else sl.start,
                               dim if sl.stop is None else sl.stop)
                              for sl, dim in zip(shard.index, leaf.shape))
        held = {name: rep["shards"].get(name, p).detach()
                for name, p in rep["params"].named_parameters()}
        got = params_from_jax(blocks, exts)
        assert got.keys() == held.keys()
        for name in held:
            assert got[name].numpy().tobytes() == held[name].numpy().tobytes(), (r, name)
        back = _flat(params_to_jax(held), "")
        for key, arr in _flat(blocks, "").items():
            assert back[key].tobytes() == np.ascontiguousarray(arr).tobytes(), (r, key)
