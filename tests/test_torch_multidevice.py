"""The port's dp over a block of n replicas against the JAX package's dp
over n of the forced host devices.

- A 5-step loss trajectory of the port's ``execute`` on ``[cpu] * n``
  matches the JAX package's compiled dp step over a ``data`` mesh of n host
  devices, for n = 2 and 4, from the same init (the JAX init, restored into
  every replica from a step-0 checkpoint) and the same batches: GPT-2
  ``test-tiny`` through the fused head's ``(loss_sum, valid_count)`` parts
  and over the logits (an untagged copy of the loss), BERT ``mlm_loss``
  both ways, and a padded MLM objective (the static mask less the
  positions that hold the pad id) whose replicas hold different counts of
  valid labels, both ways. Both packages run f32; the JAX package's CE head
  on the CPU is its plain fallback, the port's its plain version. 1e-4:
  five optimizer steps of f32 sums taken in another order (the bound of
  ``tests/test_torch_train.py``).
- The replicas stay bitwise equal after every step, on both loss routes.
- A checkpoint written at 4 replicas restores bitwise into blocks of 2
  and 1, and training goes on there.

Every case runs one intra-op torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import TokenDataset as JTokenDataset
from saturn_tpu.models import bert as jbert
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.data.lm_dataset import TokenDataset
from saturn_tpu_torch.models import bert as tbert
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.spmd_base import replicas
from saturn_tpu_torch.utils import checkpoint as ckpt

TRAJ_TOL = 1e-4
STEPS, B, T, VOCAB, PAD = 5, 4, 64, 256, 0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed=0):
    """Token stream for ``STEPS`` batches of B x T: ids below the reserved
    top id, and in the first half of each batch's rows most positions hold
    the pad id (the padded objective's replicas see uneven counts)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, VOCAB - 1, size=(2 * STEPS * B, T))
    for i in range(len(rows)):
        if i % B < B // 2:
            rows[i, rng.random(T) < 0.8] = PAD
    return rows.reshape(-1).astype(np.int32)


# ------------------------------------------------------- the padded objective
def t_pad_mlm_loss(logits, tokens):
    """Mean CE at the masked positions that do not hold the pad id."""
    B_, T_ = tokens.shape
    m = (tbert._mask(T_, tokens.device)[None, :] & (tokens != PAD)).float()
    ce = torch.nn.functional.cross_entropy(logits.float().reshape(B_ * T_, -1),
                                           tokens.reshape(-1).long(), reduction="none")
    return (ce.reshape(B_, T_) * m).sum() / m.sum().clamp_min(1)


t_pad_mlm_loss.supports_fused_head = "mlm-pad"


def j_pad_mlm_loss(logits, tokens):
    import optax

    B_, T_ = tokens.shape
    m = (jbert._mask(T_)[None, :] & (tokens != PAD)).astype(jnp.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), tokens)
    return (ce * m).sum() / jnp.maximum(m.sum(), 1)


j_pad_mlm_loss.supports_fused_head = "mlm-pad"


def t_pad_bert(**kw):
    """``bert-test-tiny`` whose fused head also ignores the pad positions."""
    cfg = tbert.build_bert("bert-test-tiny", **kw).config
    mask_id = cfg.vocab_size - 1

    def mask_tokens(tokens):
        return torch.where(tbert._mask(tokens.shape[-1], tokens.device)[None, :],
                           torch.full_like(tokens, mask_id), tokens)

    def labels(tokens):
        keep = tbert._mask(tokens.shape[-1], tokens.device)[None, :] & (tokens != PAD)
        return torch.where(keep, tokens.to(torch.int32), -1)

    return tgpt2.spec_for(cfg, inputs_fn=mask_tokens, labels_fn=labels, objective="mlm-pad")


def j_pad_bert(**kw):
    spec = jbert.build_bert("bert-test-tiny", **kw)
    mask_id = spec.config.vocab_size - 1

    def parts(params, tokens):
        from saturn_tpu.ops.ce import fused_linear_cross_entropy

        m = jbert._mask(tokens.shape[-1])[None, :]
        x = spec.hidden_fn(params, jnp.where(m, mask_id, tokens))
        labels = jnp.where(m & (tokens != PAD), tokens.astype(jnp.int32), -1)
        return fused_linear_cross_entropy(x, params["wte"], labels, reduction="sum_count")

    def mean(params, tokens):
        s, c = parts(params, tokens)
        return s / jnp.maximum(c, 1)

    return dataclasses.replace(spec, fused_loss_fn=mean, fused_loss_parts_fn=parts,
                               fused_loss_objective="mlm-pad")


def _untagged(fn):
    def loss(logits, tokens):
        return fn(logits, tokens)
    return loss


CASES = {
    # name: (port model, port loss, JAX model, JAX loss)
    "gpt2-fused": (lambda **kw: tgpt2.build_gpt2("test-tiny", **kw), pretraining_loss,
                   lambda: j_build_gpt2("test-tiny", dtype=jnp.float32), j_pretraining_loss),
    "gpt2-logits": (lambda **kw: tgpt2.build_gpt2("test-tiny", **kw), _untagged(pretraining_loss),
                    lambda: j_build_gpt2("test-tiny", dtype=jnp.float32),
                    _untagged(j_pretraining_loss)),
    "bert-fused": (lambda **kw: tbert.build_bert("bert-test-tiny", attention="dense", **kw),
                   tbert.mlm_loss,
                   lambda: jbert.build_bert("bert-test-tiny", dtype=jnp.float32,
                                            attention="dense"), jbert.mlm_loss),
    "bert-logits": (lambda **kw: tbert.build_bert("bert-test-tiny", attention="dense", **kw),
                    _untagged(tbert.mlm_loss),
                    lambda: jbert.build_bert("bert-test-tiny", dtype=jnp.float32,
                                             attention="dense"), _untagged(jbert.mlm_loss)),
    "bert-pad-fused": (lambda **kw: t_pad_bert(attention="dense", **kw), t_pad_mlm_loss,
                       lambda: j_pad_bert(dtype=jnp.float32, attention="dense"),
                       j_pad_mlm_loss),
    "bert-pad-logits": (lambda **kw: t_pad_bert(attention="dense", **kw),
                        _untagged(t_pad_mlm_loss),
                        lambda: j_pad_bert(dtype=jnp.float32, attention="dense"),
                        _untagged(j_pad_mlm_loss)),
}


def _port_task(case, tmp_path, name="t"):
    model, loss, _, _ = CASES[case]
    tokens = _tokens()
    return Task(get_model=model, get_dataloader=lambda: TokenDataset(tokens, T, B),
                loss_fn=loss,
                hparams=HParams(lr=1e-3, batch_count=2 * STEPS,
                                kwargs={"dtype": torch.float32}),
                name=name, save_dir=str(tmp_path))


def _jax_run(case, n, save_dir):
    """The JAX package's dp over ``n`` host devices: its init params and
    its 5-step losses."""
    _, _, model, loss = CASES[case]
    spec = model()
    tokens = _tokens()
    jtask = JTask(get_model=lambda **kw: spec, get_dataloader=lambda: JTokenDataset(tokens, T, B),
                  loss_fn=loss, hparams=JHParams(lr=1e-3, batch_count=2 * STEPS),
                  save_dir=save_dir)
    bundle = JDataParallel().build(jtask, jax.devices()[:n], {})
    state = bundle.init()
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    ds = jtask.get_dataset()
    losses = []
    for i in range(STEPS):
        state, loss_v = bundle.compiled(state, jax.device_put(ds.batch(i), bundle.batch_sharding))
        losses.append(float(loss_v))
    return params0, losses


def _assert_replicas_equal(state):
    reps = replicas(state)
    for rep in reps[1:]:
        for (name, a), b in zip(reps[0]["params"].named_parameters(),
                                rep["params"].parameters()):
            assert torch.equal(a, b), name
        for p0, p1 in zip(reps[0]["params"].parameters(), rep["params"].parameters()):
            s0, s1 = reps[0]["opt_state"].state[p0], rep["opt_state"].state[p1]
            for k in s0:
                assert torch.equal(torch.as_tensor(s0[k]), torch.as_tensor(s1[k])), k


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_dp_over_replicas_matches_jax_dp(case, n, tmp_path):
    params0, want = _jax_run(case, n, str(tmp_path / "jax"))
    task = _port_task(case, tmp_path / "port")
    tech, devices = DataParallel(), [CPU] * n
    state = tech.build(task, devices, {"remat": False}).empty()
    state["params"].load_state_dict(params_from_jax(params0))
    ckpt.save(task.ckpt_path, state)
    task.strategies[n] = Strategy(tech, n, {"remat": False}, 0.0)
    task.select_strategy(n)
    tech.execute(task, devices, 0, override_batch_count=STEPS)
    np.testing.assert_allclose(task.last_losses, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert ckpt.load(task.ckpt_path)["step"] == STEPS
    _assert_replicas_equal(task._live_state[1])
    task.release_live_state()


@pytest.mark.parametrize("case", ["gpt2-fused", "bert-pad-logits"])
def test_replicas_stay_bitwise_equal_after_every_step(case, tmp_path):
    task = _port_task(case, tmp_path)
    bundle = DataParallel().build(task, [CPU] * 4, {"remat": False})
    state = bundle.init()
    _assert_replicas_equal(state)
    for i in range(3):
        state, loss = bundle.step(state, bundle.stage(task.batch_at(i)))
        assert np.isfinite(float(loss))
        _assert_replicas_equal(state)
        # the gradient buffers are zeroed after the update
        assert all(float(rep["grads"].abs().max()) == 0.0 for rep in replicas(state))


def test_a_checkpoint_of_four_replicas_restores_into_two_and_one(tmp_path):
    task = _port_task("gpt2-fused", tmp_path)
    tech = DataParallel()
    b4 = tech.build(task, [CPU] * 4, {"remat": False})
    state = b4.init()
    for i in range(3):
        state, _ = b4.step(state, b4.stage(task.batch_at(i)))
    ckpt.save(task.ckpt_path, state)
    saved = ckpt.load(task.ckpt_path)
    assert saved["step"] == 3
    for n in (2, 1):
        bundle = tech.build(task, [CPU] * n, {"remat": False})
        got = ckpt.restore(task.ckpt_path, bundle.empty())
        assert got["step"] == 3 and len(replicas(got)) == n
        for rep in replicas(got):
            for k, v in saved["params"].items():
                assert torch.equal(rep["params"].state_dict()[k], v), k
            sd = rep["opt_state"].state_dict()["state"]
            for i, per in saved["opt_state"]["state"].items():
                for k, v in per.items():
                    assert torch.equal(torch.as_tensor(sd[i][k]), torch.as_tensor(v)), (i, k)
        _assert_replicas_equal(got)
        # the moments of the replicas are their own tensors, not shared
        if n > 1:
            reps = replicas(got)
            p0, p1 = (next(r["params"].parameters()) for r in reps[:2])
            assert (reps[0]["opt_state"].state[p0]["exp_avg"].data_ptr()
                    != reps[1]["opt_state"].state[p1]["exp_avg"].data_ptr())
        got, loss = bundle.step(got, bundle.stage(task.batch_at(3)))
        assert np.isfinite(float(loss)) and got["step"] == 4
        _assert_replicas_equal(got)
