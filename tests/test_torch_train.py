"""The port's optimizers, dp train step and checkpoint resume against the JAX
package.

- One AdamW / Adam / SGD step matches optax on the same params and grads
  (f32; 1e-6: one elementwise update).
- A 5-step ``test-tiny`` loss trajectory through the port's dp ``execute``
  matches the JAX package's own dp train step on the same init and batches
  (f32 on both sides, both through the fused head with its bf16 logits
  stash; 1e-4: five optimizer steps of f32 sums taken in another order).
- Resuming from a mid-run checkpoint equals the uninterrupted run exactly
  (same process, same arithmetic), with the data cursor right.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.utils import checkpoint as ckpt

OPT_TOL, TRAJ_TOL = 1e-6, 1e-4
CPU = [torch.device("cpu")]


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_step_matches_optax(name):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    lr = 1e-2

    tx = JHParams(lr=lr, batch_count=1, optimizer=name).make_optimizer()
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = HParams(lr=lr, batch_count=1, optimizer=name).make_optimizer([tp])
    for g in grads:  # three steps: bias corrections differ per step
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=OPT_TOL, atol=OPT_TOL)


def _loader():
    return make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                           n_tokens=64 * 4 * 8)


def _task(tmp_path, name="t0", **hp):
    task = Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **kw),
        get_dataloader=_loader,
        loss_fn=pretraining_loss,
        hparams=HParams(lr=1e-3, batch_count=8,
                        kwargs={"dtype": torch.float32}, **hp),
        name=name,
        save_dir=str(tmp_path),
    )
    tech = DataParallel()
    task.strategies[1] = Strategy(tech, 1, {"remat": False}, 0.0)
    task.select_strategy(1)
    return task, tech


def _jax_trajectory(n_steps, save_dir):
    """Losses of the JAX package's own dp train step, and its init params."""
    spec = j_build_gpt2("test-tiny", dtype=jnp.float32)
    jtask = JTask(get_model=lambda **kw: spec, get_dataloader=lambda: j_make_lm_dataset(
        context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
        loss_fn=j_pretraining_loss, hparams=JHParams(lr=1e-3, batch_count=8),
        save_dir=save_dir)
    ds = jtask.get_dataset()
    init_state, train_step = JDataParallel().make_step_fns(spec, jtask, {}, None, ds)
    state = init_state()
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(train_step)
    losses = []
    for i in range(n_steps):
        state, loss = step(state, jnp.asarray(ds.batch(i)))
        losses.append(float(loss))
    return params0, losses


def test_dp_trajectory_matches_jax(tmp_path, monkeypatch):
    # Both sides take the fused head: the port's plain version, and the JAX
    # Pallas kernels in interpret mode (the JAX model imports
    # fused_linear_cross_entropy at call time), both with a bf16 logits stash.
    from saturn_tpu.ops import ce as jce

    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))
    params0, want = _jax_trajectory(5, str(tmp_path / "jax"))
    task, tech = _task(tmp_path)
    # start the port from the JAX init: a step-0 checkpoint of those weights
    state = tech.build(task, CPU, {"remat": False}).empty()
    state["params"].load_state_dict(params_from_jax(params0))
    ckpt.save(task.ckpt_path, state)
    tech.execute(task, CPU, 0, override_batch_count=5)
    np.testing.assert_allclose(task.last_losses, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert ckpt.load(task.ckpt_path)["step"] == 5


def test_resume_equals_uninterrupted(tmp_path):
    whole, tech = _task(tmp_path / "a")
    tech.execute(whole, CPU, 0, override_batch_count=6)

    first, tech = _task(tmp_path / "b")
    tech.execute(first, CPU, 0, override_batch_count=3)
    # a fresh process's view of the same job: cursor 0, checkpoint on disk
    again, tech = _task(tmp_path / "b")
    assert again.current_batch == 0 and again.has_ckpt()
    tech.execute(again, CPU, 0, override_batch_count=3)
    assert again.current_batch == 3  # cursor restored from the step count
    assert first.last_losses + again.last_losses == whole.last_losses

    a, b = ckpt.load(whole.ckpt_path), ckpt.load(again.ckpt_path)
    assert a["step"] == b["step"] == 6
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k], rtol=0, atol=0)
