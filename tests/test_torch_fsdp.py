"""The port's FSDP against the JAX package's, and against the port's dp.

- A 5-step loss trajectory of the port's fsdp ``execute`` on ``[cpu] * n``
  matches the JAX package's compiled fsdp step over a ``data`` mesh of n
  host devices, for n = 2 and 4, from the same init (the JAX init, written
  by the JAX package's checkpoint and restored by the port's) and the same
  batches: GPT-2 ``test-tiny`` (the logits route, JAX's rule for a block
  of n > 1) and BERT ``mlm_loss``, under the GSPMD config and, for GPT-2,
  the ZeRO-3 ``overlap`` config. Both packages run f32. 1e-4: five
  optimizer steps of f32 sums taken in another order (the bound of
  ``tests/test_torch_train.py``).
- fsdp is bitwise the port's dp on the same block and loss route, in the
  losses and the parameters; the prefetched ZeRO-3 program bitwise the
  serial one, with and without remat.
- The grid is the JAX package's ``candidate_configs``.
- Switching techniques between intervals (fsdp -> dp, dp -> fsdp, after
  ``tests/test_executors.py``'s cross-technique switch) and shrinking an
  fsdp task from 2 positions to 1 restore the checkpoint bitwise.

Every case runs one intra-op torch thread.
"""

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
from saturn_tpu.parallel.fsdp import FSDP as JFSDP
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu_torch import HParams, Strategy, Task
from saturn_tpu_torch.data.lm_dataset import TokenDataset
from saturn_tpu_torch.models import bert as tbert
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP, host_offload_supported
from saturn_tpu_torch.parallel.spmd_base import full_params
from saturn_tpu_torch.utils import checkpoint as ckpt

TRAJ_TOL = 1e-4
STEPS, B, T, VOCAB = 5, 4, 64, 256
CPU = torch.device("cpu")
GSPMD = {"remat": False, "offload": False}
OVERLAP = {"remat": False, "offload": False, "overlap": True}


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, VOCAB - 1, size=4 * STEPS * B * T).astype(np.int32)


def _untagged(fn):
    def loss(logits, tokens):
        return fn(logits, tokens)
    return loss


CASES = {
    # name: (port model, port loss, JAX model, JAX loss)
    "gpt2": (lambda **kw: tgpt2.build_gpt2("test-tiny", **kw), pretraining_loss,
             lambda: j_build_gpt2("test-tiny", dtype=jnp.float32), j_pretraining_loss),
    "bert": (lambda **kw: tbert.build_bert("bert-test-tiny", attention="dense", **kw),
             tbert.mlm_loss,
             lambda: jbert.build_bert("bert-test-tiny", dtype=jnp.float32, attention="dense"),
             jbert.mlm_loss),
}


def _port_task(case, tmp_path, name="t", loss=None):
    model, tloss, _, _ = CASES[case]
    tokens = _tokens()
    return Task(get_model=model, get_dataloader=lambda: TokenDataset(tokens, T, B),
                loss_fn=loss or tloss,
                hparams=HParams(lr=1e-3, batch_count=4 * STEPS, kwargs={"dtype": torch.float32}),
                name=name, save_dir=str(tmp_path))


def _jax_task(case, save_dir):
    _, _, model, loss = CASES[case]
    spec = model()
    tokens = _tokens()
    return JTask(get_model=lambda **kw: spec, get_dataloader=lambda: JTokenDataset(tokens, T, B),
                 loss_fn=loss, hparams=JHParams(lr=1e-3, batch_count=4 * STEPS),
                 save_dir=save_dir)


def _run(tech, task, n, config, steps=STEPS):
    task.strategies[n] = Strategy(tech, n, dict(config), 0.0)
    task.select_strategy(n)
    tech.execute(task, [CPU] * n, 0, override_batch_count=steps)
    task.reconfigure(steps)  # the engine's cursor advance after an interval
    return list(task.last_losses)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case,config", [("gpt2", GSPMD), ("gpt2", OVERLAP), ("bert", GSPMD)],
                         ids=["gpt2", "gpt2-overlap", "bert"])
def test_fsdp_matches_jax_fsdp(case, config, n, tmp_path):
    jtask = _jax_task(case, str(tmp_path / "jax"))
    bundle = JFSDP().build(jtask, jax.devices()[:n], dict(config))
    state = bundle.init()
    init_path = str(tmp_path / "init.npz")
    jckpt.save(init_path, state)
    ds = jtask.get_dataset()
    want = []
    for i in range(STEPS):
        state, loss = bundle.compiled(state, jax.device_put(ds.batch(i), bundle.batch_sharding))
        want.append(float(loss))
    task = _port_task(case, tmp_path / "port")
    tech = FSDP()
    init = ckpt.restore(init_path, tech.build(task, [CPU] * n, config).empty())
    ckpt.save(task.ckpt_path, init)
    del init
    got = _run(tech, task, n, config)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert ckpt.saved_step(task.ckpt_path) == STEPS
    task.release_live_state()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_is_bitwise_dp_on_the_same_route(case, n, tmp_path):
    """The logits route on both (an untagged loss: dp's fused head is not
    fsdp's route): the same sums, held in pieces."""
    _, tloss, _, _ = CASES[case]
    task = _port_task(case, tmp_path, loss=_untagged(tloss))
    bd = DataParallel().build(task, [CPU] * n, {"remat": False})
    bf = FSDP().build(task, [CPU] * n, GSPMD)
    sd, sf = bd.init(), bf.init()
    for i in range(STEPS):
        sd, ld = bd.step(sd, bd.stage(task.batch_at(i)))
        sf, lf = bf.step(sf, bf.stage(task.batch_at(i)))
        assert float(ld) == float(lf), i
    want, got = full_params(sd), full_params(sf)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    # the optimizer's moments of every position are dp's, in pieces
    path_d, path_f = str(tmp_path / "d.pt"), str(tmp_path / "f.pt")
    ckpt.save(path_d, sd)
    ckpt.save(path_f, sf)
    ad, af = ckpt.load_arrays(path_d), ckpt.load_arrays(path_f)
    assert ad.keys() == af.keys()
    for k in ad:
        assert ad[k].tobytes() == af[k].tobytes(), k


@pytest.mark.parametrize("remat", [False, True])
def test_prefetch_is_bitwise_serial(remat, tmp_path):
    task = _port_task("gpt2", tmp_path)
    out = []
    for prefetch in (True, False):
        tech = FSDP()
        tech.prefetch = prefetch
        bundle = tech.build(task, [CPU] * 2, dict(OVERLAP, remat=remat))
        state = bundle.init()
        losses = []
        for i in range(3):
            state, loss = bundle.step(state, bundle.stage(task.batch_at(i)))
            losses.append(float(loss))
        out.append((losses, full_params(state)))
    (la, pa), (lb, pb) = out
    assert la == lb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_the_grid_is_jaxs(case, n, tmp_path):
    want = JFSDP().candidate_configs(_jax_task(case, str(tmp_path / "jax")), n)
    got = FSDP().candidate_configs(_port_task(case, tmp_path), n)
    assert got == want
    assert not host_offload_supported()
    assert not any(c.get("offload") for c in got)


def test_fsdp_is_a_builtin_technique():
    from saturn_tpu_torch.parallel import BUILTIN_TECHNIQUES

    assert BUILTIN_TECHNIQUES["fsdp"] is FSDP and FSDP.name == "fsdp"


# ----------------------------------------------------- across intervals
def _interval_chain(tmp_path, name, plan):
    """``plan``: [(technique, n, config)], two batches each, one task."""
    task = _port_task("gpt2", tmp_path, name=name, loss=_untagged(pretraining_loss))
    losses = []
    for tech, n, config in plan:
        losses += _run(tech, task, n, config, steps=2)
    ckpt.flush()
    return task, losses


@pytest.mark.parametrize("first,second", [("fsdp", "dp"), ("dp", "fsdp")])
def test_a_technique_switch_between_intervals_is_bitwise(first, second, tmp_path):
    techs = {"fsdp": (FSDP, GSPMD), "dp": (DataParallel, {"remat": False})}
    ref, ref_losses = _interval_chain(tmp_path / "ref", "ref",
                                      [(DataParallel(), 2, {"remat": False})] * 2)
    plan = [(techs[first][0](), 2, techs[first][1]), (techs[second][0](), 2, techs[second][1])]
    task, losses = _interval_chain(tmp_path / "switch", "sw", plan)
    assert losses == ref_losses
    assert ckpt.saved_step(task.ckpt_path) == 4
    want, got = ckpt.load_arrays(ref.ckpt_path), ckpt.load_arrays(task.ckpt_path)
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k


def test_an_fsdp_shrink_from_two_positions_to_one_restores_the_manifest(tmp_path):
    ref, ref_losses = _interval_chain(
        tmp_path / "ref", "ref",
        [(DataParallel(), 2, {"remat": False}), (DataParallel(), 1, {"remat": False})])
    tech = FSDP()
    task, losses = _interval_chain(tmp_path / "fsdp", "f",
                                   [(tech, 2, GSPMD), (tech, 1, GSPMD)])
    assert losses == ref_losses
    assert [r["replicas"] for r in tech.intervals] == [2, 1]
    assert tech.intervals[1]["restored"]
    want, got = ckpt.load_arrays(ref.ckpt_path), ckpt.load_arrays(task.ckpt_path)
    for k in want:
        assert want[k].tobytes() == got[k].tobytes(), k


def test_search_with_dp_and_fsdp_then_orchestrate(tmp_path):
    """fsdp is searched as dp is, lane by lane, over a pool of 4 positions
    (anchors, fill), and the plan trains to its budget."""
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.utils import metrics

    task = _port_task("gpt2", tmp_path, loss=_untagged(pretraining_loss))
    task.hparams.batch_count = task.total_batches = 6
    events = str(tmp_path / "events.jsonl")
    topo = SliceTopology([CPU] * 4)
    sat.library.register_default_library()
    sat.search([task], technique_names=["dp", "fsdp"], topology=topo, metrics_path=events,
               fusion=False)
    trials = [e for e in metrics.read_events(events) if e["kind"] == "trial"]
    assert {e["technique"] for e in trials} == {"dp", "fsdp"}
    assert {e["size"] for e in trials if e["technique"] == "fsdp"} == {1, 2, 4}
    out = sat.orchestrate([task], interval=1e9, topology=topo, fusion=False)
    assert out["completed"] == [task.name] and ckpt.saved_step(task.ckpt_path) == 6
    task.release_live_state()


def test_the_static_screen_prices_fsdps_share(tmp_path):
    task = _port_task("gpt2", tmp_path)
    fsdp, dp = FSDP(), DataParallel()
    full = dp.state_bytes(task, GSPMD)
    assert fsdp.state_bytes(task, GSPMD, 1) == full
    params = full // 4  # AdamW: params, grads and two moments
    assert fsdp.state_bytes(task, GSPMD, 4) == 2 * params + full // 4
