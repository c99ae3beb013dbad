"""The port's chaos campaign (``saturn_tpu_torch/resilience/chaos.py``)
against the JAX package's.

- ``campaign_schedule`` draws the JAX package's events for the same seed
  and task names.
- ``compare_checkpoints`` finds one flipped bit in the port's single-file
  checkpoints, and NaN-equal tensors equal.
- A two-task ``test-tiny`` campaign of all four health-fault classes, killed
  at ``post-rollback``: no job lost, the quarantine replayed from the journal
  after the kill, every final checkpoint byte for byte a fault-free run's
  with the quarantine applied beforehand; the same quarantined indices and
  detached set as the JAX campaign on the same tasks, and final losses
  within 1e-4 of it (both from the JAX init, in f32 compute, the JAX side's
  CE head in interpret mode, as in ``tests/test_torch_window.py``).

Tolerances: schedules, quarantines and checkpoint bytes exactly; the last
training losses of each task within 1e-4 (relative and absolute, the
trajectory tolerance of ``tests/test_torch_train.py``) of the JAX
campaign's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.core.mesh import SliceTopology as JSliceTopology
from saturn_tpu.core.strategy import Strategy as JStrategy
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.resilience import chaos as jchaos
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu.utils.metrics import read_events as j_read_events
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.durability import replay_batch_state
from saturn_tpu_torch.models.convert import params_from_jax
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.resilience import chaos
from saturn_tpu_torch.utils import checkpoint as ckpt

SEQ, BATCH, N_BATCHES = 16, 2, 8   # N_BATCHES == epoch length: quarantine compares exactly
NAMES = ("chaos-a", "chaos-b")
TRAJ_TOL = 1e-4  # losses against the JAX package's, as in tests/test_torch_train.py
ORCH = dict(interval=30.0, solver_time_limit=2.0)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    # the campaign injects 1e9 spikes: the EWMA screen (off by default) sees them
    monkeypatch.setenv("SATURN_TPU_SENTINEL_SPIKE", "8")
    monkeypatch.setenv("SATURN_TPU_SENTINEL_WARMUP", "2")
    for name in ("SATURN_TPU_FAULTS", "SATURN_TPU_SENTINEL", "SATURN_TPU_SOLVE_DEADLINE",
                 "SATURN_TPU_WATCHDOG", "SATURN_TPU_MAX_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("seed", [1, 3, 7, 11, 23, 47])
@pytest.mark.parametrize("spec_kw", [{}, {"poison_range": 6, "poison_batches": 2,
                                          "stall_s": 0.7, "max_intervals_hit": 3}])
def test_campaign_schedule_matches_jax(seed, spec_kw):
    names = ["job-a", "job-b", "job-c"]
    got = chaos.campaign_schedule(names, chaos.CampaignSpec(seed=seed, **spec_kw))
    want = jchaos.campaign_schedule(names, jchaos.CampaignSpec(seed=seed, **spec_kw))
    strip = [{k: v for k, v in dataclasses.asdict(e).items() if k != "value"} for e in got]
    assert strip == [{k: v for k, v in dataclasses.asdict(e).items() if k != "value"}
                     for e in want]
    assert [e.kind for e in got] == list(chaos.HEALTH_FAULT_CLASSES)


def test_campaign_schedule_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="not a health-fault class"):
        chaos.campaign_schedule(["a"], chaos.CampaignSpec(seed=1, fault_classes=("device_loss",)))
    with pytest.raises(ValueError, match="at least one task"):
        chaos.campaign_schedule([], chaos.CampaignSpec(seed=1))


# --------------------------------------------------------- compare primitive
def _save(d, stem, **params):
    os.makedirs(d, exist_ok=True)
    ckpt.save(os.path.join(d, f"{stem}.pt"),
              {"params": torch.nn.ParameterDict({k: torch.nn.Parameter(v)
                                                 for k, v in params.items()}),
               "opt_state": torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1),
               "step": 3})


def test_compare_checkpoints_bits(tmp_path):
    a, b, c = (str(tmp_path / x) for x in "abc")
    w = torch.tensor([1.0, float("nan"), 3.0])
    _save(a, "job", w=w)
    _save(b, "job", w=w.clone())
    assert chaos.compare_checkpoints(a, b) == []
    w2 = w.clone()
    w2.view(torch.int32)[2] ^= 1  # one mantissa bit
    _save(c, "job", w=w2)
    assert chaos.compare_checkpoints(a, c) == ["job[params/w]: bytes differ"]
    _save(a, "gone", w=w)
    assert chaos.compare_checkpoints(a, b) == [f"gone: missing from {b}"]
    assert chaos.compare_checkpoints(a, b, names=["job"]) == []


# --------------------------------------------------------------- campaign
_JAX_INIT = {}


def _jax_init_state_dict():
    """The JAX package's seed-0 init of test-tiny, as the port's state dict."""
    if "sd" not in _JAX_INIT:
        import jax

        params = j_build_gpt2("test-tiny", seq_len=SEQ).init_fn(jax.random.PRNGKey(0))
        _JAX_INIT["sd"] = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return _JAX_INIT["sd"]


def _spec(**kw):
    """test-tiny whose init is the JAX package's seed-0 draw."""
    spec = build_gpt2("test-tiny", seq_len=SEQ, **kw)
    sd = _jax_init_state_dict()

    def init_fn(generator=None, device=None):
        model = spec.meta_init_fn().to_empty(device=device or "cpu")
        model.load_state_dict(sd)
        return model

    return dataclasses.replace(spec, init_fn=init_fn)


def _loader():
    return make_lm_dataset(context_length=SEQ, batch_size=BATCH, vocab_size=256,
                           n_tokens=SEQ * BATCH * N_BATCHES)


def _tasks(save_dir, quarantine=None):
    tech = DataParallel()
    out = []
    for name in NAMES:
        t = sat.Task(get_model=_spec, get_dataloader=_loader, loss_fn=pretraining_loss,
                     hparams=sat.HParams(lr=1e-3, batch_count=N_BATCHES,
                                         kwargs={"dtype": torch.float32}), name=name,
                     save_dir=str(save_dir))
        t.strategies = {1: sat.Strategy(tech, 1, {"remat": False}, 1.0 * N_BATCHES, 1.0)}
        if quarantine:
            t.quarantine_batches(quarantine.get(name, []))
        out.append(t)
    return out


def _jtasks(save_dir, quarantine=None):
    import jax.numpy as jnp

    tech = JDataParallel()
    out = []
    for name in NAMES:
        t = JTask(get_model=lambda **kw: j_build_gpt2("test-tiny", seq_len=SEQ,
                                                      dtype=jnp.float32, **kw),
                  get_dataloader=lambda: j_make_lm_dataset(
                      context_length=SEQ, batch_size=BATCH, vocab_size=256,
                      n_tokens=SEQ * BATCH * N_BATCHES),
                  loss_fn=j_pretraining_loss, hparams=JHParams(lr=1e-3, batch_count=N_BATCHES),
                  name=name, save_dir=str(save_dir))
        t.strategies = {1: JStrategy(tech, 1, {}, 1.0 * N_BATCHES, 1.0)}
        if quarantine:
            t.quarantine_batches(quarantine.get(name, []))
        out.append(t)
    return out


def _released(tasks):
    for t in tasks:
        t.release_live_state()
        t.release_compiled()


def test_campaign_kill_replay_matches_jax(tmp_path, monkeypatch):
    import functools

    import jax

    from saturn_tpu.ops import ce as jce

    # the JAX side's CE head in interpret mode: both packages through the
    # fused head and its bf16 logits stash (``tests/test_torch_window.py``)
    monkeypatch.setattr(jce, "fused_linear_cross_entropy",
                        functools.partial(jce.fused_linear_cross_entropy, interpret=True))

    spec = chaos.CampaignSpec(seed=11, kill_during_rollback=True, poison_range=N_BATCHES,
                              stall_s=0.25)
    save, wal = tmp_path / "camp" / "ckpts", str(tmp_path / "camp" / "wal")
    made = []
    result = chaos.run_campaign(lambda: made.extend(_tasks(save)) or made[-len(NAMES):], spec,
                                wal, on_kill=_released,
                                topology=SliceTopology([torch.device("cpu")]), **ORCH)
    assert sorted(result.completed) == sorted(NAMES) and result.failed == {}
    assert result.kills == 1 and result.restarts == 1
    # what the harness reports is what a fresh incarnation replays
    assert result.quarantined == replay_batch_state(wal).quarantined
    # bit for bit: a fault-free run over the same surviving batches
    ref = _tasks(tmp_path / "ref", quarantine=result.quarantined)
    out = sat.orchestrate(ref, topology=SliceTopology([torch.device("cpu")]), **ORCH)
    assert sorted(out["completed"]) == sorted(NAMES)
    assert chaos.compare_checkpoints(str(save), str(tmp_path / "ref"), names=list(NAMES)) == []
    for name in NAMES:
        assert ckpt.load(os.path.join(save, f"{name}.pt"))["step"] == N_BATCHES

    # the JAX campaign on the same tasks
    jsave, jwal = tmp_path / "jcamp" / "ckpts", str(tmp_path / "jcamp" / "wal")
    jspec = jchaos.CampaignSpec(seed=11, kill_during_rollback=True, poison_range=N_BATCHES,
                                stall_s=0.25)
    jmetrics = str(tmp_path / "jcamp" / "m.jsonl")
    jresult = jchaos.run_campaign(lambda: _jtasks(jsave), jspec, jwal,
                                  topology=JSliceTopology(jax.devices()[:1]),
                                  metrics_path=jmetrics, **ORCH)
    jckpt.flush()
    assert sorted(jresult.completed) == sorted(result.completed)
    assert jresult.kills == result.kills
    assert result.quarantined == jresult.quarantined
    assert sorted(result.detached) == sorted(jresult.detached)
    # the last training losses of each package's campaign: the port's last
    # incarnation's tasks, the JAX package's last task_interval events
    jlast = {e["task"]: e["loss"] for e in j_read_events(jmetrics, kind="task_interval")}
    got = [made[-len(NAMES):][i].last_losses[-1] for i in range(len(NAMES))]
    want = [jlast[name] for name in NAMES]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
