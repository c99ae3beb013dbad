"""The port's persistent profile cache and the trial runner that consults it,
against the JAX package's file format and key.

- An entry round-trips; a corrupt, foreign or half-written file is a miss.
- Both packages read each other's files (one JSON file per key).
- A second search over the same tasks runs no trial; tasks that differ only
  in lr share one entry.
- The loss function is part of the port's key: a tagged loss (fused head)
  and an untagged one (logits path) give two entries where the JAX key
  gives one.
"""

import json
import os

import pytest
import torch

import saturn_tpu_torch as sat
from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import make_lm_dataset as j_make_lm_dataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.utils import profile_cache as jpcache
from saturn_tpu_torch.core.mesh import SliceTopology
from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.utils import metrics
from saturn_tpu_torch.utils import profile_cache as pcache

CPU_TOPO = SliceTopology([torch.device("cpu")])


@pytest.fixture(autouse=True)
def _own_profile_cache(tmp_path, monkeypatch):
    """Every search here reads and writes a profile cache of its own test."""
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE_DIR", str(tmp_path / "profile_cache"))
    monkeypatch.delenv("SATURN_TPU_PROFILE_CACHE", raising=False)
    sat.library.register_default_library()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    many, and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def logits_loss(logits, tokens):
    """``pretraining_loss`` without its fused-head tag: the logits path."""
    return pretraining_loss(logits, tokens)


def j_logits_loss(logits, tokens):
    return j_pretraining_loss(logits, tokens)


def _task(tmp_path, name, lr=1e-3, loss=pretraining_loss, batch_count=4):
    return sat.Task(
        get_model=lambda **kw: build_gpt2("test-tiny", **kw),
        get_dataloader=lambda: make_lm_dataset(
            context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
        loss_fn=loss, hparams=sat.HParams(lr=lr, batch_count=batch_count),
        name=name, save_dir=str(tmp_path / "ckpts"),
    )


def _jtask(tmp_path, name, loss):
    return JTask(
        get_model=lambda **kw: j_build_gpt2("test-tiny", **kw),
        get_dataloader=lambda: j_make_lm_dataset(
            context_length=64, batch_size=4, vocab_size=256, n_tokens=64 * 4 * 8),
        loss_fn=loss, hparams=JHParams(lr=1e-3, batch_count=4),
        name=name, save_dir=str(tmp_path / "jckpts"),
    )


# ------------------------------------------------------------------ the store
def test_round_trip_and_realized_upgrade(tmp_path):
    cache = pcache.ProfileCache(str(tmp_path / "c"))
    assert cache.put("k1", technique="dp", size=1, feasible=True,
                     params={"remat": False}, per_batch_time=0.25)
    e = cache.get("k1")
    assert e["params"] == {"remat": False} and e["per_batch_time"] == 0.25
    assert e["source"] == "trial" and len(cache) == 1
    assert cache.note_realized("k1", 0.2, None, technique="dp", size=1)
    e = cache.get("k1")
    assert e["source"] == "realized" and e["per_batch_time"] == 0.2
    assert e["params"] == {"remat": False}
    assert cache.put("k2", technique="dp", size=1, feasible=False, memory_infeasible=True)
    assert cache.get("k2")["feasible"] is False
    assert not [f for f in os.listdir(cache.root) if ".tmp." in f]


@pytest.mark.parametrize("content", [
    "{not json", "", "[]", json.dumps({"key": "other", "feasible": True}),
    json.dumps({"key": "k", "feasible": "yes"}),
    json.dumps({"key": "k", "feasible": True, "per_batch_time": -1.0, "params": {}}),
    json.dumps({"key": "k", "feasible": True, "per_batch_time": 0.1, "params": None}),
])
def test_a_corrupt_file_is_a_miss(tmp_path, content):
    cache = pcache.ProfileCache(str(tmp_path / "c"))
    with open(os.path.join(cache.root, "k.json"), "w") as f:
        f.write(content)
    assert cache.get("k") is None
    assert jpcache.ProfileCache(cache.root).get("k") is None  # the JAX rule


def test_both_packages_read_each_others_files(tmp_path):
    root = str(tmp_path / "c")
    pcache.ProfileCache(root).put("port", technique="dp", size=1, feasible=True,
                                  params={"attention": "flash"}, per_batch_time=0.02)
    jpcache.ProfileCache(root).put("jax", technique="dp", size=1, feasible=True,
                                   params={"remat": True}, per_batch_time=0.03)
    assert jpcache.ProfileCache(root).get("port")["params"] == {"attention": "flash"}
    assert pcache.ProfileCache(root).get("jax")["per_batch_time"] == 0.03


def test_resolve_and_environment(tmp_path, monkeypatch):
    assert pcache.resolve(False) is None
    assert pcache.resolve(str(tmp_path / "x")).root == str(tmp_path / "x")
    own = pcache.ProfileCache(str(tmp_path / "y"))
    assert pcache.resolve(own) is own
    assert pcache.resolve(None).root == str(tmp_path / "profile_cache")
    monkeypatch.setenv("SATURN_TPU_PROFILE_CACHE", "0")
    assert pcache.resolve(None) is None
    with pytest.raises(TypeError):
        pcache.resolve(3)
    monkeypatch.delenv("SATURN_TPU_PROFILE_CACHE_DIR")
    assert pcache.default_dir().endswith(os.path.join(".cache", "saturn_tpu_torch", "profiles"))
    assert pcache.default_dir() != jpcache.default_dir()


# -------------------------------------------------------------------- the key
def test_key_leaves_out_lr_and_name(tmp_path):
    a, b = _task(tmp_path, "a", lr=1e-3), _task(tmp_path, "b", lr=3e-2, batch_count=9)
    assert pcache.task_signature(a) == pcache.task_signature(b)


def test_key_follows_the_window_and_the_kernel_sources(tmp_path, monkeypatch):
    sig = pcache.task_signature(_task(tmp_path, "a"))
    topo = pcache.topology_signature(CPU_TOPO)
    assert topo == "cpux1:cap1"
    base = pcache.fingerprint(sig, "dp", 1, topo)
    monkeypatch.setenv("SATURN_TPU_MAX_WINDOW", "4")
    assert pcache.fingerprint(sig, "dp", 1, topo) != base
    monkeypatch.delenv("SATURN_TPU_MAX_WINDOW")
    monkeypatch.setattr(pcache, "kernel_sources_digest", lambda: "redesigned")
    assert pcache.fingerprint(sig, "dp", 1, topo) != base


def test_loss_function_is_in_the_port_key_and_not_in_the_jax_key(tmp_path):
    """A tagged and an untagged loss run two programs (fused head, logits):
    two entries in the port's cache, one under the JAX key."""
    ports = [_task(tmp_path, "fused"), _task(tmp_path, "logits", loss=logits_loss)]
    jaxs = [_jtask(tmp_path, "fused", j_pretraining_loss),
            _jtask(tmp_path, "logits", j_logits_loss)]
    jcache = jpcache.ProfileCache(str(tmp_path / "jax_entries"))
    for t in jaxs:
        key = jpcache.fingerprint(jpcache.task_signature(t), "dp", 1, "cpu")
        jcache.put(key, technique="dp", size=1, feasible=True, params={},
                   per_batch_time=0.1)
    assert len(jcache) == 1

    stats = sat.search(ports, technique_names=["dp"], topology=CPU_TOPO,
                       profile_cache=str(tmp_path / "port_entries"))
    assert stats == {"trials_run": 2, "cache_hits": 0, "pruned": 0}
    assert len(pcache.ProfileCache(str(tmp_path / "port_entries"))) == 2


# ------------------------------------------------------------- the sweep
def test_second_search_runs_no_trial(tmp_path):
    """Three lr points and one untagged loss: two trials (one per
    signature), two hits; a repeat search is all hits, with the same
    strategies; every lookup is a ``profile_cache`` event."""
    events = str(tmp_path / "events.jsonl")
    tasks = [_task(tmp_path, f"lr{i}", lr=lr) for i, lr in enumerate((1e-3, 3e-3, 1e-2))]
    tasks.append(_task(tmp_path, "untagged", loss=logits_loss))
    first = sat.search(tasks, technique_names=["dp"], topology=CPU_TOPO,
                       metrics_path=events)
    assert first == {"trials_run": 2, "cache_hits": 2, "pruned": 0}
    strategies = {t.name: (t.strategies[1].params, t.strategies[1].per_batch_time)
                  for t in tasks}
    assert strategies["lr0"] == strategies["lr1"] == strategies["lr2"]
    for t in tasks:
        t.strategies.clear()
    again = sat.search(tasks, technique_names=["dp"], topology=CPU_TOPO)
    assert again == {"trials_run": 0, "cache_hits": 4, "pruned": 0}
    assert strategies == {t.name: (t.strategies[1].params, t.strategies[1].per_batch_time)
                          for t in tasks}
    hits = [e["hit"] for e in metrics.read_events(events, kind="profile_cache")]
    assert hits == [False, True, True, False]
    assert len(metrics.read_events(events, kind="trial")) == 2


def test_profile_cache_false_profiles_every_task(tmp_path):
    tasks = [_task(tmp_path, "a"), _task(tmp_path, "b", lr=5e-3)]
    stats = sat.search(tasks, technique_names=["dp"], topology=CPU_TOPO,
                       profile_cache=False)
    assert stats == {"trials_run": 2, "cache_hits": 0, "pruned": 0}
    assert tasks[0].strategies[1].cache_key is None
