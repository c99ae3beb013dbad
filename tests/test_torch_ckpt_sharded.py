"""The port's checkpoints are the JAX package's sharded manifests.

Mirrors ``tests/test_ckpt_sharded.py`` on the port's train states (GPT-2
``test-tiny``, f32, AdamW, on ``[cpu] * n`` blocks under dp and fsdp): the
manifest and its shard files, a chain of restores across techniques and
block sizes bitwise, the GC of old generations, a tampered manifest and a
missing shard file quarantined, the single-file readers (the JAX package's
``.npz`` and the port's ``torch.save`` file from before the manifest),
keep-first async error retention, and the two crash barriers of a save
(``mid-shard-write``, ``pre-manifest-rename``) with a torn shard set
reconciled to the previous publication. The ``analysis ckpt`` CLI cases go
with item 8c; the MFU telemetry case with its ``mfu`` view.

Across the packages: a JAX dp train state saved after 2 steps resumes in
the port for 3 more, within 1e-4 of JAX's 3 more (f32; the bound of
``tests/test_torch_train.py``); a port save passes JAX's ``verify`` and reads
through JAX's ``load_arrays`` bitwise against ``params_to_jax`` of the
port's state; and a JAX FSDP save over 4 devices and the port's FSDP save
over 4 positions give equal ``leaves`` tables and ``pspec_fingerprint``.
"""

import glob
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saturn_tpu import HParams as JHParams, Task as JTask
from saturn_tpu.data.lm_dataset import TokenDataset as JTokenDataset
from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.models.loss import pretraining_loss as j_pretraining_loss
from saturn_tpu.parallel.dp import DataParallel as JDataParallel
from saturn_tpu.parallel.fsdp import FSDP as JFSDP
from saturn_tpu.utils import checkpoint as jckpt
from saturn_tpu_torch import HParams, Task
from saturn_tpu_torch.data.lm_dataset import TokenDataset
from saturn_tpu_torch.models import gpt2 as tgpt2
from saturn_tpu_torch.models.convert import params_to_jax
from saturn_tpu_torch.models.loss import pretraining_loss
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP
from saturn_tpu_torch.parallel.spmd_base import full_params
from saturn_tpu_torch.utils import checkpoint as ckpt

TRAJ_TOL = 1e-4
B, T, VOCAB = 8, 64, 256
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread_no_barrier():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ckpt.set_crash_barrier(None)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, VOCAB - 1, size=20 * B * T).astype(np.int32)


def _untagged(fn):
    def loss(logits, tokens):
        return fn(logits, tokens)
    return loss


def _task(tmp_path, name="t", loss=pretraining_loss):
    tokens = _tokens()
    return Task(get_model=lambda **kw: tgpt2.build_gpt2("test-tiny", **kw),
                get_dataloader=lambda: TokenDataset(tokens, T, B), loss_fn=loss,
                hparams=HParams(lr=1e-3, batch_count=20, kwargs={"dtype": torch.float32}),
                name=name, save_dir=str(tmp_path))


def _trained(task, tech, n, steps=2, config=None):
    bundle = tech.build(task, [CPU] * n, dict(config or {"remat": False}))
    state = bundle.init()
    for i in range(steps):
        state, _ = bundle.step(state, bundle.stage(task.batch_at(i)))
    return bundle, state


def _shard_files(d):
    return sorted(n for n in os.listdir(d) if ckpt._SHARD_RE.search(n))


def _assert_same(a, b):
    """Two states' parameters, moments and steps, bit for bit."""
    pa, pb = full_params(a), full_params(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert a["step"] == b["step"]


# ------------------------------------------------------------ the format
def test_manifest_and_shard_layout(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 4)
    path = task.ckpt_path
    ckpt.save(path, state)
    with open(path, "rb") as f:
        assert f.read(1) == b"{"
    with open(path) as f:
        man = json.load(f)
    assert man["format"] == ckpt.MANIFEST_FORMAT == "saturn-ckpt-manifest"
    assert man["version"] == ckpt.MANIFEST_VERSION == 1
    assert man["pspec_fingerprint"]
    assert {"params/wte", "params/blocks/qkv/kernel", "opt_state/0/count",
            "opt_state/0/mu/wte", "opt_state/0/nu/blocks/mlp_out/kernel",
            "step"} <= set(man["leaves"])
    w = man["leaves"]["params/blocks/qkv/kernel"]
    assert w["shape"] == [2, 64, 192] and w["dtype"] == "float32"
    assert len(w["shards"]) == 4
    cols = sum(s["index"][2][1] - s["index"][2][0] for s in w["shards"])
    assert cols == 192
    files = _shard_files(tmp_path)
    assert files and all(n.startswith("t.pt.g") and n.endswith(".r0.npz") for n in files)
    assert all(zipfile.is_zipfile(tmp_path / n) for n in files)
    assert ckpt.verify(path)


def test_cross_technique_chain_bit_identical(tmp_path):
    """dp over 4 -> fsdp over 8 -> fsdp's ZeRO-3 rules over 2 -> one
    device: the state survives every restore and save bit for bit."""
    task = _task(tmp_path, loss=_untagged(pretraining_loss))
    path = task.ckpt_path
    _, want = _trained(task, DataParallel(), 4)
    ckpt.save(path, want)
    chain = [(FSDP(), 8, {"remat": False}), (FSDP(), 2, {"remat": False, "overlap": True}),
             (DataParallel(), 1, {"remat": False})]
    for tech, n, config in chain:
        got = ckpt.restore_sharded(path, tech.build(task, [CPU] * n, config).empty())
        _assert_same(want, got)
        ckpt.save(path, got)
    saved = ckpt.load(path)
    for i, per in want["opt_state"].state_dict()["state"].items():
        for k, v in per.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(saved["opt_state"]["state"][i][k]))


def test_resave_garbage_collects_old_generation(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    ckpt.save(task.ckpt_path, state)
    gen1 = set(_shard_files(tmp_path))
    ckpt.save(task.ckpt_path, state)
    gen2 = set(_shard_files(tmp_path))
    assert gen1 and gen1.isdisjoint(gen2)
    assert ckpt.verify(task.ckpt_path)


def test_tampered_manifest_quarantined(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    path = task.ckpt_path
    ckpt.save(path, state)
    with open(path) as f:
        man = json.load(f)
    man["leaves"]["step"]["shape"] = [3]  # the checksum is stale now
    with open(path, "w") as f:
        json.dump(man, f)
    assert not ckpt.verify(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_arrays(path)
    assert os.path.exists(path + ".corrupt")


def test_missing_shard_file_quarantined(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    path = task.ckpt_path
    ckpt.save(path, state)
    os.unlink(tmp_path / _shard_files(tmp_path)[0])
    assert not ckpt.verify(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(path, FSDP().build(task, [CPU] * 2, {"remat": False}).empty())
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_truncated_shard_file_fails_verify_and_its_restore_quarantines(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, DataParallel(), 1, steps=1)
    path = task.ckpt_path
    ckpt.save(path, state)
    shard = tmp_path / _shard_files(tmp_path)[0]
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    assert not ckpt.verify(path)
    with pytest.raises(ckpt.CheckpointCorruptError) as err:
        ckpt.restore(path, FSDP().build(task, [CPU] * 2, {"remat": False}).empty())
    assert err.value.quarantined == path + ".corrupt"


# -------------------------------------------------------- single files
def test_legacy_single_file_restores(tmp_path):
    """The JAX package's single-file ``.npz`` (full arrays by tree path)
    keeps restoring, into a replicated and into a sharded state."""
    task = _task(tmp_path)
    _, want = _trained(task, DataParallel(), 1)
    ckpt.save(task.ckpt_path, want)
    arrays = ckpt.load_arrays(task.ckpt_path)
    old = str(tmp_path / "old.npz")
    with open(old, "wb") as f:
        np.savez(f, **arrays)
    assert ckpt.load_arrays(old)["params/wte"].tobytes() == arrays["params/wte"].tobytes()
    for tech, n in ((DataParallel(), 1), (FSDP(), 4)):
        got = ckpt.restore_sharded(old, tech.build(task, [CPU] * n, {"remat": False}).empty())
        _assert_same(want, got)


def test_the_ports_torch_save_file_still_restores(tmp_path):
    """A checkpoint the port wrote before the manifest (``torch.save`` of
    the state dicts) restores under dp and fsdp, and training goes on there
    as it goes on from the state that wrote it (fsdp over 2 as dp over 2
    does, bitwise)."""
    task = _task(tmp_path, loss=_untagged(pretraining_loss))
    bundle, live = _trained(task, DataParallel(), 1)
    old = str(tmp_path / "old.pt")
    torch.save({"params": live["params"].state_dict(),
                "opt_state": live["opt_state"].state_dict(), "step": live["step"]}, old)
    assert ckpt.verify(old) and ckpt.saved_step(old) == 2
    assert ckpt.summarize(old)["format"] == "legacy-torch"
    live, _ = bundle.step(live, bundle.stage(task.batch_at(2)))
    wants = {1: live}
    b2 = DataParallel().build(task, [CPU] * 2, {"remat": False})
    wants[2], _ = b2.step(ckpt.restore(old, b2.empty()), b2.stage(task.batch_at(2)))
    for tech, n in ((DataParallel(), 1), (FSDP(), 2)):
        b = tech.build(task, [CPU] * n, {"remat": False})
        got = ckpt.restore(old, b.empty())
        assert got["step"] == 2
        got, _ = b.step(got, b.stage(task.batch_at(2)))
        _assert_same(wants[n], got)


@pytest.mark.parametrize("optimizer", [torch.optim.AdamW, torch.optim.SGD])
def test_a_users_module_keys_by_its_names(tmp_path, optimizer):
    """A model with no JAX counterpart keys by ``params/<name>`` and
    ``opt_state/<name>/<state key>``; its state restores into a fresh one
    bitwise, the optimizer's state included."""
    def state(seed):
        g = torch.Generator().manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
        opt = optimizer(model.parameters(), lr=1e-3, momentum=0.9) \
            if optimizer is torch.optim.SGD else optimizer(model.parameters(), lr=1e-3)
        model(torch.randn(2, 8, generator=g)).sum().backward()
        opt.step()
        return {"params": model, "opt_state": opt, "step": 3 + seed}

    path = str(tmp_path / "u.pt")
    want = state(0)
    ckpt.save(path, want)
    keys = set(ckpt._read_manifest(path)["leaves"])
    assert {"params/0.weight", "params/1.bias", "step"} <= keys
    per = "exp_avg" if optimizer is torch.optim.AdamW else "momentum_buffer"
    assert f"opt_state/0.weight/{per}" in keys
    got = ckpt.restore(path, state(1))
    assert got["step"] == 3
    for (name, a), b in zip(want["params"].named_parameters(), got["params"].parameters()):
        assert torch.equal(a, b), name
        sa, sb = want["opt_state"].state[a], got["opt_state"].state[b]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), (name, k)


def test_step_counts_that_disagree_are_refused(tmp_path):
    """The JAX layout keeps one optimizer count: a state whose parameters
    stepped a different number of times does not write."""
    task = _task(tmp_path)
    _, state = _trained(task, DataParallel(), 1, steps=1)
    p = next(iter(state["params"].parameters()))
    state["opt_state"].state[p]["step"] += 1
    with pytest.raises(ValueError, match="different step counts"):
        ckpt.save(task.ckpt_path, state)
    assert not os.path.exists(task.ckpt_path)


# ---------------------------------------------------------- async writes
def test_keep_first_error_per_path(tmp_path, caplog):
    key = os.path.abspath(str(tmp_path / "x.pt"))
    first, second = RuntimeError("disk full"), RuntimeError("later noise")
    ckpt._record_async_failure(key, key, first)
    with caplog.at_level("WARNING", logger="saturn_tpu_torch"):
        ckpt._record_async_failure(key, key, second)
    assert any("keeping the first error" in r.getMessage() for r in caplog.records)
    with pytest.raises(RuntimeError) as err:
        ckpt.flush()
    assert err.value.__cause__ is first


def test_failed_async_write_surfaces_at_flush(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    (tmp_path / "nodir").write_bytes(b"")
    ckpt.save_async(str(tmp_path / "nodir" / "t.pt"), state)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ckpt.flush()
    ckpt.flush()  # consumed: the next flush is clean


# ---------------------------------------------------------- crash points
def _two_generations(tmp_path, point):
    from saturn_tpu_torch.resilience.crash import CrashInjector, SimulatedKill

    task = _task(tmp_path)
    bundle, state = _trained(task, FSDP(), 2, steps=1)
    path = task.ckpt_path
    ckpt.save(path, state)
    before = ckpt.load_arrays(path)
    state, _ = bundle.step(state, bundle.stage(task.batch_at(1)))
    ckpt.set_crash_barrier(CrashInjector(point).barrier)
    with pytest.raises(SimulatedKill):
        ckpt.save(path, state)
    ckpt.set_crash_barrier(None)
    assert ckpt.verify(path)
    after = ckpt.load_arrays(path)
    assert before.keys() == after.keys()
    assert all(before[k].tobytes() == after[k].tobytes() for k in before)
    assert int(after["step"]) == 1
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_mid_shard_write_keeps_previous_generation(tmp_path):
    _two_generations(tmp_path, "mid-shard-write")


def test_pre_manifest_rename_keeps_previous_manifest(tmp_path):
    _two_generations(tmp_path, "pre-manifest-rename")


def test_torn_shard_set_reconciles_to_previous_publication(tmp_path):
    from saturn_tpu_torch.durability.recovery import reconcile_checkpoints

    task = _task(tmp_path)
    bundle, state = _trained(task, FSDP(), 2, steps=1)
    old, new = str(tmp_path / "a" / "t.pt"), str(tmp_path / "b" / "t.pt")
    ckpt.save(old, state)
    state, _ = bundle.step(state, bundle.stage(task.batch_at(1)))
    ckpt.save(new, state)
    for n in _shard_files(tmp_path / "b"):
        os.unlink(tmp_path / "b" / n)
    assert reconcile_checkpoints({"job": [old, new]}) == {"job": old}
    assert os.path.exists(new + ".corrupt")


def test_publish_hook_fires_at_the_manifest_rename(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    seen = []

    def hook(stem, path):
        seen.append((stem, path, ckpt._is_manifest_file(path)))

    ckpt.add_publish_hook(hook)
    try:
        ckpt.save_async(task.ckpt_path, state)
        ckpt.flush()
    finally:
        ckpt.remove_publish_hook(hook)
    assert seen == [("t", os.path.abspath(task.ckpt_path), True)]


def test_summaries_of_a_directory(tmp_path):
    task = _task(tmp_path)
    _, state = _trained(task, FSDP(), 2, steps=1)
    ckpt.save(task.ckpt_path, state)
    summ = ckpt.summarize(task.ckpt_path)
    assert summ["ok"] and summ["format"] == "sharded-manifest" and summ["shard_files"] == 1
    (tmp_path / "t.pt.gdeadbeef.r9.npz").write_bytes(b"PK\x03\x04")
    inv = ckpt.summarize_dir(str(tmp_path))
    assert [c["path"] for c in inv["checkpoints"]] == [task.ckpt_path]
    assert inv["orphan_shards"] == ["t.pt.gdeadbeef.r9.npz"]
    ckpt.delete(task.ckpt_path)  # every generation's shard files of the path
    assert not os.path.exists(task.ckpt_path) and _shard_files(tmp_path) == []


# -------------------------------------------------------- across packages
def _jax_task(save_dir, dtype=jnp.float32):
    tokens = _tokens()
    spec = j_build_gpt2("test-tiny", dtype=dtype)
    return JTask(get_model=lambda **kw: spec,
                 get_dataloader=lambda: JTokenDataset(tokens, T, B),
                 loss_fn=j_pretraining_loss, hparams=JHParams(lr=1e-3, batch_count=20),
                 save_dir=save_dir)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    jtask = _jax_task(str(tmp_path / "jax"))
    bundle = JDataParallel().build(jtask, jax.devices()[:1], {})
    state = bundle.init()
    ds = jtask.get_dataset()
    for i in range(2):
        state, _ = bundle.compiled(state, jax.device_put(ds.batch(i), bundle.batch_sharding))
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, state)
    want = []
    for i in range(2, 5):
        state, loss = bundle.compiled(state, jax.device_put(ds.batch(i), bundle.batch_sharding))
        want.append(float(loss))
    task = _task(tmp_path / "port")
    b = DataParallel().build(task, [CPU], {"remat": False})
    got_state = ckpt.restore(path, b.empty())
    assert got_state["step"] == 2
    got = []
    for i in range(2, 5):
        got_state, loss = b.step(got_state, b.stage(task.batch_at(i)))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("tech,n", [(DataParallel, 1), (FSDP, 4)])
def test_a_port_checkpoint_reads_in_jax(tmp_path, tech, n):
    task = _task(tmp_path)
    _, state = _trained(task, tech(), n)
    ckpt.save(task.ckpt_path, state)
    assert jckpt.verify(task.ckpt_path)
    arrays = jckpt.load_arrays(task.ckpt_path)

    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    want = flat(params_to_jax(full_params(state)), "params/")
    for k, v in want.items():
        assert arrays[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    assert int(arrays["step"]) == 2 and int(arrays["opt_state/0/count"]) == 2


def _table(manifest):
    return {k: (e["shape"], e["dtype"], e["stored_dtype"],
                sorted(sh["index"] for sh in e["shards"]))
            for k, e in manifest["leaves"].items()}


def test_fsdp_manifests_of_both_packages_match(tmp_path):
    jtask = _jax_task(str(tmp_path / "jax"))
    jstate = JFSDP().build(jtask, jax.devices()[:4], {"remat": False, "offload": False}).init()
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jstate)
    task = _task(tmp_path / "port")
    state = FSDP().build(task, [CPU] * 4, {"remat": False, "offload": False}).init()
    ckpt.save(task.ckpt_path, state)
    jm, pm = jckpt._read_manifest(jpath), ckpt._read_manifest(task.ckpt_path)
    assert _table(pm) == _table(jm)
    assert pm["pspec_fingerprint"] == jm["pspec_fingerprint"]
    # and the port restores the JAX package's fsdp checkpoint onto its own
    got = ckpt.restore(jpath, FSDP().build(task, [CPU] * 4, {"remat": False}).empty())
    want = jckpt.load_arrays(jpath)
    assert got["step"] == 0
    wte = full_params(got)["wte"].numpy()
    assert wte.tobytes() == want["params/wte"].tobytes()


def test_shard_files_hold_each_block_once(tmp_path):
    """Replicas dedupe to the lowest position: a dp state over 4 writes one
    shard per leaf; fsdp over 4 writes 4 of a split leaf."""
    task = _task(tmp_path)
    _, state = _trained(task, DataParallel(), 4, steps=1)
    ckpt.save(task.ckpt_path, state)
    man = ckpt._read_manifest(task.ckpt_path)
    assert all(len(e["shards"]) == 1 for e in man["leaves"].values())
    files = glob.glob(glob.escape(task.ckpt_path) + ".g*.npz")
    with zipfile.ZipFile(files[0]) as zf:
        assert len(zf.namelist()) == len(man["leaves"])
