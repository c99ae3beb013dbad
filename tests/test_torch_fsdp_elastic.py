"""The elastic run with the port's fsdp: a shrink and a migration restore
the sharded checkpoint through the manifest (cross-mesh migration).

The cases of ``tests/test_torch_multidevice_elastic.py`` with fsdp in dp's
place, against the same JAX package's elastic run of its checkpointing
fake on the same seeded schedule: a loss with no return shrinks a 4-device
pool to 2 and the task's 4-position sharded state restores onto a block of
2; a 2-device pool loses position 1 and the synthesized size 1 restores it
onto one position. Compared exactly as there: completed and failed tasks,
final steps, retries, preempted tasks and the ``topology_change``,
``recovery``, ``migration`` and ``replan`` events. The fsdp run holds its
state in shards on every block of several positions and ends with a
checkpoint at the full budget that a one-device dp state restores.
"""

import threading

import pytest
import torch

import test_torch_multidevice_elastic as mde
from saturn_tpu_torch.parallel.dp import DataParallel
from saturn_tpu_torch.parallel.fsdp import FSDP
from saturn_tpu_torch.parallel.spmd_base import replicas
from saturn_tpu_torch.utils import checkpoint as ckpt
from test_torch_multidevice_elastic import _env, losses  # noqa: F401  (fixtures)

CPU = torch.device("cpu")


class HeldFSDP(FSDP):
    """The port's fsdp; a held call waits for the loss first (``mde.HeldDP``'s
    rule)."""

    def __init__(self, seen=None, hold=None):
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
        live = task._live_state
        if live is not None:
            reps = replicas(live[1])
            assert len(reps) == len(devices)
            # a block of several positions holds the state in shards; one
            # position holds it whole
            assert all(rep.get("shards") is not None for rep in reps) == (len(devices) > 1)


@pytest.fixture
def fsdp_runs(monkeypatch):
    monkeypatch.setattr(mde, "HeldDP", HeldFSDP)


def _restores_on_one_device(tmp_path, name, total):
    path = str(tmp_path / "torch" / "ckpts" / f"{name}.pt")
    assert ckpt.verify(path)
    task = mde._port_task(name, total, {1: mde.PER_BATCH}, DataParallel(),
                          str(tmp_path / "check"))
    state = ckpt.restore(path, DataParallel().build(task, [CPU], {"remat": False}).empty())
    assert state["step"] == total


def test_a_loss_with_no_return_shrinks_fsdp_four_to_two(tmp_path, losses, fsdp_runs):  # noqa: F811
    specs = [("solo", 12, {2: mde.PER_BATCH, 4: mde.PER_BATCH / 2})]
    out = mde._run_both(tmp_path, losses, specs, n_devices=4, seed=110,
                        hold={"solo": {2: 1}}, interval=0.15)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["completed"] == ["solo"] and got["steps"] == {"solo": 12}
    assert got["migration"] == [{"task": "solo", "moved_from": [4, 0], "moved_to": [2, 0]}]
    sizes = [size for _, size in out["torch_calls"]]
    assert sizes[:2] == [4, 4] and set(sizes[2:]) == {2}
    # the run on 2 positions restored the sharded state 4 positions wrote
    assert ("solo", True) in out["torch_restored"]
    _restores_on_one_device(tmp_path, "solo", 12)


def test_a_two_device_fsdp_pool_shrinks_to_one_position(tmp_path, losses, fsdp_runs):  # noqa: F811
    specs = [("pair", 10, {2: mde.PER_BATCH})]
    out = mde._run_both(tmp_path, losses, specs, n_devices=2, seed=27,
                        hold={"pair": {2: 1}}, interval=0.15)
    got, want = out["torch"], out["jax"]
    assert got == want
    assert got["completed"] == ["pair"] and got["steps"] == {"pair": 10}
    assert got["synthesized"] == [{"pair": [1]}]
    assert got["migration"] == [{"task": "pair", "moved_from": [2, 0], "moved_to": [1, 0]}]
    assert ("pair", True) in out["torch_restored"]
    _restores_on_one_device(tmp_path, "pair", 10)
