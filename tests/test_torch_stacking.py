"""The port's tree stacking (``saturn_tpu_torch/ops/stacking.py``) against the
JAX package's (``saturn_tpu/ops/stacking.py``) on the same trees: the cases
of ``tests/test_fused.py``'s ``TestStacking``. Stacking, slicing and removal
move values without arithmetic, so every result is held bitwise (tolerance
0), as a torch tree and as a numpy tree.
"""

import numpy as np
import pytest
import torch

from saturn_tpu.ops import stacking as jstacking
from saturn_tpu_torch.ops import stacking


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "opt": {"m": rng.normal(size=(2, 2)).astype(np.float32)}}


def _torch(tree):
    return stacking.tree_map(torch.from_numpy, tree)


def _np(tree):
    return stacking.tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                             else np.asarray(x), tree)


def _equal(got, want):
    """Leaf by leaf, matched by key (the JAX tree orders dict keys sorted)."""
    got = _np(got)
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_stack_unstack_roundtrip(kind):
    trees = [_tree(i) for i in range(3)]
    conv = _torch if kind == "torch" else (lambda t: t)
    stacked = stacking.stack_trees([conv(t) for t in trees])
    want = jstacking.stack_trees(trees)
    assert tuple(stacked["w"].shape) == (3, 3, 4)
    _equal(stacked, want)
    for got, jgot in zip(stacking.unstack_tree(stacked, 3), jstacking.unstack_tree(want, 3)):
        _equal(got, jgot)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_member_slice_is_checkpoint_view(kind):
    trees = [_tree(i) for i in range(3)]
    conv = _torch if kind == "torch" else (lambda t: t)
    stacked = stacking.stack_trees([conv(t) for t in trees])
    _equal(stacking.member_slice(stacked, 1),
           jstacking.member_slice(jstacking.stack_trees(trees), 1))
    _equal(stacking.member_slice(stacked, 1), trees[1])


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_remove_member_preserves_order(kind):
    trees = [_tree(i) for i in range(4)]
    conv = _torch if kind == "torch" else (lambda t: t)
    shrunk = stacking.remove_member(stacking.stack_trees([conv(t) for t in trees]), 1)
    jshrunk = jstacking.remove_member(jstacking.stack_trees(trees), 1)
    assert shrunk["w"].shape[0] == 3
    _equal(shrunk, jshrunk)
    for out_i, src_i in enumerate([0, 2, 3]):
        _equal(stacking.member_slice(shrunk, out_i), trees[src_i])
    with pytest.raises(IndexError):
        stacking.remove_member(shrunk, 3)


def test_batch_mismatch_names_the_member():
    good = np.zeros((2, 8), dtype=np.int32)
    bad = np.zeros((2, 9), dtype=np.int32)
    with pytest.raises(stacking.MemberShapeError) as ei:
        stacking.stack_member_batches([good, bad, good], member_names=["a", "b", "c"])
    with pytest.raises(jstacking.MemberShapeError) as ej:
        jstacking.stack_member_batches([good, bad, good], member_names=["a", "b", "c"])
    assert str(ei.value) == str(ej.value) and ei.value.member == "b"
    # member 0 is held to the program's shape too
    with pytest.raises(stacking.MemberShapeError) as ei:
        stacking.stack_member_batches([bad, bad], member_names=["x", "y"], expect=(2, 8))
    assert ei.value.member == "x"
    np.testing.assert_array_equal(
        stacking.stack_member_batches([good, good + 1]),
        jstacking.stack_member_batches([good, good + 1]))


def test_structure_mismatch_raises_and_helpers_agree():
    a, b = _tree(0), _tree(1)
    del b["b"]
    with pytest.raises(ValueError, match="different structures"):
        stacking.stack_trees([a, b])
    shapes = stacking.stacked_shapes(_torch(_tree(0)), 5)
    assert shapes["w"] == ((5, 3, 4), torch.float32)
    jshapes = jstacking.stacked_shapes(
        {k: v for k, v in _tree(0).items() if k != "opt"}, 5)
    assert tuple(jshapes["w"].shape) == shapes["w"][0]
    lrs = [1e-4, 3e-4, 6e-4]
    np.testing.assert_array_equal(stacking.stacked_hparam_array(lrs).numpy(),
                                  np.asarray(jstacking.stacked_hparam_array(lrs)))
    assert stacking.tree_equal(_torch(_tree(2)), _tree(2))
    assert not stacking.tree_equal(_tree(2), _tree(3))
