"""Tree stacking for fused multi-model training (``parallel/fused.py``).

Counterpart of ``saturn_tpu/ops/stacking.py``, over nested dicts (and lists
or tuples) of tensors or numpy arrays instead of pytrees. N sweep members
that share an architecture differ only in their leaf values (params,
optimizer moments, step counts), never in structure or leaf shapes.
Stacking prepends a member axis to every leaf, so the group becomes one
train state that one stacked program advances; these helpers are the
(un)stacking algebra the fused technique, its unfuse path and the
per-member checkpoints are written against. A numpy tree stays numpy, a
tensor tree stays on its device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class MemberShapeError(ValueError):
    """A member's array disagrees with the group's common shape or dtype,
    raised at staging time with the member's task name, so a heterogeneous
    group fails with a message that names it."""

    def __init__(self, member: str, got: Any, want: Any, what: str = "batch"):
        self.member = member
        self.got = got
        self.want = want
        super().__init__(
            f"fused member {member!r}: {what} shape/dtype {got} does not match the "
            f"group's {want} — fusion requires identical per-member shapes (same "
            f"batch_size/seq_len/model config)"
        )


def _structure(tree: Any) -> Any:
    """The tree's structure with its leaves left out (dict keys in order)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); dicts, lists and tuples are the inner nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack N structurally identical trees along a new leading axis: leaf
    k of the result has shape ``(N, *leaf_k.shape)``. Numpy in, numpy out;
    tensors in, a tensor on their device out."""
    if not trees:
        raise ValueError("stack_trees: empty member list")
    want = _structure(trees[0])
    for t in trees[1:]:
        if _structure(t) != want:
            raise ValueError(
                "stack_trees: member trees have different structures — fusion "
                "requires an identical fusion fingerprint"
            )

    def stack(*col):
        if isinstance(col[0], torch.Tensor):
            return torch.stack(col)
        return np.stack([np.asarray(x) for x in col])

    return tree_map(stack, trees[0], *trees[1:])


def member_slice(tree: Any, i: int) -> Any:
    """Member ``i``'s tree: every leaf's ``[i]`` (the per-member checkpoint
    view, shaped as the member's solo state)."""
    return tree_map(lambda x: x[int(i)], tree)


def unstack_tree(tree: Any, n: int) -> List[Any]:
    """Split a stacked tree back into its N member trees (the inverse of
    :func:`stack_trees`)."""
    return [member_slice(tree, i) for i in range(int(n))]


def remove_member(tree: Any, i: int) -> Any:
    """A stacked tree with member ``i`` sliced out (the unfuse operation):
    every leaf ``(N, ...)`` becomes ``(N-1, ...)``, the survivors in order,
    so surviving index ``j`` is old index ``j if j < i else j + 1``."""
    i = int(i)

    def drop(x):
        n = x.shape[0]
        if not 0 <= i < n:
            raise IndexError(f"remove_member: index {i} out of range for N={n}")
        if isinstance(x, torch.Tensor):
            return torch.cat([x[:i], x[i + 1:]], dim=0)
        return np.delete(x, i, axis=0)

    return tree_map(drop, tree)


def stacked_shapes(member_shapes: Any, n: int) -> Any:
    """``(shape, dtype)`` leaves of an N-stack of a member-shaped tree whose
    leaves are tensors (meta tensors included) or arrays."""
    return tree_map(lambda s: ((int(n), *tuple(s.shape)), s.dtype), member_shapes)


def stack_member_batches(
    batches: Sequence[Any],
    member_names: Optional[Sequence[str]] = None,
    expect: Optional[Tuple[int, ...]] = None,
) -> np.ndarray:
    """One ``(N, batch, seq)`` staging stack from N members' host batches.

    Every member's batch must share shape and dtype; a mismatch raises
    :class:`MemberShapeError` naming the member. ``expect``: the per-member
    shape the stacked program was built for; member 0 is held to it too."""
    arrs = [np.asarray(b) for b in batches]
    if not arrs:
        raise ValueError("stack_member_batches: empty member list")
    names = (list(member_names) if member_names is not None
             else [f"member[{i}]" for i in range(len(arrs))])
    want = tuple(expect) if expect is not None else arrs[0].shape
    want_dtype = arrs[0].dtype
    for name, a in zip(names, arrs):
        if tuple(a.shape) != tuple(want) or a.dtype != want_dtype:
            raise MemberShapeError(name, (tuple(a.shape), str(a.dtype)),
                                   (tuple(want), str(want_dtype)))
    return np.stack(arrs)


def stacked_hparam_array(values: Sequence[float], dtype: Any = torch.float32,
                         device: Any = None) -> torch.Tensor:
    """Per-member hyperparameters as a stacked ``(N,)`` tensor, passed into
    the stacked step beside the state stack (each member's optimizer update
    reads its own value)."""
    return torch.tensor([float(v) for v in values], dtype=dtype, device=device)


def tree_equal(a: Any, b: Any) -> bool:
    """Bitwise equality of two trees (a test and benchmark helper)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return all(np.array_equal(host(x), host(y)) for x, y in zip(la, lb))
