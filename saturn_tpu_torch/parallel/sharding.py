"""Partition-spec rules: parallelism as a placement of every state leaf.

Counterpart of ``saturn_tpu/parallel/sharding.py``. A rule is a pure
function ``(path, shape, mesh_axes) -> spec``: ``path`` is the leaf's JAX
tree path (``params/blocks/qkv/kernel``, ``opt_state/0/mu/wte``), ``shape``
its JAX shape (a block leaf stacked on a leading layer axis, a dense kernel
(in, out)), ``mesh_axes`` the ``{axis: size}`` of the block's mesh, and the
spec a tuple of one entry per dimension: None (not split), an axis name, or
a tuple of axis names. ``spec_str`` prints it as JAX prints a
``PartitionSpec``.

The JAX package hands the specs to GSPMD, which inserts the gathers and the
reduce-scatters. The port reads them as data: ``extent`` is the block of a
leaf that mesh position r holds (what ``NamedSharding.devices_indices_map``
gives device r), and ``parallel/spmd_base.sharded_step_fns`` and
``utils/checkpoint.py`` place, gather and write the leaves by it. The rules
see the JAX path and the JAX shape, never the port's per-layer tensors: a
layer norm's scale is (12, 768) stacked, 9216 elements, sharded; per layer
it would be 768, under ``min_size``, and would stay replicated.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

Spec = Tuple[Any, ...]
Extent = Tuple[Tuple[int, int], ...]


class ShardingLintError(ValueError):
    """A spec that the mesh cannot satisfy (the JAX package's
    ``analysis.jax_lint.enforce_pspec``): an unknown axis, or more entries
    than the leaf has dimensions."""


def replicated_rules(path: str, shape: Tuple[int, ...], mesh_axes) -> Spec:
    """DP: every leaf on every position; only the batch is split."""
    return ()


def fsdp_rules(axis: str = "data", min_size: int = 1024):
    """ZeRO-3 rules: split each leaf's largest dimension that ``axis``
    divides over ``axis`` (ties to the later dimension: a stacked leaf's
    later dimensions are the weight's own). A leaf under ``min_size``
    elements stays replicated."""

    def rules(path: str, shape: Tuple[int, ...], mesh_axes) -> Spec:
        n_shard = mesh_axes[axis]
        if int(np.prod(shape)) < min_size or not shape:
            return ()
        best, best_size = None, -1
        for i, s in enumerate(shape):
            if s % n_shard == 0 and s >= best_size:
                best, best_size = i, s
        if best is None:
            return ()
        spec = [None] * len(shape)
        spec[best] = axis
        return tuple(spec)

    return rules


def tensor_parallel_rules(axis: str = "model"):
    """Megatron rules for the GPT-2 tree: qkv, mlp_in and mlp_gate kernels
    and biases split their output dimension, attn_out and mlp_out kernels
    their input dimension, wte its vocab rows."""
    col = re.compile(r"(qkv|mlp_in|mlp_gate)/kernel$")
    row = re.compile(r"(attn_out|mlp_out)/kernel$")
    colb = re.compile(r"(qkv|mlp_in|mlp_gate)/bias$")
    vocab = re.compile(r"(^|/)wte$")

    def rules(path: str, shape: Tuple[int, ...], mesh_axes) -> Spec:
        n_shard = mesh_axes[axis]
        spec = [None] * len(shape)
        if col.search(path) and shape[-1] % n_shard == 0:
            spec[-1] = axis
        elif row.search(path) and shape[-2] % n_shard == 0:
            spec[-2] = axis
        elif colb.search(path) and shape[-1] % n_shard == 0:
            spec[-1] = axis
        elif vocab.search(path) and shape[0] % n_shard == 0:
            spec[0] = axis
        return tuple(spec)

    return rules


def compose_rules(*rule_fns):
    """Merge rules; a later rule fills the dimensions the earlier ones left
    None, with an axis none of them used (FSDP beside TP on a 2-D mesh)."""

    def rules(path: str, shape: Tuple[int, ...], mesh_axes) -> Spec:
        spec = [None] * len(shape)
        used = set()
        for fn in rule_fns:
            for i, a in enumerate(tuple(fn(path, shape, mesh_axes))):
                if a is not None and spec[i] is None and a not in used:
                    spec[i] = a
                    used.add(a)
        return tuple(spec)

    return rules


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def enforce_spec(spec: Spec, shape: Tuple[int, ...], mesh_axes, path: str = "",
                 rules: Optional[Callable] = None) -> None:
    """Raise :class:`ShardingLintError` where ``spec`` names an axis the mesh
    lacks or is longer than ``shape``'s rank."""
    where = f" at {path!r}" if path else ""
    by = f" (rule {getattr(rules, '__qualname__', rules)})" if rules is not None else ""
    if len(spec) > len(shape):
        raise ShardingLintError(f"spec {spec_str(spec)}{where} has {len(spec)} entries for a "
                                f"leaf of rank {len(shape)}{by}")
    for entry in spec:
        for a in _axes_of(entry):
            if a not in mesh_axes:
                raise ShardingLintError(f"spec {spec_str(spec)}{where} names axis {a!r}, not "
                                        f"in the mesh {sorted(mesh_axes)}{by}")


def spec_str(spec: Spec) -> str:
    """``spec`` as JAX prints the ``PartitionSpec`` (a tuple's repr):
    ``PartitionSpec(None, 'data')``, ``PartitionSpec(None,)`` for one
    entry, ``PartitionSpec()`` for a replicated leaf."""
    return "PartitionSpec" + repr(tuple(tuple(e) if isinstance(e, list) else e for e in spec))


def mesh_coords(r: int, mesh_axes: Dict[str, int]) -> Dict[str, int]:
    """Mesh position r's coordinate on every axis: positions fill the mesh
    in row-major order of its axes (``mesh.devices.reshape(sizes)``)."""
    coords = {}
    for a, size in reversed(list(mesh_axes.items())):
        coords[a] = r % size
        r //= size
    return coords


def extent(spec: Spec, shape: Sequence[int], mesh_axes: Dict[str, int], r: int) -> Extent:
    """The ``(start, stop)`` block of a ``shape`` leaf under ``spec`` that
    mesh position r holds, per dimension: what JAX's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the r-th
    device of the mesh. A dimension split over several axes splits major to
    minor in the order they are named."""
    coords = mesh_coords(r, mesh_axes)
    out = []
    for d, dim in enumerate(shape):
        axes = _axes_of(spec[d]) if d < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= mesh_axes[a]
            idx = idx * mesh_axes[a] + coords[a]
        if dim % parts:
            raise ShardingLintError(f"dimension {d} of {tuple(shape)} is not divisible by "
                                    f"{parts} ({spec_str(spec)})")
        size = dim // parts
        out.append((idx * size, (idx + 1) * size))
    return tuple(out)


def extents(spec: Spec, shape: Sequence[int], mesh_axes: Dict[str, int]) -> Tuple[Extent, ...]:
    """Every position's :func:`extent`, in position order."""
    n = int(np.prod(list(mesh_axes.values()))) if mesh_axes else 1
    return tuple(extent(spec, shape, mesh_axes, r) for r in range(n))


def pspec_tree(shapes: Dict[str, Tuple[int, ...]], rules: Callable,
               mesh_axes: Dict[str, int]) -> Dict[str, Spec]:
    """A rule over every leaf of a flat ``{path: shape}`` tree, each spec
    linted (:func:`enforce_spec`)."""
    out = {}
    for path, shape in shapes.items():
        spec = tuple(rules(path, tuple(shape), mesh_axes))
        enforce_spec(spec, tuple(shape), mesh_axes, path=path, rules=rules)
        out[path] = spec
    return out
