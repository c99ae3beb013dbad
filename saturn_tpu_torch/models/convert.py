"""Map the JAX package's GPT-2 parameter tree onto the port's modules.

The flax tree (``saturn_tpu.models.gpt2``) is nested dicts: ``wte``,
``wpe`` (non-rotary configs), ``ln_f/{scale,bias}``, and ``blocks/<layer>/
<leaf>`` where every block leaf carries a leading layer axis (e.g.
``blocks/qkv/kernel`` is (L, D, 3D)). Flax Dense kernels are (in, out);
``torch.nn.Linear.weight`` is (out, in).

``state_layout`` extends the map to the whole train state: the leaves of
``{params, opt_state, step}`` under the JAX package's tree paths, which
the checkpoint manifest (``utils/checkpoint.py``) keys by, so a checkpoint
written by either package restores in the other.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any],
                    extents: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """JAX param tree (leaves array-like) -> the port's ``state_dict``.

    With ``extents`` (``{"blocks/qkv/kernel": ((start, stop), ...), ...}``,
    a leaf's block per JAX dimension, as ``sharding.extent`` gives it) the
    tree holds one mesh position's blocks and the result is that
    position's tensors (tp's and fsdp's per-position form): a stacked
    leaf's block names the layers it covers, each layer's block transposed
    for a kernel. A leaf the mapping leaves out is whole."""
    out: Dict[str, torch.Tensor] = {}
    extents = extents or {}
    for key, val in tree.items():
        if key == "blocks":
            for mod, leaves in val.items():
                for leaf, arr in leaves.items():
                    arr = np.asarray(arr)
                    first = extents.get(f"blocks/{mod}/{leaf}", ((0, arr.shape[0]),))[0][0]
                    for j in range(arr.shape[0]):
                        i = first + j
                        if leaf == "kernel":
                            out[f"blocks.{i}.{mod}.weight"] = torch.tensor(arr[j].T)
                        else:
                            out[f"blocks.{i}.{mod}.{leaf}"] = torch.tensor(arr[j])
        elif isinstance(val, Mapping):
            for leaf, arr in val.items():
                out[f"{key}.{leaf}"] = torch.tensor(np.asarray(arr))
        else:
            out[key] = torch.tensor(np.asarray(val))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the JAX
    tree layout, leaves as numpy arrays. One position's tensors (each its
    extent, a stacked leaf's layers those it holds) give that position's
    blocks."""
    tree: Dict[str, Any] = {}
    stacked: Dict[str, Dict[str, Dict[int, np.ndarray]]] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        m = re.fullmatch(r"blocks\.(\d+)\.(\w+)\.(\w+)", name)
        if m:
            i, mod, leaf = int(m.group(1)), m.group(2), m.group(3)
            if leaf == "weight":
                leaf, arr = "kernel", arr.T
            stacked.setdefault(mod, {}).setdefault(leaf, {})[i] = arr
        elif "." in name:
            mod, leaf = name.split(".", 1)
            tree.setdefault(mod, {})[leaf] = arr
        else:
            tree[name] = arr
    tree["blocks"] = {
        mod: {leaf: np.stack([by_i[i] for i in sorted(by_i)]) for leaf, by_i in leaves.items()}
        for mod, leaves in stacked.items()
    }
    return tree


def stacked_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's fused stack of params (``saturn_tpu.parallel.fused``:
    every leaf with a leading model axis, (M, ...)) -> the port's stacked
    ``state_dict`` (``parallel/fused.py``: the solo names, every tensor
    (M, ...)), member by member through :func:`params_from_jax`."""
    node = tree
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    n = int(np.shape(node)[0])

    def member(node, i):
        return {k: member(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in node.items()}

    members = [params_from_jax(member(tree, i)) for i in range(n)]
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


# ------------------------------------------------------------ the train state
#: torch optimizer state keys that hold optax's ``mu`` / ``nu`` of
#: ``optax.adamw`` and ``optax.adam`` (``opt_state/0/{mu,nu,count}``; the
#: other members of optax's chain hold no leaf). ``optax.sgd`` holds none.
MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu"}


@dataclass(frozen=True)
class Leaf:
    """One leaf of the train state in the JAX package's tree.

    ``key`` is its tree path (``params/blocks/qkv/kernel``), ``shape`` and
    ``dtype`` its JAX shape and dtype. ``names`` are the port's tensors
    behind it: one per layer for a leaf stacked on a layer axis
    (``stacked``), else one; ``transpose`` where each is the transpose of
    its (per-layer) JAX block (``nn.Linear`` against a flax kernel).
    ``kind`` says what the tensors are: ``param`` (the named parameters or
    buffers themselves), an optimizer state key (``exp_avg``: the state of
    the named parameters under that key), ``count`` (the optimizer's step
    count, one scalar) or ``step`` (the task's)."""

    key: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    names: Tuple[str, ...] = ()
    stacked: bool = False
    transpose: bool = False
    kind: str = "param"

    @property
    def port_shape(self) -> Tuple[int, ...]:
        """The shape of each of ``names``: the JAX shape without its layer
        axis, reversed for a transposed kernel."""
        shape = self.shape[1:] if self.stacked else self.shape
        return tuple(reversed(shape)) if self.transpose else tuple(shape)

    def port_extent(self, jax_extent, j: int):
        """The block of ``names[j]`` inside a JAX block ``jax_extent`` (its
        ``(start, stop)`` per JAX dimension), in the port tensor's
        coordinates; None where the block holds none of it (a stacked leaf
        split over its layer axis)."""
        ext = tuple(jax_extent)
        if self.stacked:
            a, b = ext[0]
            if not a <= j < b:
                return None
            ext = ext[1:]
        return tuple(reversed(ext)) if self.transpose else ext


def jax_layout(model: Any) -> bool:
    """Whether ``model`` has the JAX package's parameter tree: the GPT-2
    family and BERT (``models/gpt2.GPT2``), or a view that says so (a fused
    stack's member, ``parallel/fused._SoloView``)."""
    from saturn_tpu_torch.models.gpt2 import GPT2

    return isinstance(model, GPT2) or bool(getattr(model, "jax_layout", False))


def optimizer_kind(opt: Any) -> str:
    """``adam`` (AdamW and Adam: optax's ``mu``, ``nu`` and ``count``),
    ``sgd`` (no state leaf) or ``other`` (a user's optimizer: its state
    keyed by parameter name and state key)."""
    if isinstance(opt, (torch.optim.AdamW, torch.optim.Adam)):
        return "adam"
    if isinstance(opt, torch.optim.SGD) and not any(
            g.get("momentum", 0) for g in opt.param_groups):
        return "sgd"
    return "other"


def _param_leaves(named: Sequence[Tuple[str, torch.Tensor]], layout: bool) -> List[Leaf]:
    if not layout:
        return [Leaf(f"params/{n}", tuple(t.shape), t.dtype, (n,)) for n, t in named]
    leaves: Dict[str, Leaf] = {}
    stacked: Dict[str, Dict[int, Tuple[str, torch.Tensor]]] = {}
    for n, t in named:
        m = re.fullmatch(r"blocks\.(\d+)\.(\w+)\.(\w+)", n)
        if m:
            leaf = "kernel" if m.group(3) == "weight" else m.group(3)
            stacked.setdefault(f"params/blocks/{m.group(2)}/{leaf}", {})[int(m.group(1))] = (n, t)
        else:
            leaves[f"params/{n.replace('.', '/')}"] = Leaf(
                f"params/{n.replace('.', '/')}", tuple(t.shape), t.dtype, (n,))
    for key, by_i in stacked.items():
        layers = [by_i[i] for i in sorted(by_i)]
        t0 = layers[0][1]
        tr = key.endswith("/kernel")
        per = tuple(reversed(t0.shape)) if tr else tuple(t0.shape)
        leaves[key] = Leaf(key, (len(layers), *per), t0.dtype, tuple(n for n, _ in layers),
                           stacked=True, transpose=tr)
    return [leaves[k] for k in sorted(leaves)]


def state_layout(model: Any, opt: Any, kind: Optional[str] = None) -> List[Leaf]:
    """Every leaf of a train state ``{params: model, opt_state: opt, step}``
    in the JAX package's tree, which the checkpoint manifest keys by.

    The GPT-2 family and BERT (:func:`jax_layout`) take the JAX tree:
    ``params/...`` as :func:`params_to_jax` lays it out (block leaves
    stacked on a layer axis, kernels (in, out)); AdamW's and Adam's
    ``exp_avg`` / ``exp_avg_sq`` as ``opt_state/0/mu/...`` /
    ``opt_state/0/nu/...`` beside them, their per-parameter step counts as
    the one int32 ``opt_state/0/count``; SGD none; and the task's step as
    the int32 ``step``. A model with no JAX counterpart (a user's own
    ``nn.Module``) keys by ``params/<state_dict name>``, its optimizer's
    state by ``opt_state/<parameter name>/<state key>`` (each state tensor
    the optimizer holds), and ``step``. ``kind`` (:func:`optimizer_kind`)
    stands for ``opt`` where the state's optimizer is not at hand."""
    layout = jax_layout(model)
    named = list(model.state_dict().items()) if not layout else list(model.named_parameters())
    params = _param_leaves(named, layout)
    kind = kind or optimizer_kind(opt)
    leaves: List[Leaf] = []
    by_name = dict(model.named_parameters())
    if layout and kind == "adam":
        leaves.append(Leaf("opt_state/0/count", (), torch.int32, kind="count"))
        for state_key, slot in MOMENTS.items():
            for p in params:
                leaves.append(Leaf(p.key.replace("params/", f"opt_state/0/{slot}/", 1), p.shape,
                                   p.dtype, p.names, p.stacked, p.transpose, kind=state_key))
    elif kind != "sgd":
        index = {id(p): n for n, p in by_name.items()}
        for p in (p for g in opt.param_groups for p in g["params"]):
            name = index.get(id(p))
            for k, v in sorted(opt.state.get(p, {}).items()):
                if name is not None and isinstance(v, torch.Tensor):
                    leaves.append(Leaf(f"opt_state/{name}/{k}", tuple(v.shape), v.dtype, (name,),
                                       kind=k))
    leaves += params
    leaves.append(Leaf("step", (), torch.int32, kind="task_step"))
    return sorted(leaves, key=lambda leaf: leaf.key)


def leaf_dtype_name(leaf: Leaf) -> str:
    """The leaf's dtype as the JAX package writes it (``float32``)."""
    return str(leaf.dtype).replace("torch.", "")
