"""Map the JAX package's GPT-2 parameter tree onto the port's modules.

The flax tree (``saturn_tpu.models.gpt2``) is nested dicts: ``wte``,
``wpe`` (non-rotary configs), ``ln_f/{scale,bias}``, and ``blocks/<layer>/
<leaf>`` where every block leaf carries a leading layer axis (e.g.
``blocks/qkv/kernel`` is (L, D, 3D)). Flax Dense kernels are (in, out);
``torch.nn.Linear.weight`` is (out, in).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (leaves array-like) -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if key == "blocks":
            for mod, leaves in val.items():
                for leaf, arr in leaves.items():
                    arr = np.asarray(arr)
                    for i in range(arr.shape[0]):
                        if leaf == "kernel":
                            out[f"blocks.{i}.{mod}.weight"] = torch.tensor(arr[i].T)
                        else:
                            out[f"blocks.{i}.{mod}.{leaf}"] = torch.tensor(arr[i])
        elif isinstance(val, Mapping):
            for leaf, arr in val.items():
                out[f"{key}.{leaf}"] = torch.tensor(np.asarray(arr))
        else:
            out[key] = torch.tensor(np.asarray(val))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the JAX
    tree layout, leaves as numpy arrays."""
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
