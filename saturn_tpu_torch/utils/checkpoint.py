"""Full train-state checkpoints: ``{params, opt_state, step}``.

Counterpart of ``saturn_tpu/utils/checkpoint.py``. The state holds the model
(``params``, an ``nn.Module``), the optimizer (``opt_state``) and the step
count; a checkpoint holds their ``state_dict``s and the step, written to a
temporary file and renamed over ``task.ckpt_path`` so a reader never sees a
half-written file. The JAX package's sharded manifest format, asynchronous
writes and publish hooks are later items.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save(path: str, state: Dict[str, Any]) -> None:
    payload = {
        "params": state["params"].state_dict(),
        "opt_state": state["opt_state"].state_dict(),
        "step": int(state["step"]),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str, map_location="cpu") -> Dict[str, Any]:
    """The saved payload: ``{"params": state_dict, "opt_state":
    optimizer state_dict, "step": int}``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint into ``state`` (in place) and return it.

    The payload is read to the host: ``load_state_dict`` copies weights and
    moments to their parameters' device and leaves the optimizers' step
    counts on the host, where torch keeps them. A step count on the card
    would make every optimizer step read it back, once per parameter."""
    saved = load(path)
    state["params"].load_state_dict(saved["params"])
    state["opt_state"].load_state_dict(saved["opt_state"])
    state["step"] = int(saved["step"])
    return state
