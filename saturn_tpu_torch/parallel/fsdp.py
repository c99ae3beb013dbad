"""FSDP executor: the train state sharded over the block's positions.

Counterpart of ``saturn_tpu/parallel/fsdp.py``. Every leaf of the train
state (the fp32 parameters and the optimizer's moments) is split over the
block's ``data`` axis by ``sharding.fsdp_rules`` (ZeRO-3: each leaf's
largest dimension the block's size divides, a leaf under 1024 elements
kept whole), applied to the JAX path and shape of each leaf; each position
steps its optimizer on its shards, and the step gathers the full
parameters before the forward and reduce-scatters the gradients after the
backward (``SPMDTechnique.sharded_step_fns``). On a block of n > 1 the loss
runs over the logits, as the JAX package's GSPMD step does
(``fused_loss_shardable`` is False); on one device it is the plain step,
the fused head included.

The grid is the JAX package's: remat on and off without offload; the
offload points only where ``host_offload_supported()`` (pinned-host state
is a TPU feature of the JAX package; the port's counterpart is a later
item, so it answers False and the grid equals JAX's off a TPU); and the two
``overlap`` points, the ZeRO-3 program with layer k+1's gather under layer
k (``ops/collective_matmul.py``), where ``_overlap_ok`` holds. The
instance's ``prefetch`` (True) picks the prefetched program; False runs the
same program with each gather on the critical path, bit for bit the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.ops.collective_matmul import zero3_block_rules
from saturn_tpu_torch.parallel import sharding as shr
from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique


def host_offload_supported() -> bool:
    """Whether fsdp's offload grid points run: not in the port yet (the
    JAX package's pinned-host state runs on a TPU only; ``ROADMAP.md``
    item 7, offload's ``zero`` config)."""
    return False


class FSDP(SPMDTechnique):
    name = "fsdp"
    technique = Techniques.FSDP
    shards_state = True

    def __init__(self) -> None:
        super().__init__()
        # the ZeRO-3 program's gathers: layer k+1 under layer k (True) or
        # each on the critical path (False); the same bits either way
        self.prefetch = True

    def mesh_spec(self, n_devices, task, config) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        return ("data",), (n_devices,)

    def param_rules(self, task, config):
        if config.get("overlap"):
            spec = task.get_model()
            return zero3_block_rules(block_key=spec.hints.get("block_param_key", "blocks"),
                                     axis="data")
        return shr.fsdp_rules(axis="data")

    def candidate_configs(self, task, n_devices) -> List[Dict[str, Any]]:
        grid: List[Dict[str, Any]] = [
            {"remat": False, "offload": False},
            {"remat": True, "offload": False},
        ]
        if host_offload_supported():
            grid += [
                {"remat": True, "offload": True},
                {"remat": False, "offload": True},
            ]
        if self._overlap_ok(task, n_devices):
            grid += [
                {"remat": False, "offload": False, "overlap": True},
                {"remat": True, "offload": False, "overlap": True},
            ]
        return self._with_attention_variants(task, grid)

    def _overlap_ok(self, task, n_devices: int) -> bool:
        """The ZeRO-3 program needs the model's pipeline decomposition and
        a batch the block's size divides."""
        try:
            spec = task.get_model()
            ds = task.get_dataset()
        except Exception:
            return False
        if "pipeline" not in spec.hints or spec.apply_with_aux_fn is not None:
            return False
        return ds.batch_size % n_devices == 0

    def make_step_fns(self, spec, task, config, device, ds):
        """One device: the plain step, or the ZeRO-3 program (its loss over
        the logits) for an overlap config, as the JAX package builds it at
        any size."""
        if not config.get("overlap"):
            return super().make_step_fns(spec, task, config, device, ds)
        return self.sharded_step_fns(spec, task, [device], config)

    def state_bytes(self, task, config, size: int = 1) -> int:
        """One replica's bytes on its device at a block of ``size``: the
        gathered parameters and their flat gradients whole, the shard of
        the parameters, their gradients and moments (``size`` 1: the plain
        state)."""
        params, moments = self._param_bytes(task, config)
        if size <= 1:
            return params * (2 + moments)
        return 2 * params + params * (2 + moments) // size
