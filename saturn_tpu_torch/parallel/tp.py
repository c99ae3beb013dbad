"""Tensor-parallel executor: Megatron sharding over a 2-D (data, model) block.

Counterpart of ``saturn_tpu/parallel/tp.py``. A block of n positions is a
``("data", "model")`` mesh of ``(n // tp, tp)`` (``config["tp"]``, default
``min(n, 2)``): position r sits at data row r // tp, model coordinate
r % tp. The batch shards over ``data`` only, so the tp positions of a row
see the same rows. ``sharding.tensor_parallel_rules("model")`` places the
state: the columns of ``qkv``, ``mlp_in`` and ``mlp_gate`` and the rows of
``attn_out`` and ``mlp_out`` split over ``model``, ``wte`` by vocab rows,
everything else replicated; with ``zero`` composed with
``fsdp_rules("data")``. The JAX package hands the specs to GSPMD; the port
runs Megatron's column- and row-parallel products itself
(``SPMDTechnique.tp_step_fns``, ``models/gpt2.tp_logits``): each position
holds only its extents, runs attention on its own heads and exchanges
activations through the model group's f and g
(``parallel/collectives.ModelGroup``).

The loss runs over the logits (``fused_loss_ok`` False: the CE head cannot
take a vocab shard). The grid is the JAX package's: for tp = 2, 4, ...
while tp <= n and n_heads % tp == 0, the plain point and remat with
``zero``, and the two ``overlap`` points (the ZeRO-3 program of
``ops/collective_matmul.py`` with the block leaves split over ``model`` and
the batch over both axes, ``sharded_step_fns``) where ``_overlap_ok``
holds, crossed with the attention variants; empty on one device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.ops.collective_matmul import zero3_block_rules
from saturn_tpu_torch.parallel import sharding as shr
from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique


class TensorParallel(SPMDTechnique):
    name = "tp"
    technique = Techniques.TENSOR
    # wte is split by vocab rows over 'model': the fused CE head cannot take
    # a vocab shard, so the loss runs over the logits
    fused_loss_ok = False
    shards_state = True
    splits_compute = True

    def mesh_spec(self, n_devices, task, config) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        tp = config.get("tp", min(n_devices, 2))
        return ("data", "model"), (n_devices // tp, tp)

    def param_rules(self, task, config):
        if config.get("overlap"):
            # the ZeRO-3 program's placement: block leaves over 'model',
            # the rest replicated
            spec = task.get_model()
            return zero3_block_rules(block_key=spec.hints.get("block_param_key", "blocks"),
                                     axis="model")
        if config.get("zero"):
            return shr.compose_rules(shr.tensor_parallel_rules("model"), shr.fsdp_rules("data"))
        return shr.tensor_parallel_rules("model")

    def batch_spec(self, config) -> Tuple[Any, ...]:
        """The token batch's spec: over both axes for the ZeRO-3 program
        (else it would repeat its compute over 'model'), else over
        ``data``."""
        if config.get("overlap"):
            return (("data", "model"),)
        return ("data",)

    def candidate_configs(self, task, n_devices) -> List[Dict[str, Any]]:
        spec = task.get_model()
        n_heads = getattr(spec.config, "n_heads", 1)
        overlap_ok = self._overlap_ok(task, n_devices)
        grid: List[Dict[str, Any]] = []
        tp = 2
        while tp <= n_devices and n_heads % tp == 0:
            grid.append({"tp": tp, "remat": False, "zero": False})
            grid.append({"tp": tp, "remat": True, "zero": True})
            if overlap_ok:
                grid.append({"tp": tp, "remat": False, "zero": True, "overlap": True})
                grid.append({"tp": tp, "remat": True, "zero": True, "overlap": True})
            tp <<= 1
        return self._with_attention_variants(task, grid)

    def _overlap_ok(self, task, n_devices: int) -> bool:
        """The ZeRO-3 program needs the model's pipeline decomposition and
        a batch that shards over the whole (data, model) mesh."""
        try:
            spec = task.get_model()
            ds = task.get_dataset()
        except Exception:
            return False
        if "pipeline" not in spec.hints or spec.apply_with_aux_fn is not None:
            return False
        return ds.batch_size % n_devices == 0

    def make_step_fns(self, spec, task, config, device, ds):
        """One device: the plain step over the logits, or the ZeRO-3
        program for an overlap config, as fsdp builds them."""
        if not config.get("overlap"):
            return super().make_step_fns(spec, task, config, device, ds)
        return self.sharded_step_fns(spec, task, [device], config)

    def _config_refusal(self, task: Any, n: int, config: Dict[str, Any]) -> Optional[str]:
        """The mesh factorization: tp must divide the block and the heads
        (the JAX package's build raises there), then the base's batch
        rule over ``batch_spec``."""
        tp = int(config.get("tp", min(n, 2)))
        if tp < 1 or n % tp:
            return f"tp {tp} does not divide a block of {n}"
        n_heads = getattr(task.get_model().config, "n_heads", 1)
        if n_heads % tp:
            return f"tp {tp} does not divide n_heads {n_heads}"
        return super()._config_refusal(task, n, config)

    def state_bytes(self, task, config, size: int = 1) -> int:
        """One position's bytes on its device at a block of ``size``: the
        model at its compute shapes and its flat gradients (the gathered
        qkv whole), the stored shards that are not the model's own tensors
        with their gradients, and the moments of everything it steps
        (``size`` 1: the plain state). The ZeRO-3 program's is fsdp's with
        the shards over ``model``."""
        params, moments = self._param_bytes(task, config)
        if size <= 1:
            return params * (2 + moments)
        if config.get("overlap"):
            tp = int(config.get("tp", min(size, 2)))
            return 2 * params + params * (2 + moments) // tp
        spec = task.get_model(**self._model_overrides(config))
        plan = self._tp_plan(spec, task, config, size)
        sizes = {leaf.names[j]: torch.empty((), dtype=leaf.dtype).element_size()
                 for leaf in plan.placement["layout"] if leaf.kind == "param"
                 for j in range(len(leaf.names))}

        def count(ext) -> int:
            out = 1
            for a, b in ext:
                out *= b - a
            return out

        compute = sum(count(plan.compute[k][0]) * sizes[k] for k in plan.kinds)
        stored = sum(count(plan.stored[k][0]) * sizes[k] for k in plan.kinds)
        apart = sum(count(plan.stored[k][0]) * sizes[k] for k, how in plan.kinds.items()
                    if how in ("gathered", "data"))
        return 2 * compute + 2 * apart + moments * stored
