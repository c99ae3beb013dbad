"""Data-parallel executor: one model replica per position of the block.

Counterpart of ``saturn_tpu/parallel/dp.py``. On one device the step is the
plain train step. On a block of n positions each position holds a replica
that takes its contiguous share of the batch (JAX's ``data``-axis
sharding); the replicas' gradients are summed in place by the block's
reducer (``parallel/collectives.py``) before every replica's optimizer
steps (``SPMDTechnique.replicated_step_fns``). The parameters are
replicated, so the fused head+loss runs on every replica and its
``(loss_sum, valid_count)`` parts are summed before the divide
(``fused_loss_shardable``).
"""

from __future__ import annotations

from typing import Any, Dict, List

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique


class DataParallel(SPMDTechnique):
    name = "dp"
    technique = Techniques.DP
    # Params replicated + batch split over the replicas: the fused head+loss
    # runs on multi-device blocks too, its parts summed by the reducer
    fused_loss_shardable = True

    def candidate_configs(self, task, n_devices) -> List[Dict[str, Any]]:
        # remat off first (faster when it fits), on as the fallback, crossed
        # with flash / dense attention where the flash kernels can run; the
        # same grid at every block size, as in the JAX package
        return self._with_attention_variants(
            task, [{"remat": False}, {"remat": True}]
        )
