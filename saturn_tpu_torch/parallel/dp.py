"""Data-parallel executor on one device.

Counterpart of ``saturn_tpu/parallel/dp.py``. In this slice a block holds
one device, so the step is the plain train step; gradient all-reduce over a
multi-device block (NCCL through ``torch.distributed``) is a later item,
and ``search`` reports larger blocks infeasible.
"""

from __future__ import annotations

from typing import Any, Dict, List

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique


class DataParallel(SPMDTechnique):
    name = "dp"
    technique = Techniques.DP

    def candidate_configs(self, task, n_devices) -> List[Dict[str, Any]]:
        # remat off first (faster when it fits), on as the fallback, crossed
        # with flash / dense attention where the flash kernels can run
        return self._with_attention_variants(
            task, [{"remat": False}, {"remat": True}]
        )
