"""SPMDTechnique: the shared machinery of data-parallel-style executors.

Counterpart of ``saturn_tpu/parallel/spmd_base.py``: the loss/grad/optimizer
scaffold around a model's forward pass (with the same routing to a model's
fused head+loss), the ``{params, opt_state, step}`` train state, the
autotune grid crossed with the attention variants, ``search`` (keep the
fastest config whose measured peak memory fits) and ``execute`` (resume from
the checkpoint, run n steps, write the checkpoint, report the realized
per-batch time).

This slice runs one device per task and dispatches one step at a time. The
JAX package's fused K-step window, batch prefetcher, live-state caching and
multi-device meshes are later items. The train step updates the model and
the optimizer in place (PyTorch's idiom; it keeps one copy of the state).
"""

from __future__ import annotations

import logging
import timeit
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import timing

log = logging.getLogger("saturn_tpu_torch")

#: Fraction of device memory a trial's measured peak may use.
MEMORY_HEADROOM = 0.92


@dataclass
class _Bundle:
    """Everything needed to run one (task, device, config) combination."""

    device: torch.device
    init: Callable[[], Dict[str, Any]]          # fresh state, seeded init
    empty: Callable[[], Dict[str, Any]]         # state to restore into
    step: Callable[[Dict[str, Any], torch.Tensor], Tuple[Dict[str, Any], torch.Tensor]]

    def stage(self, host_batch) -> torch.Tensor:
        """A host (B, T) int batch on the device as int64 token ids."""
        return torch.from_numpy(np.asarray(host_batch)).to(self.device, torch.long)


class SPMDTechnique(BaseTechnique):
    """Base for techniques expressible as a placement of one train step."""

    name = "spmd"

    # Whether standard-loss tasks may route through the model's fused
    # head+loss (``ModelSpec.fused_loss_fn``).
    fused_loss_ok = True

    def __init__(self) -> None:
        # Every trial this instance ran: (task, size, config, seconds per
        # batch or None, outcome), for reports of the sweep (chip_smoke.py).
        self.trials: List[Tuple[str, int, Dict[str, Any], Optional[float], str]] = []

    # ----------------------------------------------------------------- hooks
    def candidate_configs(self, task: Any, n_devices: int) -> List[Dict[str, Any]]:
        """Autotune grid, best-guess-first."""
        return [{}]

    def make_step_fns(
        self, spec: Any, task: Any, config: Dict[str, Any], device: Any, ds: Any
    ) -> Tuple[Any, Any]:
        """(init_state, train_step) for this technique: the standard step
        over the model's own forward pass."""
        return self.step_fns_from_forward(spec, task, spec.apply_fn, device=device)

    def step_fns_from_forward(
        self, spec: Any, task: Any, forward: Any, device: Any = None,
    ) -> Tuple[Any, Any]:
        """Loss/grad/optimizer scaffold around ``forward(model, batch)``.

        The task's loss runs over the logits unless the model offers a fused
        head+loss for exactly that objective (the JAX package's routing
        condition, ``spmd_base.py:476-488``, on one device): the technique
        runs the model's own forward and the loss's ``supports_fused_head``
        tag equals ``spec.fused_loss_objective``. Models with an auxiliary
        loss (mixture-of-experts) are a later item and raise.
        """
        if spec.apply_with_aux_fn is not None:
            raise NotImplementedError(
                f"{self.name}: auxiliary-loss models are a later item of the PyTorch port"
            )
        loss_fn = task.loss_fn
        fused = getattr(spec, "fused_loss_fn", None)
        tag = getattr(loss_fn, "supports_fused_head", None)
        if (
            fused is not None
            and self.fused_loss_ok
            and forward is spec.apply_fn
            and tag is not None
            and tag == getattr(spec, "fused_loss_objective", None)
        ):
            loss_of = fused
        else:
            def loss_of(model, batch):
                return loss_fn(forward(model, batch), batch)

        return self.step_fns_from_loss(spec, task, loss_of, device)

    def step_fns_from_loss(
        self, spec: Any, task: Any, loss_of: Any, device: Any
    ) -> Tuple[Any, Any]:
        """(init_state, train_step) around ``loss_of(model, batch)``: the
        single definition of the train state ``{params, opt_state, step}``.

        ``init_state()`` draws the weights from a ``torch.Generator`` seeded
        0 (the JAX package inits from ``PRNGKey(0)``);
        ``init_state(materialize=False)`` allocates them uninitialised, for a
        checkpoint to fill."""

        def init_state(materialize: bool = True) -> Dict[str, Any]:
            if materialize:
                model = spec.init_fn(torch.Generator().manual_seed(0), device)
            else:
                model = spec.abstract_init().to_empty(device=device)
            return {
                "params": model,
                "opt_state": task.hparams.make_optimizer(model.parameters()),
                "step": 0,
            }

        def train_step(state, batch):
            model, opt = state["params"], state["opt_state"]
            loss = loss_of(model, batch)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            state["step"] += 1
            return state, loss.detach()

        return init_state, train_step

    # -------------------------------------------------------------- building
    def _model_overrides(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        if "remat" in config:
            out["remat"] = config["remat"]
        if config.get("attention"):
            out["attention"] = config["attention"]
        return out

    def _with_attention_variants(
        self, task: Any, grid: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Cross the grid with explicit {flash, dense} attention where the
        CUDA flash kernels can run the task's model; the trial runner keeps
        whichever measures faster."""
        from saturn_tpu_torch.ops.flash import flash_supported

        cfg = task.get_model().config
        if getattr(cfg, "attention", None) is None or not flash_supported(cfg):
            return grid
        out: List[Dict[str, Any]] = []
        for c in grid:
            out.append(dict(c, attention="flash"))
            out.append(dict(c, attention="dense"))
        return out

    def build(self, task: Any, devices: Sequence[Any], config: Dict[str, Any]) -> _Bundle:
        if len(devices) != 1:
            raise NotImplementedError(
                f"{self.name}: multi-device blocks are a later item of the "
                f"PyTorch port (got {len(devices)} devices)"
            )
        device = torch.device(devices[0])
        spec = task.get_model(**self._model_overrides(config))
        init_state, train_step = self.make_step_fns(
            spec, task, config, device, task.get_dataset()
        )
        return _Bundle(
            device=device,
            init=init_state,
            empty=lambda: init_state(materialize=False),
            step=train_step,
        )

    # ---------------------------------------------------------------- search
    def search(
        self, task: Any, devices: Sequence[Any], tid: int
    ) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """The fastest config of the grid whose measured peak fits in device
        memory. Running out of memory makes a config infeasible; any other
        failure (a kernel that does not build or launch) propagates, so a
        broken kernel is never hidden behind another config."""
        if len(devices) != 1:
            return None, None  # multi-device blocks: a later item
        best: Tuple[Optional[Dict[str, Any]], Optional[float]] = (None, None)
        for config in self.candidate_configs(task, len(devices)):
            t = self._try_config(task, devices, config)
            if t is None:
                self.trials.append((task.name, len(devices), dict(config), None, "memory"))
                continue
            self.trials.append((task.name, len(devices), dict(config), t, "ok"))
            log.info("%s trial %s on task %s: %.6fs/batch", self.name, config,
                     task.name, t)
            if best[1] is None or t < best[1]:
                best = (dict(config), t)
        return best

    def _try_config(
        self, task: Any, devices: Sequence[Any], config: Dict[str, Any]
    ) -> Optional[float]:
        """Seconds per batch for one config; None = over device memory."""
        bundle = self.build(task, devices, config)
        dev = bundle.device
        timing.reset_peak_memory(dev)
        state = bundle.init()
        try:
            batch = bundle.stage(task.get_dataset().batch(0))
            t = timing.time_train_step(bundle.step, state, batch, n_timed=3, n_warmup=2)
            peak = timing.peak_memory_bytes(dev)
        except torch.cuda.OutOfMemoryError:
            log.info("%s: config %s ran out of device memory", self.name, config)
            return None
        finally:
            del state
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        limit = timing.device_memory_bytes(dev)
        if limit > 0 and peak > MEMORY_HEADROOM * limit:
            log.info("%s: config %s peaked at %.2f GiB of %.2f GiB — infeasible",
                     self.name, config, peak / 2**30, limit / 2**30)
            return None
        return t

    # --------------------------------------------------------------- execute
    def execute(
        self,
        task: Any,
        devices: Sequence[Any],
        tid: int,
        override_batch_count: Optional[int] = None,
    ) -> None:
        """Run one interval of ``n`` batches, one step per dispatch.

        Resumes from the task's checkpoint when there is one (the data
        cursor follows the restored step count), runs ``n`` steps from the
        cursor, reads the losses back once at the end (``task.last_losses``),
        notes the realized per-batch time of the steady-state steps (the
        first step is warm-up), and writes the full train state."""
        config = dict(task.selected_strategy.params or {})
        bundle = self.build(task, devices, config)
        if task.has_ckpt():
            state = ckpt.restore(task.ckpt_path, bundle.empty())
            task.current_batch = task.cursor_for_step(state["step"])
        else:
            state = bundle.init()

        n = int(task.total_batches if override_batch_count is None else override_batch_count)
        start = task.current_batch
        losses: List[torch.Tensor] = []
        t_all0 = t_steady = timeit.default_timer()
        for j in range(n):
            state, loss = bundle.step(state, bundle.stage(task.batch_at(start + j)))
            losses.append(loss)
            if j == 0 and n > 1:
                timing.synchronize(bundle.device)
                t_steady = timeit.default_timer()
        if losses:
            # one host readback per interval; it also drains the queue
            task.last_losses = torch.stack(losses).float().cpu().tolist()
            t_end = timeit.default_timer()
            per_batch = (t_end - t_steady) / (n - 1) if n > 1 else t_end - t_all0
            task.last_per_batch_s = per_batch
            task.note_realized_per_batch(per_batch)
            log.info("task %s [%s]: ran %d batches, loss %.4f, %.4fs/batch",
                     task.name, self.name, n, task.last_losses[-1], per_batch)
        ckpt.save(task.ckpt_path, state)
