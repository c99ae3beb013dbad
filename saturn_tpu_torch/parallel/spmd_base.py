"""SPMDTechnique: the shared machinery of data-parallel-style executors.

Counterpart of ``saturn_tpu/parallel/spmd_base.py``: the loss/grad/optimizer
scaffold around a model's forward pass (with the same routing to a model's
fused head+loss), the ``{params, opt_state, step}`` train state, the
autotune grid crossed with the attention variants, ``search`` (keep the
fastest config whose measured peak memory fits) and ``execute`` (one
interval: resume, run n steps, write the checkpoint, report the realized
per-batch time).

``execute`` runs an interval as the JAX package's ``interval_dispatches``
does, on one device: ``n // K`` K-step windows plus an ``n % K`` tail, each
batch staged on the device just before its unit (``stage_tokens``: pinned
host memory, a copy stream of its own), one loss readback per interval,
screened by the health sentinel before anything of the interval is
published (``_screen``), the train state kept on the device for the next
interval (``task._live_state``) and the checkpoint written in the
background (``checkpoint.save_async``). A
K-step window is the counterpart of the JAX package's ``lax.scan`` program:
on the card a CUDA graph of K train steps, captured once per (bundle, K) and
replayed with one host call; on the CPU the plain version, K eager steps.
The tail runs through a window of one step. Trials time the window that
``execute`` dispatches. The co-scheduled ``shared`` mode and multi-device
meshes are later items. The train step updates the model and the optimizer
in place (PyTorch's idiom; it keeps one copy of the state).
"""

from __future__ import annotations

import logging
import os
import threading
import timeit
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from saturn_tpu_torch.core.technique import BaseTechnique
from saturn_tpu_torch.health import sentinel
from saturn_tpu_torch.ops import launches
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics
from saturn_tpu_torch.utils import timing

log = logging.getLogger("saturn_tpu_torch")

#: Fraction of device memory a trial's measured peak may use.
MEMORY_HEADROOM = 0.92

# ------------------------------------------------------------ window policy
#: Default ceiling on the window K. K trades the per-step host dispatch and
#: loss readback against staged-batch memory ((K, B, T) tokens at once) and
#: progress granularity (a window is all-or-nothing).
DEFAULT_MAX_WINDOW = 8

_ENV_MAX_WINDOW = "SATURN_TPU_MAX_WINDOW"


def max_window() -> int:
    """Ceiling on the window K (env ``SATURN_TPU_MAX_WINDOW``, the JAX
    package's variable). ``<= 1`` runs every interval one step at a time."""
    try:
        k = int(os.environ.get(_ENV_MAX_WINDOW, DEFAULT_MAX_WINDOW))
    except ValueError:
        return DEFAULT_MAX_WINDOW
    return max(1, k)


#: A unit of an interval's plan: (kind, batch offset, batches). ``warm`` is
#: an eager step run before the state's first capture, ``window`` a window
#: of K steps or, in the tail, of one; ``step`` an eager step (K = 1).
Unit = Tuple[str, int, int]


def unit_plan(n: int, k: int, warm: bool) -> List[Unit]:
    """The interval's units: with K = 1, ``n`` eager steps; else ``n // K``
    windows of K and an ``n % K`` tail of one-step windows. With ``warm``
    (no window is captured on this state yet) the first unit is an eager
    step, and the windows and the tail share the other ``n - 1`` batches.
    Every batch runs once, in order."""
    if k <= 1:
        return [("step", j, 1) for j in range(n)]
    lead = 1 if warm and n else 0
    n_windows = (n - lead) // k
    units: List[Unit] = [("warm", 0, 1)] if lead else []
    units += [("window", lead + w * k, k) for w in range(n_windows)]
    units += [("window", j, 1) for j in range(lead + n_windows * k, n)]
    return units


# ----------------------------------------------------------------- staging
_STREAMS: Dict[Tuple[str, Any], Any] = {}
_STREAMS_LOCK = threading.Lock()


def _side_stream(role: str, device: torch.device):
    """The card's stream for one role, made at first use: ``copy`` stages
    batches; ``capture`` captures every window and runs the warm-up steps
    (so the libraries' per-stream state, such as cuBLAS's workspace, exists
    before a capture)."""
    with _STREAMS_LOCK:
        s = _STREAMS.get((role, device.index))
        if s is None:
            s = _STREAMS[role, device.index] = torch.cuda.Stream(device)
        return s


def stage_tokens(host, device) -> torch.Tensor:
    """A host int array (``(B, T)`` or ``(K, B, T)``) on ``device`` as int64
    token ids, ready for kernels on the current stream.

    On the card the array goes through pinned host memory and a
    ``non_blocking`` copy on the copy stream, so the copy runs beside the
    work already queued; the current stream waits on an event recorded
    after the copy, and ``record_stream`` keeps the caching allocator from
    reusing the tensor before that stream's kernels have read it. Nothing
    synchronizes the host. On the CPU it is the host array as a tensor."""
    device = torch.device(device)
    src = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return src.to(device, torch.long)
    pinned = torch.empty(src.shape, dtype=torch.long, pin_memory=True)
    pinned.copy_(src)
    copy = _side_stream("copy", device)
    with torch.cuda.stream(copy):
        out = torch.empty(src.shape, dtype=torch.long, device=device)
        out.copy_(pinned, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy)
    current = torch.cuda.current_stream(device)
    current.wait_event(done)
    out.record_stream(current)
    return out


# ----------------------------------------------------------------- windows
def _state_key(state: Dict[str, Any]) -> Tuple[int, ...]:
    """The addresses a captured step reads and writes: parameters, buffers
    and optimizer state. ``Optimizer.load_state_dict`` changes them."""
    model, opt = state["params"], state["opt_state"]
    ptrs = [id(model), id(opt)]
    ptrs += [t.data_ptr() for t in model.parameters()]
    ptrs += [t.data_ptr() for t in model.buffers()]
    for per_param in opt.state.values():
        ptrs += [v.data_ptr() for v in per_param.values() if isinstance(v, torch.Tensor)]
    return tuple(ptrs)


class _PlainWindow:
    """A window's plain version, for a state on the CPU: K eager steps."""

    def __init__(self, step: Callable, k: int):
        self.step, self.k = step, k

    def captured_on(self, state) -> bool:
        return True  # nothing to capture

    def __call__(self, state, window: torch.Tensor):
        losses = []
        for j in range(self.k):
            state, loss = self.step(state, window[j])
            losses.append(loss.reshape(()))
        return state, torch.stack(losses).float()

    def release(self) -> None:
        pass


class _GraphWindow:
    """K train steps (forward, backward, optimizer step, zero-grad) captured
    as one CUDA graph, replayed with one host call.

    Step j reads slice j of a static (K, B, T) buffer and writes its loss
    to slot j of a static (K,) buffer. Before each replay the staged window
    is copied into the static buffer on the current stream, after the
    previous replay has read it (a device copy of K·B·T int64). The graph is
    keyed to the addresses of the state it captured (``_state_key``): on
    any other state, or after a restore into this one, it is captured anew.
    Capture runs nothing, so the state's Python step count is put back
    after it; each replay advances it by K and adds the launches the
    kernel wrappers recorded during capture to their counts. A capture
    needs a state that has stepped (the optimizer makes its moments at its
    first step; capture may not allocate them lazily): ``execute`` runs an
    eager step first on a state no window of its bundle has captured."""

    def __init__(self, step: Callable, k: int, device: torch.device, pool):
        self.step, self.k, self.device, self.pool = step, k, device, pool
        self.graph = None
        self.key: Optional[Tuple[int, ...]] = None
        self.static: Optional[torch.Tensor] = None
        self.losses: Optional[torch.Tensor] = None
        self.recorded: list = []

    def captured_on(self, state) -> bool:
        return self.graph is not None and self.key == _state_key(state)

    def capture(self, state, shape) -> None:
        """Capture the K steps on ``state`` for windows of ``shape``."""
        self.release()
        self.static = torch.zeros(tuple(shape), dtype=torch.long, device=self.device)
        self.losses = torch.zeros(self.k, dtype=torch.float32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        stream = _side_stream("capture", self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        step0 = state["step"]
        try:
            # thread_local: the other tasks' threads may pin host memory or
            # allocate while this thread captures
            with launches.recording(stream.cuda_stream) as recorded:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    for j in range(self.k):
                        _, loss = self.step(state, self.static[j])
                        self.losses[j].copy_(loss.reshape(()))
        finally:
            state["step"] = step0
        self.graph, self.recorded, self.key = graph, recorded, _state_key(state)

    def __call__(self, state, window: torch.Tensor):
        if not self.captured_on(state):
            self.capture(state, window.shape)
        self.static.copy_(window)
        self.graph.replay()
        launches.replay(self.recorded)
        state["step"] += self.k
        return state, self.losses.clone()

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.key = self.static = self.losses = None
        self.recorded = []


@dataclass
class _Bundle:
    """Everything needed to run one (task, device, config) combination,
    built once per ``_bundle_key`` and kept until ``release_task``."""

    device: torch.device
    init: Callable[[], Dict[str, Any]]          # fresh state, seeded init
    empty: Callable[[], Dict[str, Any]]         # state to restore into
    step: Callable[[Dict[str, Any], torch.Tensor], Tuple[Dict[str, Any], torch.Tensor]]
    _windows: Dict[int, Any] = field(default_factory=dict)
    _pool: Any = None
    _lock: Any = field(default_factory=threading.Lock)

    def stage(self, host_batch) -> torch.Tensor:
        """A host (B, T) int batch on the device as int64 token ids, ready
        on the current stream."""
        return stage_tokens(host_batch, self.device)

    def warm_step(self, state, batch: torch.Tensor):
        """One eager train step before a capture: on the card it runs on the
        capture stream, ordered after and before the current stream's work."""
        if self.device.type != "cuda":
            return self.step(state, batch)
        stream = _side_stream("capture", self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            batch.record_stream(stream)
            state, loss = self.step(state, batch)
        current.wait_stream(stream)
        loss.record_stream(current)
        return state, loss

    def fused(self, k: int):
        """The K-step window program ``(state, window) -> (state, losses)``,
        made once per K: a CUDA graph on the card, K eager steps on the CPU
        (a rule by device type). The windows of a bundle share one graph
        memory pool: each is replayed alone and keeps no tensor in the pool
        between replays."""
        k = int(k)
        if k < 1:
            raise ValueError(f"a window needs k >= 1, got {k}")
        with self._lock:
            win = self._windows.get(k)
            if win is None:
                if self.device.type == "cuda":
                    if self._pool is None:
                        self._pool = torch.cuda.graph_pool_handle()
                    win = _GraphWindow(self.step, k, self.device, self._pool)
                else:
                    win = _PlainWindow(self.step, k)
                self._windows[k] = win
            return win

    def warmed(self, state) -> bool:
        """Whether a window may be captured on ``state`` without an eager
        step first: a window of this bundle is captured on it (on the CPU
        nothing is captured)."""
        if self.device.type != "cuda":
            return True
        with self._lock:
            wins = list(self._windows.values())
        return any(win.captured_on(state) for win in wins)

    def capture(self, sizes, state, shape) -> None:
        """Capture, on ``state``, every window of ``sizes`` not captured on
        it yet, for batches of ``shape`` (B, T)."""
        for k in sizes:
            win = self.fused(k)
            if not win.captured_on(state):
                win.capture(state, (k, *shape))

    def release_windows(self) -> None:
        """Free every window's graph and the graph memory pool."""
        with self._lock:
            wins, self._windows, self._pool = list(self._windows.values()), {}, None
        for win in wins:
            win.release()


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
        # Every interval this instance ran: its plan, whether it restored
        # the checkpoint, and its realized time (chip_smoke.py).
        self.intervals: List[Dict[str, Any]] = []
        self._bundles: Dict[Any, _Bundle] = {}
        self._bundles_lock = threading.Lock()
        self._eager_noted: set = set()

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
        checkpoint to fill. The step reads nothing back to the host, so a
        CUDA graph can capture it."""

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

    def _bundle_key(self, task: Any, devices: Sequence[Any], config: Dict[str, Any]):
        return (
            task.name,
            tuple(sorted(config.items())),
            tuple(str(d) for d in devices),
        )

    def build(self, task: Any, devices: Sequence[Any], config: Dict[str, Any]) -> _Bundle:
        """The bundle of (task, devices, config), built at its first use."""
        if len(devices) != 1:
            raise NotImplementedError(
                f"{self.name}: multi-device blocks are a later item of the "
                f"PyTorch port (got {len(devices)} devices)"
            )
        key = self._bundle_key(task, devices, config)
        with self._bundles_lock:
            hit = self._bundles.get(key)
        if hit is not None:
            return hit
        device = torch.device(devices[0])
        spec = task.get_model(**self._model_overrides(config))
        init_state, train_step = self.make_step_fns(
            spec, task, config, device, task.get_dataset()
        )
        bundle = _Bundle(
            device=device,
            init=init_state,
            empty=lambda: init_state(materialize=False),
            step=train_step,
        )
        with self._bundles_lock:
            return self._bundles.setdefault(key, bundle)

    def release_task(self, task_name: str) -> None:
        """Free a finished task's bundles, their CUDA graphs and graph
        memory pools."""
        with self._bundles_lock:
            keys = [k for k in self._bundles if k[0] == task_name]
            gone = [self._bundles.pop(k) for k in keys]
        for bundle in gone:
            bundle.release_windows()
            if bundle.device.type == "cuda":
                torch.cuda.empty_cache()

    # ---------------------------------------------------------------- windows
    def _fused_ok(self, task: Any) -> bool:
        """Whether the task may run K-step windows. A user's optimizer
        callable may not: whether its step can be captured cannot be
        checked, so such a task runs one step at a time (logged once)."""
        if callable(task.hparams.optimizer):
            if task.name not in self._eager_noted:
                self._eager_noted.add(task.name)
                log.info("%s: task %s has a user optimizer callable; its intervals "
                         "run one step at a time (K = 1)", self.name, task.name)
            return False
        return True

    def _window(self, task: Any, window_size: Optional[int] = None) -> int:
        """The K of the task's windows, in trials and in ``execute``:
        ``window_size`` if given, else ``max_window()``; 1 where
        ``_fused_ok`` says no."""
        k = max_window() if window_size is None else max(1, int(window_size))
        return k if k == 1 or self._fused_ok(task) else 1

    # ---------------------------------------------------------------- health
    def _screen(self, task: Any, losses: np.ndarray, units: List[Unit],
                start: int) -> Optional[np.ndarray]:
        """Fold the interval's per-step losses through the sentinel (the JAX
        package's ``spmd_base.py:1193-1282``, on the host): raise
        ``NumericFaultError`` naming the dataset indices of the bad steps,
        else return the advanced sentinel carry (None with the sentinel
        off), which ``execute`` keeps only if it publishes the interval."""
        cfg = sentinel.get_config()
        if not cfg.enabled:
            return None
        carry = task._sentinel_carry
        rep = sentinel.fold(sentinel.carry_init() if carry is None else carry, losses, cfg)
        fault = sentinel.inspect(rep)
        if fault is None:
            return rep[:2].copy()
        cause, first_off, bad_count = fault
        window = next(u for u, (_, off, size) in enumerate(units)
                      if off <= first_off < off + size)
        # blame the exact bad steps, not the whole window: a window's healthy
        # batches stay in the training sequence
        bad = {int(j) for j in np.flatnonzero(~np.isfinite(losses))}
        bad.add(int(first_off))
        batches = tuple(sorted({task.dataset_index(start + j) for j in bad}))
        metrics.event("task_numeric_fault", task=task.name, cause=cause, window=window,
                      step=first_off, bad_count=bad_count, batches=list(batches))
        log.warning("task %s: sentinel tripped (%s) at interval step %d (unit %d, "
                    "%d bad step(s)) — discarding the interval", task.name, cause,
                    first_off, window, bad_count)
        raise sentinel.NumericFaultError(
            task.name, window, cause, step=first_off,
            loss=float(rep[sentinel.REP_LAST_LOSS]), batch_indices=batches,
            bad_count=bad_count,
        )

    # ---------------------------------------------------------------- search
    def search(
        self, task: Any, devices: Sequence[Any], tid: int
    ) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """The fastest config of the grid whose measured peak fits in device
        memory. Running out of memory makes a config infeasible; any other
        failure (a kernel that does not build or launch, a capture that
        fails) propagates, so a broken kernel is never hidden behind
        another config."""
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
        """Seconds per batch of the program ``execute`` dispatches at steady
        state for one config; None = over device memory.

        With K > 1 (``_window``): one eager warm-up step, then the
        K-step window through ``timing.time_fused_window`` (its warm-up
        call captures the graph), every window stack staged before the
        timed region. The peak memory is taken over the same program, the
        graph's pool included; the trial's graph and pool are freed after.
        With K = 1: single steps through ``timing.time_train_step``."""
        bundle = self.build(task, devices, config)
        dev = bundle.device
        k = self._window(task)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        timing.reset_peak_memory(dev)
        state = bundle.init()
        try:
            if k > 1:
                state, _ = bundle.warm_step(state, bundle.stage(task.batch_at(0)))

                def stage(j: int) -> torch.Tensor:
                    return stage_tokens(
                        np.stack([task.batch_at(1 + j * k + i) for i in range(k)]), dev)

                t = timing.time_fused_window(bundle.fused(k), state, stage, k,
                                             n_timed=2, n_warmup=1)
            else:
                batch = bundle.stage(task.batch_at(0))
                t = timing.time_train_step(bundle.step, state, batch, n_timed=3, n_warmup=2)
            peak = timing.peak_memory_bytes(dev)
        except torch.cuda.OutOfMemoryError:
            log.info("%s: config %s ran out of device memory", self.name, config)
            return None
        finally:
            del state
            bundle.release_windows()
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
        window_size: Optional[int] = None,
    ) -> None:
        """Run one interval of ``n`` batches (the JAX package's
        ``interval_dispatches`` on one device, without its ``shared`` mode).

        The state is the task's live state when the previous interval ran
        this bundle, else the checkpoint (the data cursor follows its step
        count), else a fresh init; the live state is dropped before the
        first dispatch, so an interval that fails leaves none. K is
        ``_window(task, window_size)`` for every n: unlike the JAX
        package's ``choose_window``, a budget under K does not shrink K, since
        a new K would cost a capture; the tail and a short interval run
        through the one-step window instead (``unit_plan``). On a state that
        no window of the bundle has captured, the first unit is an eager
        step; every capture the plan needs follows the first unit's staging,
        before the clock of the realized time starts. Each unit's batch is
        staged just before it, while the device runs the previous one. The
        losses are read back once (``task.last_losses``); the realized
        per-batch time counts the batches after the first unit. The sentinel
        screens the read-back losses first (``_screen``): a non-finite loss
        raises ``NumericFaultError`` before anything is published. A launch
        the engine's watchdog abandoned (``task._abandoned`` set) publishes
        nothing. Otherwise the interval ends with ``checkpoint.save_async``
        and the state kept live."""
        # set by the engine's watchdog when it abandons this launch
        abandoned = getattr(task, "_abandoned", None)
        config = dict(task.selected_strategy.params or {})
        bundle = self.build(task, devices, config)
        key = self._bundle_key(task, devices, config)

        t_begin = timeit.default_timer()
        restored = False
        # no local keeps the live state: a failed interval's traceback
        # must not hold a train state's memory
        if task._live_state is not None and task._live_state[0] == key:
            state = task._live_state[1]
        elif task.has_ckpt():
            state = ckpt.restore(task.ckpt_path, bundle.empty())
            task.current_batch = task.cursor_for_step(state["step"])
            restored = True
        else:
            state = bundle.init()
        task._live_state = None

        n = int(task.total_batches if override_batch_count is None else override_batch_count)
        k = self._window(task, window_size)
        units = unit_plan(n, k, warm=k > 1 and not bundle.warmed(state))
        sizes = sorted({size for kind, _, size in units if kind == "window"}, reverse=True)
        start = task.current_batch

        def stage(kind: str, off: int, size: int) -> torch.Tensor:
            if kind == "window":
                host = np.stack([task.batch_at(start + off + j) for j in range(size)])
            else:
                host = task.batch_at(start + off)
            return stage_tokens(host, bundle.device)

        unit_losses: List[torch.Tensor] = []
        capture_s = None
        t_all0 = t_steady = timeit.default_timer()
        state_s = t_all0 - t_begin
        for u, (kind, off, size) in enumerate(units):
            batch = stage(kind, off, size)
            if kind == "warm":
                state, loss = bundle.warm_step(state, batch)
            if u == 0 and sizes:
                t0 = timeit.default_timer()
                bundle.capture(sizes, state, batch.shape[-2:])
                capture_s = timeit.default_timer() - t0
            if kind == "window":
                state, loss = bundle.fused(size)(state, batch)
            elif kind == "step":
                state, loss = bundle.step(state, batch)
            unit_losses.append(loss.reshape(-1))
            if u == 0 and len(units) > 1:
                # the first unit pays one-time costs (and the captures):
                # keep it out of the realized time
                timing.synchronize(bundle.device)
                t_steady = timeit.default_timer()

        n_windows = sum(kind == "window" and size == k for kind, _, size in units)
        warm = bool(units) and units[0][0] == "warm"
        record = {"task": task.name, "config": config, "n": n, "k": k,
                  "windows": n_windows, "tail": n - int(warm) - n_windows * k,
                  "warm": warm, "capture_s": capture_s,
                  "restored": restored, "per_batch_s": None,
                  # host seconds: getting the state (live, restore or
                  # init), the units up to the loss readback, the
                  # checkpoint's host copy (and the wait for the path's
                  # previous write)
                  "state_s": state_s, "run_s": None, "save_s": None}
        losses = carry = None
        if unit_losses:
            # one host readback per interval; it also drains the queue
            losses = torch.cat(unit_losses).float().cpu().numpy()
            t_end = timeit.default_timer()
            # the sentinel screens every step's loss before anything of the
            # interval is published: a fault drops the state, so the retry
            # restores from the last checkpoint (and captures anew)
            try:
                carry = self._screen(task, losses, units, start)
            except sentinel.NumericFaultError:
                state = None
                raise
        if abandoned is not None and abandoned.is_set():
            # the engine's watchdog gave up on this launch: a late finish
            # publishes nothing (the retry restores the last checkpoint)
            log.warning("task %s: interval finished after the watchdog abandoned "
                        "it; discarding it", task.name)
            return
        if carry is not None:
            task._sentinel_carry = carry
        if losses is not None:
            task.last_losses = losses.tolist()
            if len(units) > 1:
                per_batch = (t_end - t_steady) / max(n - units[0][2], 1)
            else:
                per_batch = (t_end - t_all0) / max(n, 1)
            task.last_per_batch_s = per_batch
            task.note_realized_per_batch(per_batch)
            record["per_batch_s"] = per_batch
            log.info("task %s [%s]: ran %d batches (K=%d, %d windows, tail %d%s%s), "
                     "loss %.4f, %.4fs/batch", task.name, self.name, n, k, n_windows,
                     record["tail"], ", eager warm-up step" if warm else "",
                     ", restored from the checkpoint" if restored else "",
                     task.last_losses[-1], per_batch)
        t_save = timeit.default_timer()
        record["run_s"] = t_save - t_all0
        ckpt.save_async(task.ckpt_path, state)
        record["save_s"] = timeit.default_timer() - t_save
        self.intervals.append(record)
        task._live_state = (key, state)
