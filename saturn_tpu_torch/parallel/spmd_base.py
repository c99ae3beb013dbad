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
``execute`` dispatches. ``execute`` drains ``interval_dispatches``, a
generator of the unit dispatches that the engine's co-schedule launcher
interleaves with another task's (``shared`` mode). The train step updates
the model and the optimizer in place (PyTorch's idiom; it keeps one copy of
the state).

A block of n positions holds n model replicas, one per position, all driven
by the thread that runs the block (``replicated_step_fns``): the JAX
package's dp over a ``data`` axis of n devices, as one process rather than
one per rank. Replica r takes rows ``[r·B/n, (r+1)·B/n)`` of the batch (the
contiguous split of JAX's ``data`` sharding), the replicas' gradients are
summed in place by the block's reducer (``parallel/collectives.py``: NCCL
across distinct cards, one on-device sum where positions share a card), and
each replica steps its own optimizer on the same sums, so the replicas stay
bitwise equal. Positions may name one device more than once (``[cuda:0,
cuda:0]``): such a block rehearses the multi-device step on one card, with
K-step CUDA-graph windows as on one device. A block over distinct cards runs
one step at a time (K = 1, ``_fused_ok``).

A technique that shards its state (``shards_state``: fsdp) holds the train
state in pieces instead (``sharded_step_fns``): each position steps its
optimizer on its extent of every leaf under ``param_rules``, gathers the
full parameters for its forward and reduce-scatters the gradients. Such a
state carries its ``placement`` (the specs and the mesh), by which the
checkpoint writes and restores it (a state without one is replicated over
its positions); ``full_params`` reads a sharded state's parameters whole.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import timeit
import traceback
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


def stage_async(host, device) -> Tuple[torch.Tensor, Any]:
    """Start staging a host int array (``(B, T)`` or ``(K, B, T)``) on
    ``device`` as int64 token ids: ``(tensor, event)``, where the event
    (None on the CPU, where the tensor is ready) completes with the copy.

    On the card the array goes through pinned host memory and a
    ``non_blocking`` copy on the copy stream, so the copy runs beside the
    work already queued. ``ready`` makes a stream wait for it."""
    device = torch.device(device)
    src = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return src.to(device, torch.long), None
    pinned = torch.empty(src.shape, dtype=torch.long, pin_memory=True)
    pinned.copy_(src)
    copy = _side_stream("copy", device)
    with torch.cuda.stream(copy):
        out = torch.empty(src.shape, dtype=torch.long, device=device)
        out.copy_(pinned, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy)
    return out, done


def ready(staged: torch.Tensor, done: Any) -> torch.Tensor:
    """A staged tensor ready for kernels on the current stream: the stream
    waits on the copy's event, and ``record_stream`` keeps the caching
    allocator from reusing the tensor before that stream's kernels have
    read it. Nothing synchronizes the host."""
    if done is None:
        return staged
    current = torch.cuda.current_stream(staged.device)
    current.wait_event(done)
    staged.record_stream(current)
    return staged


def stage_tokens(host, device) -> torch.Tensor:
    """A host int array (``(B, T)`` or ``(K, B, T)``) on ``device`` as int64
    token ids, ready for kernels on the current stream (``stage_async``
    then ``ready``). On the CPU it is the host array as a tensor."""
    return ready(*stage_async(host, device))


def observed_losses(losses: np.ndarray, poison: Optional[dict],
                    dataset_index_of: Callable[[int], int]) -> np.ndarray:
    """The loss vector the sentinel observes: ``losses``, or a copy with a
    fault injector's overrides (``sentinel.poison_overrides``) in place."""
    ov = sentinel.poison_overrides(poison, len(losses), dataset_index_of) if poison else None
    if ov is None:
        return losses
    out = np.array(losses, dtype=np.float32)
    out[ov[0]] = ov[1]
    return out


def host_fraction(t_host: float, t_device: float) -> float:
    """Fraction of one steady-state batch spent staging it on the host: the
    staging seconds against staging plus the device's per-batch time (the
    JAX package's ``_host_fraction``). Above 0.5 a job is stage-bound, and
    a compute-bound neighbour's windows can fill its device's idle time."""
    t_host, t_device = max(0.0, float(t_host)), max(0.0, float(t_device))
    total = t_host + t_device
    return 0.0 if total <= 0.0 else t_host / total


# ----------------------------------------------------------------- windows
def replicas(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The replicas of a train state, replica 0 first: ``state["replicas"]``
    for a block of several positions, else the state itself."""
    return state.get("replicas") or [state]


def full_params(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state's parameters by name, whole, on the first position's
    device: a replicated state's are its model's; a sharded state's are
    assembled from every position's shard (fsdp's models hold the gathered
    parameters of the last step's forward, before that step's update;
    tp's only their extents, the placement's ``layout`` the whole
    shapes)."""
    reps = replicas(state)
    shards = [rep.get("shards") or {} for rep in reps]
    model = reps[0]["params"]
    out = {name: p.detach() for name, p in model.named_parameters()}
    if not any(shards):
        return out
    from saturn_tpu_torch.models import convert
    from saturn_tpu_torch.parallel import sharding

    pl = state["placement"]
    layout = pl.get("layout") or convert.state_layout(model, reps[0]["opt_state"])
    for leaf in layout:
        if leaf.kind != "param" or not any(n in shards[0] for n in leaf.names):
            continue
        exts = sharding.extents(tuple(pl["specs"].get(leaf.key, ())), leaf.shape,
                                pl["mesh_axes"])
        for j, name in enumerate(leaf.names):
            full = out[name].new_empty(leaf.port_shape)
            for r, e in enumerate(exts):
                pe = leaf.port_extent(e, j)
                if pe is not None:
                    full[tuple(slice(a, b) for a, b in pe)] = shards[r][name].detach().to(
                        full.device)
            out[name] = full
    return out


def _state_key(state: Dict[str, Any]) -> Tuple[int, ...]:
    """The addresses a captured step reads and writes: every replica's
    parameters, buffers, gradient buffer, shards and optimizer state.
    ``Optimizer.load_state_dict`` changes them."""
    ptrs: List[int] = []
    for rep in replicas(state):
        model, opt = rep["params"], rep["opt_state"]
        ptrs += [id(model), id(opt)]
        ptrs += [t.data_ptr() for t in model.parameters()]
        ptrs += [t.data_ptr() for t in model.buffers()]
        if rep.get("grads") is not None:
            ptrs.append(rep["grads"].data_ptr())
        for shard in (rep.get("shards") or {}).values():
            ptrs.append(shard.data_ptr())
            if shard.grad is not None:
                ptrs.append(shard.grad.data_ptr())
        for per_param in opt.state.values():
            ptrs += [v.data_ptr() for v in per_param.values() if isinstance(v, torch.Tensor)]
    return tuple(ptrs)


class _PlainWindow:
    """A window's plain version, for a state on the CPU: K eager steps."""

    def __init__(self, step: Callable, k: int, loss_shape: Tuple[int, ...] = ()):
        self.step, self.k, self.loss_shape = step, k, tuple(loss_shape)

    def captured_on(self, state) -> bool:
        return True  # nothing to capture

    def capture(self, state, shape) -> None:
        pass

    def __call__(self, state, window: torch.Tensor):
        losses = []
        for j in range(self.k):
            state, loss = self.step(state, window[j])
            losses.append(loss.reshape(self.loss_shape))
        return state, torch.stack(losses).float()

    def release(self) -> None:
        pass


class _GraphWindow:
    """K train steps (forward, backward, optimizer step, zero-grad) captured
    as one CUDA graph, replayed with one host call.

    Step j reads slice j of a static (K, B, T) buffer (a fused stack's
    (K, M, B, T)) and writes its loss to slot j of a static (K,) buffer
    ((K, M) for a stack's per-member losses, ``loss_shape``). Before each
    replay the staged window is copied into the static buffer on the
    current stream, after the
    previous replay has read it (a device copy of K·B·T int64). The graph is
    keyed to the addresses of the state it captured (``_state_key``): on
    any other state, or after a restore into this one, it is captured anew.
    Capture runs nothing, so the state's Python step count is put back
    after it; each replay advances it by K and adds the launches the
    kernel wrappers recorded during capture to their counts. A capture
    needs a state that has stepped (the optimizer makes its moments at its
    first step; capture may not allocate them lazily): ``execute`` runs an
    eager step first on a state no window of its bundle has captured."""

    def __init__(self, step: Callable, k: int, device: torch.device, pool,
                 loss_shape: Tuple[int, ...] = ()):
        self.step, self.k, self.device, self.pool = step, k, device, pool
        self.loss_shape = tuple(loss_shape)
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
        self.losses = torch.zeros((self.k, *self.loss_shape), dtype=torch.float32,
                                  device=self.device)
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
                        self.losses[j].copy_(loss.reshape(self.loss_shape))
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


def _config_key(config: Dict[str, Any]) -> Tuple:
    return tuple(sorted(config.items()))


@dataclass
class _Bundle:
    """Everything needed to run one (task, devices, config) combination,
    built once per ``_bundle_key`` and kept until ``release_task``.
    ``device`` is the block's first position's device, where batches are
    staged, windows captured and losses read back; ``devices`` every
    position's."""

    device: torch.device
    init: Callable[[], Dict[str, Any]]          # fresh state, seeded init
    empty: Callable[[], Dict[str, Any]]         # state to restore into
    step: Callable[[Dict[str, Any], torch.Tensor], Tuple[Dict[str, Any], torch.Tensor]]
    # shape of one step's loss: () solo, (M,) for a fused stack of M
    loss_shape: Tuple[int, ...] = ()
    devices: Tuple[torch.device, ...] = ()
    _windows: Dict[int, Any] = field(default_factory=dict)
    _pool: Any = None
    _lock: Any = field(default_factory=threading.Lock)

    def __post_init__(self) -> None:
        if not self.devices:
            self.devices = (self.device,)

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
                    win = _GraphWindow(self.step, k, self.device, self._pool,
                                       self.loss_shape)
                else:
                    win = _PlainWindow(self.step, k, self.loss_shape)
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


# ------------------------------------------------------- a block's replicas
def _device_of(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _flat_grads(name: str, model, device) -> torch.Tensor:
    """One zeroed gradient buffer for all of ``model``'s parameters, each
    parameter's ``.grad`` a view of it (one collective a step, not one per
    parameter)."""
    params = list(model.parameters())
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise NotImplementedError(
            f"{name}: a block keeps one gradient buffer of one dtype; the model's "
            f"parameters have {sorted(map(str, dtypes))}")
    flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype, device=device)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat


def _replica_models(spec, devices: Sequence[torch.device], materialize: bool) -> list:
    """One model per position: the first drawn from the generator seeded 0
    (or allocated uninitialised), the others copies of it, so every replica
    starts bitwise equal."""
    dev0 = devices[0]
    if materialize:
        first = spec.init_fn(torch.Generator().manual_seed(0), dev0)
    else:
        first = spec.abstract_init().to_empty(device=dev0)
    models = [first]
    for dev in devices[1:]:
        model = spec.abstract_init().to_empty(device=dev)
        if materialize:
            model.load_state_dict(first.state_dict())
        models.append(model)
    return models


def _chunks(batch: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """Rows ``[r·B/n, (r+1)·B/n)`` of the batch for position r, on its
    device."""
    n = len(devices)
    rows = batch.shape[0] // n
    chunks = [batch[r * rows:(r + 1) * rows] for r in range(n)]
    return [c if c.device == dev else c.to(dev, non_blocking=True)
            for c, dev in zip(chunks, devices)]


def _block_loss_backward(spec, loss_fn, models, chunks, devices, batch, parts_fn, reducer):
    """The forward and backward of a block's replicas (each model on its
    rows), the gradients left in each model's ``.grad``; the loss, detached.

    With ``parts_fn`` (the fused head's ``(loss_sum, valid_count)``) each
    replica's parts are summed by the reducer and each replica
    back-propagates its own sum over the global count. Without, the
    replicas' logits are concatenated on the first device, the loss runs
    once over the whole batch (exact for any loss), and autograd carries
    each replica's share back through the concatenation."""
    dev0 = devices[0]
    if parts_fn is not None:
        parts = []
        for model, chunk, dev in zip(models, chunks, devices):
            with _device_of(dev):
                parts.append(parts_fn(model, chunk))
        sums = reducer.sum_parts(parts)
        for (s_r, _), total, dev in zip(parts, sums, devices):
            with _device_of(dev):
                (s_r / total[1].clamp_min(1.0)).backward()
        return (sums[0][0] / sums[0][1].clamp_min(1.0)).detach()
    logits = []
    for model, chunk, dev in zip(models, chunks, devices):
        with _device_of(dev):
            logits.append(spec.apply_fn(model, chunk).to(dev0))
    loss = loss_fn(torch.cat(logits), batch)
    loss.backward()
    return loss.detach()


def _join_devices(reducer, devices: Sequence[torch.device]) -> None:
    """Over distinct devices, make the first device's stream wait for the
    others' work, so a synchronize of the first covers the whole step."""
    if reducer.distinct:
        dev0 = devices[0]
        current = torch.cuda.current_stream(dev0)
        for dev in {d for d in devices if d != dev0}:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            current.wait_event(done)


def _sizes(ext) -> Tuple[int, ...]:
    return tuple(b - a for a, b in ext)


def _slices(ext) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in ext)


def _spec_axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is not None:
            out.update(entry if isinstance(entry, (tuple, list)) else (entry,))
    return out


def _without_axis(spec, axis: str) -> Tuple[Any, ...]:
    """``spec`` with ``axis`` taken out of every entry."""
    out = []
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            rest = tuple(a for a in entry if a != axis)
            entry = None if not rest else rest[0] if len(rest) == 1 else rest
        elif entry == axis:
            entry = None
        out.append(entry)
    return tuple(out)


def _shaped_model(spec, shapes: Dict[str, Tuple[int, ...]], device) -> Any:
    """The spec's model with every parameter an uninitialised tensor on
    ``device``, of ``shapes[name]`` where given, else its own shape."""
    model = spec.abstract_init()
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            setattr(mod, pname, torch.nn.Parameter(torch.empty(
                shapes.get(name, tuple(p.shape)), dtype=p.dtype, device=device)))
    return model


@dataclass
class _TPPlan:
    """The placement of a tp state (``SPMDTechnique._tp_plan``): per
    parameter name, every position's stored and compute extent and its
    kind."""

    mesh_axes: Dict[str, int]
    placement: Dict[str, Any]
    kinds: Dict[str, str] = field(default_factory=dict)
    stored: Dict[str, List[Any]] = field(default_factory=dict)
    compute: Dict[str, List[Any]] = field(default_factory=dict)
    # held whole over 'model' but computed in parts: summed over the group
    partial: List[str] = field(default_factory=list)

    def names(self, kind: str) -> List[str]:
        return [name for name, k in self.kinds.items() if k == kind]

    def shapes(self, r: int) -> Dict[str, Tuple[int, ...]]:
        """Position r's compute shapes of the parameters it does not hold
        whole."""
        return {name: _sizes(self.compute[name][r]) for name, k in self.kinds.items()
                if k in ("split", "data")}

    def relative(self, name: str, r: int):
        """Position r's stored extent inside its compute extent."""
        return tuple((a - c, b - c) for (a, b), (c, _) in zip(self.stored[name][r],
                                                             self.compute[name][r]))


class SPMDTechnique(BaseTechnique):
    """Base for techniques expressible as a placement of one train step."""

    name = "spmd"

    # Whether standard-loss tasks may route through the model's fused
    # head+loss (``ModelSpec.fused_loss_fn``).
    fused_loss_ok = True

    # Whether the fused head may run on a block of several replicas (each
    # replica's ``(loss_sum, valid_count)`` parts summed before the divide):
    # a purely batch-splitting technique with replicated parameters (dp)
    fused_loss_shardable = False

    # Whether the train state lives in host memory (offload): it then runs
    # one eager step at a time (``_fused_ok``), is written without a host
    # copy, and is not screened against device memory (``_static_screen``).
    host_state = False

    # (warm-up, timed) steps of a one-step trial (``_try_config`` at K = 1)
    trial_steps = (2, 3)

    # Whether a block of several positions may run this technique as one
    # replica per position (``replicated_step_fns``); offload keeps one device
    replicates = True

    # Whether a block of several positions shards the train state by
    # ``param_rules`` (``sharded_step_fns``, fsdp) rather than replicating it
    shards_state = False

    # Whether a block of several positions splits each layer's compute over
    # a ``model`` axis (``tp_step_fns``, tp) rather than running whole
    # models; its ``overlap`` configs run ``sharded_step_fns``
    splits_compute = False

    # Per-device memory never grows with the block size: each replica takes
    # a smaller share of the batch. The trial runner prunes the sizes below
    # one that ran out of memory only where no two positions share a device
    # (there a block's replicas add up on one card).
    memory_monotone = True

    def __init__(self) -> None:
        # Every trial this instance ran: (task, size, config, seconds per
        # batch or None, outcome), for reports of the sweep (chip_smoke.py).
        self.trials: List[Tuple[str, int, Dict[str, Any], Optional[float], str]] = []
        # Every interval this instance ran and published: its plan, whether
        # it restored the checkpoint, its first loss and its realized time
        # (chip_smoke.py);
        # and every interval it ran and then discarded, the same record with
        # ``discarded`` naming why ("numeric", "abandoned", "preempted")
        self.intervals: List[Dict[str, Any]] = []
        self.discarded: List[Dict[str, Any]] = []
        self._bundles: Dict[Any, _Bundle] = {}
        self._bundles_lock = threading.Lock()
        self._eager_noted: set = set()
        # what the trial of each (task, config) measured beside its time:
        # the host fraction and the peak device memory
        self._trial_extra: Dict[Any, Dict[str, float]] = {}
        # the winning config's measurements of each (task, size) search,
        # popped by the trial runner (``trial_report``), and why an
        # infeasible one found none (``search_report``)
        self._reports: Dict[Any, Dict[str, float]] = {}
        self._search_reports: Dict[Any, Dict[str, Any]] = {}

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

    def replicated_step_fns(
        self, spec: Any, task: Any, devices: Sequence[torch.device],
    ) -> Tuple[Any, Any]:
        """(init_state, train_step) of a block of n positions, one model
        replica per position (the JAX package's dp over a ``data`` axis of
        n devices, ``spmd_base.py:463-512``).

        The state is replica 0's ``{params, opt_state, step}`` (what a
        checkpoint holds) plus ``replicas``: every replica's model,
        optimizer and flat gradient buffer (each parameter's ``.grad`` is a
        view of it; the step zeroes it, where the one-device step sets the
        gradients to None). ``init_state()`` draws replica 0 from the
        generator seeded 0 and copies it into the others, so they start
        bitwise equal.

        The step gives replica r rows ``[r·B/n, (r+1)·B/n)`` of the batch
        (staged on the first position's device, copied to the others'),
        sums the replicas' gradients with the block's reducer
        (``collectives.BlockReducer``) and steps every replica's optimizer
        on the same sums. The loss routes as the JAX package's does:

        - through the model's fused head where the one-device rule takes
          it and the model offers ``fused_loss_parts_fn`` (dp's
          ``fused_loss_shardable``): each replica computes its
          ``(loss_sum, valid_count)``, the reducer sums both, and each
          replica back-propagates its own sum over the global count, so
          uneven counts weigh as over the whole batch;
        - else over the logits: the replicas' logits are concatenated on
          the first position's device, the task's ``loss_fn`` runs once
          over the whole batch (exact for any loss, as GSPMD evaluates it),
          and autograd carries each replica's share back through the
          concatenation, across devices. This holds the whole batch's
          logits and their gradient on the first device at once, as the
          one-device step at the full batch does.

        The step reads nothing back to the host; over distinct devices the
        first device's stream waits for the others' work at its end, so a
        synchronize of the first device covers the whole step."""
        from saturn_tpu_torch.parallel.collectives import BlockReducer

        if spec.apply_with_aux_fn is not None:
            raise NotImplementedError(
                f"{self.name}: auxiliary-loss models are a later item of the PyTorch port"
            )
        devices = [torch.device(d) for d in devices]
        reducer = BlockReducer(devices)
        loss_fn = task.loss_fn
        parts_fn = getattr(spec, "fused_loss_parts_fn", None)
        tag = getattr(loss_fn, "supports_fused_head", None)
        fused = (parts_fn is not None and self.fused_loss_ok and self.fused_loss_shardable
                 and tag is not None and tag == getattr(spec, "fused_loss_objective", None))

        def replica(model, device) -> Dict[str, Any]:
            return {"params": model,
                    "opt_state": task.hparams.make_optimizer(model.parameters()),
                    "grads": _flat_grads(self.name, model, device)}

        def init_state(materialize: bool = True) -> Dict[str, Any]:
            reps = [replica(model, dev)
                    for model, dev in zip(_replica_models(spec, devices, materialize), devices)]
            return {"params": reps[0]["params"], "opt_state": reps[0]["opt_state"], "step": 0,
                    "replicas": reps}

        def train_step(state, batch):
            reps = state["replicas"]
            chunks = _chunks(batch, devices)
            loss = _block_loss_backward(spec, loss_fn, [rep["params"] for rep in reps], chunks,
                                        devices, batch, parts_fn if fused else None, reducer)
            reducer.all_reduce_([rep["grads"] for rep in reps])
            for rep, dev in zip(reps, devices):
                with _device_of(dev):
                    rep["opt_state"].step()
                    rep["grads"].zero_()
            _join_devices(reducer, devices)
            state["step"] += 1
            return state, loss

        return init_state, train_step

    def sharded_step_fns(
        self, spec: Any, task: Any, devices: Sequence[torch.device], config: Dict[str, Any],
    ) -> Tuple[Any, Any]:
        """(init_state, train_step) of a block of n positions whose train
        state is sharded by ``param_rules`` over the ``mesh_spec`` mesh
        (fsdp: the JAX package's GSPMD step over a ``data`` axis of n
        devices, and its ZeRO-3 program; tp's ``overlap`` configs: the
        ZeRO-3 program over ``(data, model)``, the block leaves split over
        ``model`` and repeated over ``data``, each holder reducing over
        every position and keeping its extent).

        The rule is applied to each leaf's JAX path and JAX shape
        (``models/convert.state_layout``), then read onto the port's
        per-layer tensors: position r holds the extent r of each leaf
        (``parallel/sharding.extent``) of the fp32 parameters and of the
        optimizer's moments, in ``shards`` by parameter name (a leaf the
        rule keeps whole is the model's own parameter, as in dp), and steps
        an optimizer over them. Every position also holds a full model, the
        gather buffer its forward and backward run on, with one flat
        gradient buffer. The state is position 0's model and optimizer,
        ``replicas`` and ``placement`` (the specs and the mesh), which the
        checkpoint writes and restores by.

        The step gathers the full parameters into every replica
        (``BlockReducer.all_gather``), runs replica r on rows ``[r·B/n,
        (r+1)·B/n)``, reduces the gradients (sharded leaves
        reduce-scattered to their owners, the others all-reduced) and steps
        each position's optimizer on its shards only. On a shared device
        the sums are one sum of the flat buffers in position order, as dp's,
        then sliced: the same sums, held in pieces. The loss routes over
        the logits as dp's does without the fused head (fsdp's
        ``fused_loss_shardable`` is False, the JAX package's rule for a
        block of n > 1). With ``config["overlap"]`` the step is the ZeRO-3
        program (``ops/collective_matmul.zero3_loss_and_grads``): each
        replica runs the model's pipeline hints layer by layer, gathering
        layer k+1 under layer k (``prefetch``, on a side stream of each
        card) or layer k on the critical path, each replica's loss its
        rows' mean, the gradients' sums divided by n."""
        from saturn_tpu_torch.ops.collective_matmul import zero3_loss_and_grads
        from saturn_tpu_torch.parallel import sharding
        from saturn_tpu_torch.parallel.collectives import BlockReducer

        devices = [torch.device(d) for d in devices]
        n = len(devices)
        reducer = BlockReducer(devices)
        loss_fn = task.loss_fn
        zero3 = bool(config.get("overlap"))
        prefetch = bool(getattr(self, "prefetch", True))
        meta = spec.abstract_init()
        shapes = {name: tuple(p.shape) for name, p in meta.named_parameters()}
        mesh_axes, layout, specs = self._placed_layout(spec, task, config, n, meta)
        params = [leaf for leaf in layout if leaf.kind == "param"]
        # name -> every position's port extent (None: holds none) of the
        # parameters some position holds only part of
        exts: Dict[str, List[Any]] = {}
        layer_of: Dict[str, Optional[int]] = {}
        for leaf in params:
            per_pos = sharding.extents(specs[leaf.key], leaf.shape, mesh_axes)
            for j, name in enumerate(leaf.names):
                pe = [leaf.port_extent(e, j) for e in per_pos]
                if any(e != tuple((0, d) for d in shapes[name]) for e in pe):
                    exts[name] = pe
                    layer_of[name] = j if leaf.stacked else None
        placement = {"specs": specs, "mesh_axes": mesh_axes}
        hints = spec.hints.get("pipeline") if zero3 else None
        if zero3 and hints is None:
            raise ValueError(f"{self.name}: overlap needs the model's pipeline hints")
        block_key = spec.hints.get("block_param_key", "blocks")
        n_layers = int(spec.hints.get("n_layers", 0)) if zero3 else 0
        by_layer: Dict[Optional[int], List[str]] = {}
        for name, k in layer_of.items():
            by_layer.setdefault(k if zero3 else None, []).append(name)

        def replica(r: int, model, device, materialize: bool) -> Dict[str, Any]:
            """Position r: its model (the gather buffer) with a flat
            gradient buffer, its shards (each with a gradient buffer of its
            own) and an optimizer over the shards and the whole leaves."""
            grads = _flat_grads(self.name, model, device)
            shards: Dict[str, torch.Tensor] = {}
            for name, p in model.named_parameters():
                if name not in exts:
                    continue
                e = exts[name][r]
                if e is None:
                    shards[name] = torch.empty((0,), dtype=p.dtype, device=device)
                    continue
                block = p.detach()[tuple(slice(a, b) for a, b in e)]
                shard = block.clone(memory_format=torch.contiguous_format) if materialize \
                    else torch.empty(block.shape, dtype=p.dtype, device=device)
                shard.grad = torch.zeros_like(shard)
                shards[name] = shard
            stepped = [shards.get(name, p) for name, p in model.named_parameters()]
            return {"params": model, "opt_state": task.hparams.make_optimizer(stepped),
                    "grads": grads, "shards": shards}

        def init_state(materialize: bool = True) -> Dict[str, Any]:
            models = _replica_models(spec, devices, materialize)
            reps = [replica(r, model, dev, materialize)
                    for r, (model, dev) in enumerate(zip(models, devices))]
            return {"params": reps[0]["params"], "opt_state": reps[0]["opt_state"], "step": 0,
                    "replicas": reps, "placement": placement}

        def named(rep):
            return dict(rep["params"].named_parameters())

        def gather(reps, names) -> None:
            with torch.no_grad():
                models = [named(rep) for rep in reps]
                for name in names:
                    reducer.all_gather([rep["shards"][name] for rep in reps],
                                       [m[name] for m in models], exts[name])

        def reduce(reps) -> None:
            models = [named(rep) for rep in reps]
            if not reducer.distinct:
                reducer.sum_to_leads_([rep["grads"] for rep in reps])
                lead = models[0]
                for name, p in lead.items():
                    if name in exts:
                        reducer.scatter_from_lead(
                            p.grad, [rep["shards"][name].grad for rep in reps], exts[name])
                    else:
                        for m in models[1:]:
                            m[name].grad.copy_(p.grad)
            else:
                for name in models[0]:
                    grads = [m[name].grad for m in models]
                    if name in exts:
                        reducer.reduce_scatter(grads, [rep["shards"][name].grad for rep in reps],
                                               exts[name])
                    else:
                        reducer.all_reduce_(grads)
            if zero3 and n > 1:
                for rep in reps:
                    with _device_of(rep["grads"].device):
                        grads = [p.grad for g in rep["opt_state"].param_groups for p in g["params"]
                                 if p.grad is not None and p.numel()]
                        torch._foreach_div_(grads, float(n))

        def train_step(state, batch):
            reps = state["replicas"]
            chunks = _chunks(batch, devices)
            if zero3:
                gather(reps, by_layer.get(None, []))
                streams = ([_side_stream("gather", d) for d in dict.fromkeys(devices)]
                           if prefetch and devices[0].type == "cuda" else [])
                loss = zero3_loss_and_grads(
                    [rep["params"] for rep in reps], chunks, devices=devices,
                    gather_layer=lambda k: gather(reps, by_layer.get(k, [])),
                    gather_streams=streams, n_layers=n_layers, embed_fn=hints["embed"],
                    block_fn=hints["block"], head_fn=hints["head"], loss_fn=loss_fn,
                    block_key=block_key, prefetch=prefetch,
                    remat=bool(config.get("remat", False)))
            else:
                gather(reps, list(exts))
                loss = _block_loss_backward(spec, loss_fn, [rep["params"] for rep in reps],
                                            chunks, devices, batch, None, reducer)
            reduce(reps)
            for rep, dev in zip(reps, devices):
                with _device_of(dev):
                    rep["opt_state"].step()
                    rep["grads"].zero_()
            _join_devices(reducer, devices)
            state["step"] += 1
            return state, loss

        return init_state, train_step

    def tp_step_fns(
        self, spec: Any, task: Any, devices: Sequence[torch.device], config: Dict[str, Any],
    ) -> Tuple[Any, Any]:
        """(init_state, train_step) of a block of n = data x tp positions
        that splits each layer's compute over a ``model`` axis (tp: the JAX
        package's GSPMD step over its ``("data", "model")`` mesh, Megatron's
        column- and row-parallel products written out).

        A function of its own, not a branch of ``sharded_step_fns``: there
        every position runs a whole model on gathered parameters and the
        positions meet only in the loss and the gradient sums; here a
        position's model holds only its extents, and the forward exchanges
        activations inside every layer (``models/gpt2.tp_logits``), so the
        state, the forward and the reduction all differ.

        **State.** The rule is applied to each leaf's JAX path and shape
        (``_placed_layout``) and read onto the port's tensors
        (``_tp_plan``). Position r (data row r // tp, model coordinate
        r % tp) holds in ``shards`` its extent of every leaf the rule
        splits, and a model built at its compute shapes: a leaf split over
        ``model`` only is that extent itself (``mlp_in`` (F/tp, D), ``wte``
        (V/tp, D)); a leaf the rule also splits over ``data`` (``zero``)
        is held at its ``model`` extent, gathered over the position's data
        group before use; the spec's ``gathered`` leaves (``qkv``, whose
        column blocks do not line up with heads) are held whole, gathered
        over the model group. A replicated leaf is the model's own. The
        optimizer steps the shards and the replicated leaves, so the
        moments follow their parameters. ``placement`` carries the specs,
        the ``{"data", "model"}`` mesh and the whole ``layout`` by which the
        checkpoint writes and restores the state.

        **Step.** Gather; position r takes its data row's rows of the
        batch; the model's ``tensor_parallel`` forward gives each
        position's vocab slice of the logits; the slices are concatenated
        over ``model`` and the rows over ``data`` on the first position's
        device, ``task.loss_fn`` runs once over the whole batch and
        autograd carries each slice back through the model groups' f and g.
        The gradients are then summed over each data group (one flat buffer
        per position, every position of a data group laid out alike), the
        gathered leaves' reduce-scattered over each model group back to
        their extents (two positions that computed one kv group add up
        there), the data-split leaves' sliced to their shards, and every
        position steps its optimizer. A replicated leaf's gradient is the
        same on every position of a model group (f and g hand each the
        whole sum), so it is summed over ``data`` only; but a leaf the rule
        targets and leaves whole over ``model`` (tp does not divide its
        dimension: ``wte`` at a vocabulary of 50257) is computed in parts
        (``models/gpt2.tp_part``), so its gradient is summed over the model
        group as well. The step reads nothing back to the host."""
        from saturn_tpu_torch.parallel.collectives import BlockReducer, ModelGroup

        hints = spec.hints.get("tensor_parallel")
        if hints is None:
            raise NotImplementedError(f"{self.name}: the model has no tensor-parallel forward "
                                      f"(ModelSpec.hints['tensor_parallel'])")
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        plan = self._tp_plan(spec, task, config, n)
        tp, rows_of = plan.mesh_axes["model"], plan.mesh_axes["data"]
        groups = [ModelGroup(devices[d * tp:(d + 1) * tp]) for d in range(rows_of)]
        data_reducers = [BlockReducer(devices[m::tp]) for m in range(tp)]
        reducer = BlockReducer(devices)
        loss_fn, forward = task.loss_fn, hints["logits"]

        def replica(r: int, device, full: Optional[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
            model = _shaped_model(spec, plan.shapes(r), device)
            grads = _flat_grads(self.name, model, device)
            named = dict(model.named_parameters())
            shards: Dict[str, torch.Tensor] = {}
            for name, how in plan.kinds.items():
                if how == "split":
                    shards[name] = named[name]
                elif how != "whole":
                    shard = named[name].new_empty(_sizes(plan.stored[name][r]))
                    shard.grad = torch.zeros_like(shard)
                    shards[name] = shard
            if full is not None:
                with torch.no_grad():
                    for name, p in named.items():
                        p.copy_(full[name][_slices(plan.compute[name][r])])
                    for name, shard in shards.items():
                        if shard is not named[name]:
                            shard.copy_(full[name][_slices(plan.stored[name][r])])
            stepped = [shards.get(name, p) for name, p in model.named_parameters()]
            return {"params": model, "opt_state": task.hparams.make_optimizer(stepped),
                    "grads": grads, "shards": shards}

        def init_state(materialize: bool = True) -> Dict[str, Any]:
            full = None
            if materialize:
                # drawn in host memory: no device holds the whole model
                model = spec.init_fn(torch.Generator().manual_seed(0), None)
                full = {name: p.detach() for name, p in model.named_parameters()}
            reps = [replica(r, dev, full) for r, dev in enumerate(devices)]
            del full
            return {"params": reps[0]["params"], "opt_state": reps[0]["opt_state"], "step": 0,
                    "replicas": reps, "placement": plan.placement}

        def members(r0: int, step: int, count: int) -> List[int]:
            return list(range(r0, r0 + step * count, step))

        def gather(reps) -> None:
            with torch.no_grad():
                named = [dict(rep["params"].named_parameters()) for rep in reps]
                for name in plan.names("data"):
                    for m, red in enumerate(data_reducers):
                        pos = members(m, tp, rows_of)
                        red.all_gather([reps[r]["shards"][name] for r in pos],
                                       [named[r][name] for r in pos],
                                       [plan.relative(name, r) for r in pos])
                for name in plan.names("gathered"):
                    for d, grp in enumerate(groups):
                        pos = members(d * tp, 1, tp)
                        grp.reducer.all_gather([reps[r]["shards"][name] for r in pos],
                                               [named[r][name] for r in pos],
                                               [plan.stored[name][r] for r in pos])

        def reduce(reps) -> None:
            if rows_of > 1:
                for m, red in enumerate(data_reducers):
                    red.all_reduce_([reps[r]["grads"] for r in members(m, tp, rows_of)])
            named = [dict(rep["params"].named_parameters()) for rep in reps]
            for name in plan.names("gathered"):
                for d, grp in enumerate(groups):
                    pos = members(d * tp, 1, tp)
                    grp.reducer.reduce_scatter([named[r][name].grad for r in pos],
                                               [reps[r]["shards"][name].grad for r in pos],
                                               [plan.stored[name][r] for r in pos])
            for name in plan.partial:
                for d, grp in enumerate(groups):
                    grp.reducer.all_reduce_([named[r][name].grad for r in members(d * tp, 1, tp)])
            for name in plan.names("data"):
                for r, rep in enumerate(reps):
                    rep["shards"][name].grad.copy_(
                        named[r][name].grad[_slices(plan.relative(name, r))])

        def train_step(state, batch):
            reps = state["replicas"]
            gather(reps)
            rows = batch.shape[0] // rows_of
            tokens = []
            for r, dev in enumerate(devices):
                c = batch[(r // tp) * rows:(r // tp + 1) * rows]
                tokens.append(c if c.device == dev else c.to(dev, non_blocking=True))
            logits = forward([rep["params"] for rep in reps], tokens, groups, tp)
            dev0 = devices[0]
            whole = torch.cat([torch.cat([logits[d * tp + m].to(dev0) for m in range(tp)], dim=-1)
                               for d in range(rows_of)])
            del logits
            loss = loss_fn(whole, batch)
            loss.backward()
            reduce(reps)
            for rep, dev in zip(reps, devices):
                with _device_of(dev):
                    rep["opt_state"].step()
                    rep["grads"].zero_()
            _join_devices(reducer, devices)
            state["step"] += 1
            return state, loss.detach()

        return init_state, train_step

    def _tp_plan(self, spec: Any, task: Any, config: Dict[str, Any], n: int) -> "_TPPlan":
        """Where every parameter of a tp state lives on a block of n
        (``tp_step_fns``): each position's stored extent (its extent under
        the rule's spec) and compute extent (the spec without ``data``;
        whole for the model's ``gathered`` leaves), in the port tensor's
        coordinates, and the parameter's kind: ``whole`` (replicated),
        ``split`` (stored is compute), ``gathered`` or ``data``. The forward
        splits every leaf the rule targets over ``model``; one it places
        there only at a model extent of 1 (tp does not divide its
        dimension) is ``partial``: whole over ``model``, computed in parts."""
        import re

        from saturn_tpu_torch.parallel import sharding

        mesh_axes, layout, specs = self._placed_layout(spec, task, config, n)
        rules = self.param_rules(task, config)
        unit = {axis: 1 for axis in mesh_axes}
        pattern = re.compile((spec.hints.get("tensor_parallel") or {}).get("gathered", "$^"))
        plan = _TPPlan(mesh_axes=mesh_axes,
                       placement={"specs": specs, "mesh_axes": mesh_axes, "layout": layout})
        for leaf in layout:
            if leaf.kind != "param":
                continue
            spec_ = specs[leaf.key]
            split = "model" in _spec_axes(spec_)
            partial = not split and "model" in _spec_axes(rules(leaf.key, leaf.shape, unit))
            gathered = split and bool(pattern.search(leaf.key))
            if gathered and "data" in _spec_axes(spec_):
                raise NotImplementedError(f"{self.name}: {leaf.key} is gathered over the model "
                                          f"group and split over data ({spec_})")
            cspec = () if gathered else _without_axis(spec_, "data")
            stored = sharding.extents(spec_, leaf.shape, mesh_axes)
            compute = sharding.extents(cspec, leaf.shape, mesh_axes)
            whole = tuple((0, d) for d in leaf.port_shape)
            for j, name in enumerate(leaf.names):
                st = [leaf.port_extent(e, j) for e in stored]
                cp = [leaf.port_extent(e, j) for e in compute]
                if any(e is None for e in st + cp):
                    raise NotImplementedError(f"{self.name}: {leaf.key} is split over its layer "
                                              f"axis ({spec_})")
                plan.stored[name], plan.compute[name] = st, cp
                if partial:
                    plan.partial.append(name)
                plan.kinds[name] = ("whole" if all(e == whole for e in st)
                                    else "split" if st == cp
                                    else "gathered" if gathered else "data")
        return plan

    def _placed_layout(self, spec: Any, task: Any, config: Dict[str, Any], n: int,
                       meta: Any = None):
        """``(mesh_axes, layout, specs)`` of a sharded state on a block of
        n: the mesh of ``mesh_spec``, every leaf of the train state
        (``models/convert.state_layout`` of the meta-device model) and its
        spec under ``param_rules``, applied to the JAX path and shape.
        Raises where the model or the optimizer cannot be sharded, or a
        moment is placed apart from its parameter."""
        from saturn_tpu_torch.models import convert
        from saturn_tpu_torch.parallel import sharding

        if spec.apply_with_aux_fn is not None:
            raise NotImplementedError(
                f"{self.name}: auxiliary-loss models are a later item of the PyTorch port")
        if callable(task.hparams.optimizer):
            raise NotImplementedError(
                f"{self.name}: a sharded state steps a named optimizer (adamw, adam, sgd); "
                f"a user's optimizer callable is a later item of the PyTorch port")
        kind = "sgd" if task.hparams.optimizer == "sgd" else "adam"
        layout = convert.state_layout(spec.abstract_init() if meta is None else meta, None,
                                      kind=kind)
        mesh_axes = dict(zip(*self.mesh_spec(n, task, config)))
        specs = sharding.pspec_tree({leaf.key: leaf.shape for leaf in layout},
                                    self.param_rules(task, config), mesh_axes)
        by_key = {leaf.key: leaf for leaf in layout if leaf.kind == "param"}
        for leaf in layout:
            if leaf.kind in convert.MOMENTS:
                own = by_key["params/" + leaf.key.split("/", 3)[3]]
                if specs[leaf.key] != specs[own.key]:
                    raise ValueError(f"{self.name}: {leaf.key} is placed {specs[leaf.key]}, its "
                                     f"parameter {specs[own.key]}: a position's optimizer "
                                     f"steps its shard with its moments")
        return mesh_axes, layout, specs

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

    def _block_refusal(self, task: Any, n: int, devices: Sequence[Any] = ()) -> Optional[str]:
        """Why a block of ``n`` positions cannot run ``task`` whatever the
        config (None: it can): a technique without replicas; one that
        shards its state on a block that mixes shared and distinct devices
        (its gathers and reduce-scatters take one of the two forms); or,
        where the mesh is one ``data`` axis over the block whatever the
        config (all but tp), the batch rule of ``_config_refusal``."""
        if n == 1:
            return None
        if not self.replicates:
            return f"{self.name} runs on one device (got a block of {n})"
        if self.shards_state and devices:
            from saturn_tpu_torch.core.mesh import physical_groups

            groups = physical_groups(devices)
            if len(groups) > 1 and any(len(g) > 1 for g in groups):
                return (f"a block that mixes shared and distinct devices does not shard "
                        f"({[str(d) for d in devices]})")
        if not self.splits_compute:
            return self._config_refusal(task, n, {})
        return None

    def _config_refusal(self, task: Any, n: int, config: Dict[str, Any]) -> Optional[str]:
        """Why a block of ``n`` positions cannot run one config of the grid
        (None: it can): a batch that the mesh axes of ``batch_spec`` do not
        divide (dp and fsdp: the block's size). The JAX package's
        ``_build_uncached`` raises there and its search skips the config."""
        sizes = dict(zip(*self.mesh_spec(n, task, config)))
        axes = [axis for entry in self.batch_spec(config)
                for axis in (entry if isinstance(entry, tuple) else (entry,))]
        split = int(np.prod([sizes[axis] for axis in axes]))
        batch = task.get_dataset().batch_size
        if batch % split:
            return f"batch_size {batch} not divisible by {'*'.join(axes)}={split}"
        return None

    def batch_spec(self, config: Dict[str, Any]) -> Tuple[Any, ...]:
        """The token batch's spec over the mesh axes: its rows over
        ``data``."""
        return ("data",)

    def mesh_spec(self, n_devices: int, task: Any,
                  config: Dict[str, Any]) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        """``(axis names, axis sizes)`` of the block's mesh: one ``data``
        axis over its positions unless a technique says otherwise."""
        return ("data",), (n_devices,)

    def build(self, task: Any, devices: Sequence[Any], config: Dict[str, Any]) -> _Bundle:
        """The bundle of (task, devices, config), built at its first use.
        A block of several positions holds one replica per position
        (``replicated_step_fns``); ``ValueError`` where ``_block_refusal``
        or ``_config_refusal`` says it cannot."""
        why = (self._block_refusal(task, len(devices), devices)
               or self._config_refusal(task, len(devices), config))
        if why is not None:
            raise ValueError(f"{self.name}: {why}")
        key = self._bundle_key(task, devices, config)
        with self._bundles_lock:
            hit = self._bundles.get(key)
        if hit is not None:
            return hit
        devs = tuple(torch.device(d) for d in devices)
        device = devs[0]
        spec = task.get_model(**self._model_overrides(config))
        if len(devs) == 1:
            init_state, train_step = self.make_step_fns(
                spec, task, config, device, task.get_dataset()
            )
        elif self.splits_compute and not config.get("overlap"):
            init_state, train_step = self.tp_step_fns(spec, task, devs, config)
        elif self.shards_state:
            init_state, train_step = self.sharded_step_fns(spec, task, devs, config)
        else:
            init_state, train_step = self.replicated_step_fns(spec, task, devs)
        bundle = _Bundle(
            device=device,
            init=init_state,
            empty=lambda: init_state(materialize=False),
            step=train_step,
            devices=devs,
        )
        with self._bundles_lock:
            return self._bundles.setdefault(key, bundle)

    def param_rules(self, task: Any, config: Dict[str, Any]):
        """The rule ``(path, shape, mesh_axes) -> spec`` that places the
        train state's leaves over a block (``parallel/sharding.py``):
        replicated unless a technique shards."""
        from saturn_tpu_torch.parallel.sharding import replicated_rules

        return replicated_rules

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
    def _fused_ok(self, task: Any, devices: Sequence[Any] = ()) -> bool:
        """Whether the task may run K-step windows on ``devices``. A
        host-resident state may not (the JAX package's ``_fused_ok`` for
        pinned-host configs): its step copies between host and device and
        updates on the host, which a CUDA graph cannot hold. Nor may a
        user's optimizer callable: whether its step can be captured cannot
        be checked. Nor may a block over distinct cards: a CUDA graph is
        captured on one device's stream, and the step's NCCL sum and the
        other cards' work are not in it. Such a task runs one step at a
        time (logged once per reason)."""
        from saturn_tpu_torch.core.mesh import physical_groups

        why = ("its state lives in host memory" if self.host_state
               else "it has a user optimizer callable" if callable(task.hparams.optimizer)
               else f"its block spans {len(physical_groups(devices))} distinct devices"
               if len(physical_groups(devices)) > 1
               else None)
        if why is None:
            return True
        if (task.name, why) not in self._eager_noted:
            self._eager_noted.add((task.name, why))
            log.info("%s: task %s runs one step at a time (K = 1): %s", self.name,
                     task.name, why)
        return False

    def _window(self, task: Any, window_size: Optional[int] = None,
                devices: Sequence[Any] = ()) -> int:
        """The K of the task's windows on ``devices``, in trials and in
        ``execute``: ``window_size`` if given, else ``max_window()``; 1
        where ``_fused_ok`` says no."""
        k = max_window() if window_size is None else max(1, int(window_size))
        return k if k == 1 or self._fused_ok(task, devices) else 1

    # ---------------------------------------------------------------- health
    def _screen(self, task: Any, losses: np.ndarray, units: List[Unit],
                start: int) -> Optional[np.ndarray]:
        """Fold the interval's per-step losses through the sentinel (the JAX
        package's ``spmd_base.py:1193-1282``, on the host): raise
        ``NumericFaultError`` naming the dataset indices of the bad steps,
        else return the advanced sentinel carry (None with the sentinel
        off), which ``execute`` keeps only if it publishes the interval.

        A fault injector's poisoning for this interval (``task._health_poison``,
        set by the engine, taken here either way) overwrites its slots of a
        copy of the vector first: the sentinel observes the fault, the train
        state never holds it."""
        poison = vars(task).pop("_health_poison", None)
        cfg = sentinel.get_config()
        if not cfg.enabled:
            return None
        losses = observed_losses(losses, poison, lambda j: task.dataset_index(start + j))
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

    def _discard(self, record: Dict[str, Any], why: str, t_all0: float) -> None:
        """Keep the record of an interval that ran and was discarded."""
        record["discarded"] = why
        record["run_s"] = timeit.default_timer() - t_all0
        self.discarded.append(record)

    # ---------------------------------------------------------------- search
    def search(
        self, task: Any, devices: Sequence[Any], tid: int
    ) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """The fastest config of the grid whose measured peak fits in device
        memory. Running out of memory makes a config infeasible; any other
        failure (a kernel that does not build or launch, a capture that
        fails) propagates, so a broken kernel is never hidden behind
        another config. A block that ``_block_refusal`` refuses (a batch
        its positions do not divide) yields no config and runs nothing, a
        config that ``_config_refusal`` refuses runs nothing; where no
        config is left, ``search_report`` says memory was not the
        reason."""
        n = len(devices)
        why = self._block_refusal(task, n, devices)
        if why is not None:
            log.info("%s on task %s, block of %d: infeasible (%s)", self.name, task.name, n,
                     why)
            self.trials.append((task.name, n, {}, None, "block"))
            self._search_reports[(task.name, n)] = {"memory_infeasible": False}
            return None, None
        best: Tuple[Optional[Dict[str, Any]], Optional[float]] = (None, None)
        n_configs = n_memory = 0
        for config in self.candidate_configs(task, n):
            n_configs += 1
            why = self._config_refusal(task, n, config)
            if why is not None:
                log.info("%s trial %s on task %s: infeasible (%s)", self.name, config,
                         task.name, why)
                self.trials.append((task.name, n, dict(config), None, "block"))
                continue
            if not self._static_screen(task, devices, config):
                self.trials.append((task.name, n, dict(config), None, "static"))
                n_memory += 1
                continue
            t = self._try_config(task, devices, config)
            if t is None:
                self.trials.append((task.name, n, dict(config), None, "memory"))
                n_memory += 1
                continue
            self.trials.append((task.name, len(devices), dict(config), t, "ok"))
            log.info("%s trial %s on task %s: %.6fs/batch", self.name, config,
                     task.name, t)
            if best[1] is None or t < best[1]:
                best = (dict(config), t)
                self._reports[(task.name, n)] = dict(
                    self._trial_extra.get((task.name, _config_key(config)), {}))
        if best[1] is None:
            self._search_reports[(task.name, n)] = {
                "memory_infeasible": n_configs > 0 and n_memory == n_configs}
        return best

    def search_report(self, task_name: str, size: int) -> Optional[Dict[str, Any]]:
        """Pop why the latest infeasible ``search`` of (task, size) found no
        config: ``{"memory_infeasible": bool}``, True when every config
        failed the static screen or ran out of memory (the JAX package's
        report; the trial runner caches and prunes on it). None after a
        feasible search."""
        return self._search_reports.pop((task_name, int(size)), None)

    def trial_report(self, task_name: str, size: int) -> Dict[str, float]:
        """Pop what the latest ``search`` of (task, size) measured of its
        winning config beside its time: ``host_fraction`` (the staging
        seconds of a batch against staging plus the device's per-batch
        time) and ``peak_bytes`` (the trial's peak device memory). Empty
        when no feasible search ran (the JAX package's pop-once
        ``host_fraction_report``)."""
        return self._reports.pop((task_name, int(size)), {})

    def state_bytes(self, task: Any, config: Dict[str, Any], size: int = 1) -> int:
        """Bytes of the train state a device-resident config keeps on the
        device for one replica of a block of ``size`` positions: parameters,
        their gradients and the optimizer's moments (two per parameter for
        AdamW and Adam, none for SGD or a user's callable, whose state is
        unknown), counted from the model on the meta device. A replicated
        state's share does not depend on ``size``."""
        params, moments = self._param_bytes(task, config)
        return params * (2 + moments)

    def _param_bytes(self, task: Any, config: Dict[str, Any]) -> Tuple[int, int]:
        """(bytes of the fp32 parameters, moments per parameter)."""
        model = task.get_model(**self._model_overrides(config)).abstract_init()
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        return params, 2 if task.hparams.optimizer in ("adamw", "adam") else 0

    def _static_screen(self, task: Any, devices: Sequence[Any],
                       config: Dict[str, Any]) -> bool:
        """Whether a config may fit before anything is drawn: the port's
        counterpart of the JAX package's compile-time ``_fits_memory`` for
        the plain case. A device-resident config whose ``state_bytes`` at
        the block's size, times the replicas that share the most loaded
        device of the block,
        exceed ``MEMORY_HEADROOM`` of device memory is infeasible without an
        init (logged). Activations are left to the trial's measured peak;
        a host-resident state is not screened."""
        from saturn_tpu_torch.core.mesh import physical_groups

        limit = timing.device_memory_bytes(devices[0])
        if self.host_state or limit <= 0:
            return True
        shared = max(len(g) for g in physical_groups(devices)) if self.replicates else 1
        need = self.state_bytes(task, config, len(devices)) * shared
        if need <= MEMORY_HEADROOM * limit:
            return True
        log.info("%s: config %s keeps %.2f GiB of train state (params, grads, optimizer "
                 "moments, %d replica(s)) on the device, over %.2f GiB (%.0f%% of %.2f GiB): "
                 "infeasible before any init", self.name, config, need / 2**30, shared,
                 MEMORY_HEADROOM * limit / 2**30, 100 * MEMORY_HEADROOM, limit / 2**30)
        return False

    def _trial_state(self, task: Any, bundle: _Bundle) -> Dict[str, Any]:
        """The state a trial steps: a fresh init."""
        return bundle.init()

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
        With K = 1: ``trial_steps`` single steps through
        ``timing.time_train_step``. The state is ``_trial_state``'s.

        Beside the time it measures the host fraction (``host_fraction``:
        staging one unit's batches, synchronized, outside the timed region,
        the least of three, per batch, against the per-batch time) and
        keeps it and the peak memory for ``trial_report``."""
        bundle = self.build(task, devices, config)
        dev = bundle.device
        k = self._window(task, devices=devices)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for d in set(bundle.devices):
            timing.reset_peak_memory(d)
        state = self._trial_state(task, bundle)
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
                warm, timed = self.trial_steps

                def stage(j: int) -> torch.Tensor:
                    return bundle.stage(task.batch_at(j))

                t = timing.time_train_step(bundle.step, state, batch, n_timed=timed,
                                           n_warmup=warm)
            peak = max(timing.peak_memory_bytes(d) for d in set(bundle.devices))
            t_host = min(self._staging_s(stage, dev) for _ in range(3)) / k
        except torch.cuda.OutOfMemoryError as e:
            log.info("%s: config %s ran out of device memory", self.name, config)
            # the failed step's frames hold its device tensors
            traceback.clear_frames(e.__traceback__)
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
        self._trial_extra[(task.name, _config_key(config))] = {
            "host_fraction": host_fraction(t_host, t), "peak_bytes": float(peak)}
        return t

    @staticmethod
    def _staging_s(stage: Callable[[int], torch.Tensor], dev: torch.device) -> float:
        """Seconds to stage one unit's batches on the device, synchronized."""
        timing.synchronize(dev)
        t0 = timeit.default_timer()
        probe = stage(0)
        timing.synchronize(dev)
        del probe
        return timeit.default_timer() - t0

    # --------------------------------------------------------------- execute
    #: ``execute`` is a drain of ``interval_dispatches``, which the engine's
    #: co-schedule launcher can interleave with another member's
    supports_coschedule = True

    def execute(
        self,
        task: Any,
        devices: Sequence[Any],
        tid: int,
        override_batch_count: Optional[int] = None,
        window_size: Optional[int] = None,
    ) -> None:
        """Run one interval of ``n`` batches (the JAX package's ``execute``
        on one device): a full drain of :meth:`interval_dispatches`, so the
        solo and the co-scheduled paths dispatch the same units in the same
        order."""
        for _ in self.interval_dispatches(task, devices, tid, override_batch_count,
                                          window_size):
            pass

    def interval_dispatches(
        self,
        task: Any,
        devices: Sequence[Any],
        tid: int,
        override_batch_count: Optional[int] = None,
        window_size: Optional[int] = None,
        shared: bool = False,
    ):
        """One interval as a generator of its unit dispatches (the JAX
        package's ``interval_dispatches``). It yields ``("waiting", u)``
        (shared mode only) while unit ``u``'s staged batch is still being
        copied, ``("dispatched", u)`` once unit ``u`` is enqueued on the
        device, and ``("drain", n_units)`` once every unit is; resuming past
        the drain reads the losses back, screens them, publishes the
        interval and writes the checkpoint.

        The state is the task's live state when the previous interval ran
        this bundle, else the checkpoint placed by this bundle's rule
        (``checkpoint.restore_sharded``: a state of another technique,
        config or block restores without a full host tree; the data cursor
        follows its step count), else a fresh init; the live state is dropped before the
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
        nothing, and the engine's publish gate (``task._publish_gate``)
        raises ``PreemptedError`` where the block lost a device. Otherwise
        the interval ends with ``checkpoint.save_async`` and the state kept
        live.

        ``shared=True`` is the co-schedule mode: the staging copy's event is
        polled (``torch.cuda.Event.query``, where the JAX package asks its
        prefetcher's ``try_next``) instead of waited on, the first unit is
        not fenced, and the realized per-batch time is left to the engine's
        group launcher (``task.last_per_batch_s`` stays as it was). The
        device-side dispatch order is the solo path's, so each member's
        losses and checkpoints equal its solo run's."""
        # set by the engine's watchdog when it abandons this launch
        abandoned = getattr(task, "_abandoned", None)
        config = dict(task.selected_strategy.params or {})
        bundle = self.build(task, devices, config)
        key = self._bundle_key(task, devices, config)

        t_begin = timeit.default_timer()
        restored = False
        if self.host_state:
            # a host state's checkpoint is written from the live tensors:
            # they change, and another state is allocated, only after it
            ckpt.wait(task.ckpt_path)
        # no local keeps the live state: a failed interval's traceback
        # must not hold a train state's memory
        if task._live_state is not None and task._live_state[0] == key:
            state = task._live_state[1]
            task._live_state = None
        else:
            # a state of another config goes before the new one is allocated
            task.release_live_state()
            if task.has_ckpt():
                # the checkpoint's shards placed by this bundle's rule
                # (``restore`` is ``restore_sharded`` under the state's own
                # placement): a state of another technique, config or block
                # restores here
                state = ckpt.restore(task.ckpt_path, bundle.empty())
                task.current_batch = task.cursor_for_step(state["step"])
                restored = True
            else:
                state = bundle.init()

        n = int(task.total_batches if override_batch_count is None else override_batch_count)
        k = self._window(task, window_size, devices)
        units = unit_plan(n, k, warm=k > 1 and not bundle.warmed(state))
        sizes = sorted({size for kind, _, size in units if kind == "window"}, reverse=True)
        start = task.current_batch

        def stage(kind: str, off: int, size: int):
            if kind == "window":
                host = np.stack([task.batch_at(start + off + j) for j in range(size)])
            else:
                host = task.batch_at(start + off)
            return stage_async(host, bundle.device)

        unit_losses: List[torch.Tensor] = []
        capture_s = None
        t_all0 = t_steady = timeit.default_timer()
        state_s = t_all0 - t_begin
        for u, (kind, off, size) in enumerate(units):
            staged, done = stage(kind, off, size)
            if shared and done is not None:
                while not done.query():
                    yield ("waiting", u)
            batch = ready(staged, done)
            del staged
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
            if u == 0 and len(units) > 1 and not shared:
                # the first unit pays one-time costs (and the captures):
                # keep it out of the realized time
                timing.synchronize(bundle.device)
                t_steady = timeit.default_timer()
            yield ("dispatched", u)
        yield ("drain", len(units))

        n_windows = sum(kind == "window" and size == k for kind, _, size in units)
        warm = bool(units) and units[0][0] == "warm"
        record = {"task": task.name, "config": config, "n": n, "k": k,
                  "replicas": len(devices),
                  "windows": n_windows, "tail": n - int(warm) - n_windows * k,
                  "warm": warm, "capture_s": capture_s,
                  "restored": restored, "per_batch_s": None, "shared": shared,
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
            record["first_loss"] = float(losses[0])
            # the sentinel screens every step's loss before anything of the
            # interval is published: a fault drops the state, so the retry
            # restores from the last checkpoint (and captures anew)
            try:
                carry = self._screen(task, losses, units, start)
            except sentinel.NumericFaultError:
                state = None
                self._discard(record, "numeric", t_all0)
                raise
        if abandoned is not None and abandoned.is_set():
            # the engine's watchdog gave up on this launch: a late finish
            # publishes nothing (the retry restores the last checkpoint)
            log.warning("task %s: interval finished after the watchdog abandoned "
                        "it; discarding it", task.name)
            self._discard(record, "abandoned", t_all0)
            return
        gate = getattr(task, "_publish_gate", None)
        if gate is not None:
            # the engine's preemption check: a block that lost a device
            # discards the interval before its checkpoint is written
            try:
                gate()
            except Exception:
                state = None
                self._discard(record, "preempted", t_all0)
                raise
        if carry is not None:
            task._sentinel_carry = carry
        if losses is not None:
            task.last_losses = losses.tolist()
            if not shared:
                if len(units) > 1:
                    per_batch = (t_end - t_steady) / max(n - units[0][2], 1)
                else:
                    per_batch = (t_end - t_all0) / max(n, 1)
                task.last_per_batch_s = per_batch
                task.note_realized_per_batch(per_batch)
                record["per_batch_s"] = per_batch
            log.info("task %s [%s]: ran %d batches (K=%d, %d windows, tail %d%s%s%s), "
                     "loss %.4f%s", task.name, self.name, n, k, n_windows,
                     record["tail"], ", eager warm-up step" if warm else "",
                     ", restored from the checkpoint" if restored else "",
                     ", co-scheduled" if shared else "", task.last_losses[-1],
                     "" if shared else f", {record['per_batch_s']:.4f}s/batch")
        t_save = timeit.default_timer()
        record["run_s"] = t_save - t_all0
        ckpt.save_async(task.ckpt_path, state, snapshot=not self.host_state)
        record["save_s"] = timeit.default_timer() - t_save
        self.intervals.append(record)
        task._live_state = (key, state)
