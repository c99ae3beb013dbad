"""HostOffload: the train state in pinned host memory, streamed to the card.

Counterpart of ``saturn_tpu/parallel/offload.py`` (the reference Saturn's
fairscale "Spilled" executor) on one device. The parameters, their
gradients and the optimizer's moments live in host memory, one flat buffer
each (``_HostBuffer``: exact size, pinned with ``cudaHostRegister``; the
caching host allocator would round a 20 GB block up to 32 GiB), and the
optimizer steps there (``HParams.make_optimizer(host=True)``: torch's fused
CPU AdamW, optax's math). Only what a step computes with is on the card,
and only during the step:

- ``stream=True`` (a model with pipeline hints and no auxiliary loss): the
  embedding, final norm and head are copied to the card for the step; each
  block runs as ``_StreamedBlock``, whose forward fetches the block's
  parameters into one of two device buffers (block i + 1 is fetched on a
  copy stream while block i computes) and saves only the block's input,
  and whose backward fetches them again (unless its buffer still holds
  them), recomputes the block with grad, returns dx and sends the block's
  parameter gradients to the host as they are produced: the JAX package's
  ``jax.checkpoint`` around its scan body.
- ``stream=False`` (bulk): the whole parameter set is copied into a device
  shadow once per step on a copy stream; forward and backward run there,
  and each gradient is sent to the host once autograd has accumulated it.

Both modes run the loss over the logits (the JAX package's fused-head
routing condition, ``forward is spec.apply_fn``, fails for its offload
forward) and one eager step at a time (``SPMDTechnique._fused_ok``). The
trials of one task step one host state, drawn once (``_trial_state``). The
process holds one host state at a time (``release_host_states``): a
GPT-J-6B state takes 65 GiB of a 96 GiB host, so before another is
allocated every task's live one is dropped, once its checkpoint is written,
and that task's next interval restores the checkpoint. On
the CPU (the tests) the same code runs with the device buffers on the CPU,
plain copies and nothing pinned. Nothing falls back: a failed registration,
copy or allocation raises (running out of device memory in a trial makes
its config infeasible, as for dp).
"""

from __future__ import annotations

import collections
import copy
import gc
import logging
import timeit
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from saturn_tpu_torch.core.strategy import Techniques
from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique, _side_stream
from saturn_tpu_torch.utils import checkpoint as ckpt

log = logging.getLogger("saturn_tpu_torch")

#: Every parameter starts on a multiple of this many elements of its buffer
#: (256 bytes in fp32).
ALIGN = 64

#: (name, offset, numel, shape) of one parameter in a flat buffer.
Entry = Tuple[str, int, int, Tuple[int, ...]]


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class Layout:
    """Where each parameter of a model lies in its flat buffers: in
    ``named_parameters`` order, each block's parameters one contiguous run
    (``blocks[i]`` = (start, end)), every block laid out alike (``block``:
    entries relative to the block's start). ``other`` packs the parameters
    outside the blocks (embedding, final norm) for the device, ``runs``
    maps their host ranges onto it."""

    def __init__(self, model: nn.Module, block_key: str):
        if any(True for _ in model.buffers()):
            raise NotImplementedError("offload: a model with buffers is not carried")
        dtypes = {p.dtype for p in model.parameters()}
        if len(dtypes) != 1:
            raise NotImplementedError(f"offload: one parameter dtype expected, got {dtypes}")
        self.dtype = dtypes.pop()
        self.entries: List[Entry] = []
        off = 0
        for name, p in model.named_parameters():
            self.entries.append((name, off, p.numel(), tuple(p.shape)))
            off += _padded(p.numel())
        self.numel = off
        self.blocks: List[Tuple[int, int]] = []
        self.block: List[Entry] = []
        n_blocks = len(getattr(model, block_key))
        for i in range(n_blocks):
            pre = f"{block_key}.{i}."
            idx = [j for j, e in enumerate(self.entries) if e[0].startswith(pre)]
            if idx != list(range(idx[0], idx[-1] + 1)):
                raise NotImplementedError(f"offload: block {i}'s parameters are not contiguous")
            start = self.entries[idx[0]][1]
            last = self.entries[idx[-1]]
            self.blocks.append((start, last[1] + _padded(last[2])))
            rel = [(e[0][len(pre):], e[1] - start, e[2], e[3]) for e in
                   (self.entries[j] for j in idx)]
            if i == 0:
                self.block = rel
            elif rel != self.block:
                raise NotImplementedError(f"offload: block {i} is laid out unlike block 0")
        self.block_numel = max((end - start for start, end in self.blocks), default=0)
        self.other: List[Entry] = []
        self.runs: List[Tuple[int, int, int]] = []  # (host start, host end, device start)
        dev = 0
        for name, off, n, shape in self.entries:
            if name.startswith(f"{block_key}."):
                continue
            if self.runs and self.runs[-1][1] == off:
                h0, _, d0 = self.runs[-1]
                self.runs[-1] = (h0, off + _padded(n), d0)
            else:
                self.runs.append((off, off + _padded(n), dev))
            self.other.append((name, dev, n, shape))
            dev += _padded(n)
        self.other_numel = dev


def _bind(module: nn.Module, flat: torch.Tensor, entries: Sequence[Entry]) -> List[nn.Parameter]:
    """Make each entry's parameter of ``module`` a view of ``flat``; returns
    them in entry order."""
    out = []
    for name, off, n, shape in entries:
        path, _, leaf = name.rpartition(".")
        mod = module.get_submodule(path) if path else module
        p = nn.Parameter(flat[off:off + n].view(shape))
        setattr(mod, leaf, p)
        out.append(p)
    return out


class _HostBuffer:
    """One flat host buffer of exactly ``numel`` elements, pinned with
    ``cudaHostRegister`` where ``pin`` (so copies to and from the card are
    DMA on a stream), unregistered before its memory can be freed."""

    def __init__(self, numel: int, dtype: torch.dtype, pin: bool):
        # zeros: a parameter that gets no gradient keeps a zero one, the
        # alignment gaps written to checkpoints are zeros, and the pages are
        # touched (by all cores) before registering pins them
        self.flat = torch.zeros(numel, dtype=dtype)
        self._registered: Optional[int] = None
        if pin:
            cudart = torch.cuda.cudart()
            nbytes = numel * self.flat.element_size()
            rc = cudart.cudaHostRegister(self.flat.data_ptr(), nbytes, 0)
            if int(rc) != 0:
                raise RuntimeError(f"offload: cudaHostRegister of {nbytes / 2**30:.2f} GiB "
                                   f"failed: {cudart.cudaGetErrorString(rc)}")
            self._registered = self.flat.data_ptr()

    def view(self, off: int, n: int, shape) -> torch.Tensor:
        return self.flat[off:off + n].view(shape)

    def __del__(self):
        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None


class HostState:
    """The host side of an offload train state: the layout and the flat
    buffers of the parameters, their gradients and the optimizer's moments
    (``state["host"]``)."""

    def __init__(self, layout: Layout, moments: int, pin: bool):
        self.layout = layout
        kinds = ["params", "grads"] + ["exp_avg", "exp_avg_sq"][:moments]
        self.buffers = {k: _HostBuffer(layout.numel, layout.dtype, pin) for k in kinds}

    @property
    def params(self) -> torch.Tensor:
        return self.buffers["params"].flat

    @property
    def grads(self) -> torch.Tensor:
        return self.buffers["grads"].flat

    def nbytes(self) -> int:
        return sum(b.flat.numel() * b.flat.element_size() for b in self.buffers.values())

    def pinned(self) -> bool:
        return all(b.flat.is_pinned() for b in self.buffers.values())


#: The tasks whose live state (``task._live_state``) may be a host state,
#: by ``id``.
_HOLDERS: Dict[int, "weakref.ref"] = {}


def release_host_states() -> None:
    """Drop every task's live host state: wait for its checkpoint write,
    which reads the live tensors, then release it (the task's next interval
    restores the checkpoint). Called before any host state is allocated, so
    that the host never holds two."""
    while _HOLDERS:
        _, ref = _HOLDERS.popitem()
        task = ref()
        if task is not None and task._live_state is not None \
                and "host" in task._live_state[1]:
            ckpt.wait(task.ckpt_path)
            task.release_live_state()
    gc.collect()  # the buffers are unregistered and freed before the next is made


def make_host_state(spec: Any, task: Any, pin: bool, materialize: bool) -> Dict[str, Any]:
    """A train state ``{params, opt_state, step, host}`` in host memory:
    the model's parameters are views of the host parameter buffer, their
    ``.grad`` views of the gradient buffer, and AdamW's or Adam's moments
    views of the moment buffers, made here (so pinned) rather than at the
    first step. ``materialize`` writes the initial weights straight into
    the host buffer, as ``spec.init_fn`` makes them (``spec.fill_fn``: a
    draw from the seed-0 ``torch.Generator``, or a pretrained model's
    weights); otherwise they are left for a checkpoint to fill. Every live
    host state is released first (``release_host_states``), and so is the
    pretrained-weight cache (``models.ingest``), before the buffers are
    allocated and after they are filled: a mapped GPT-J-6B is 12-24 GB
    beside a 65 GiB host state."""
    from saturn_tpu_torch.models import ingest

    release_host_states()
    ingest.release_cache()
    opt_name = task.hparams.optimizer
    if callable(opt_name):
        raise NotImplementedError("offload: a user optimizer callable would allocate its "
                                  "state where the host buffers cannot hold it")
    if spec.fill_fn is None:
        raise NotImplementedError("offload: the model spec has no fill_fn(model, generator) "
                                  "to write its weights into the host buffer")
    model = spec.abstract_init()
    layout = Layout(model, spec.hints.get("block_param_key", "blocks"))
    host = HostState(layout, 2 if opt_name in ("adamw", "adam") else 0, pin)
    params = _bind(model, host.params, layout.entries)
    if materialize:
        spec.fill_fn(model, torch.Generator().manual_seed(0))
        ingest.release_cache()
    for (name, off, n, shape), p in zip(layout.entries, params):
        p.grad = host.buffers["grads"].view(off, n, shape)
    opt = task.hparams.make_optimizer(params, host=True)
    if "exp_avg" in host.buffers:
        for (name, off, n, shape), p in zip(layout.entries, params):
            opt.state[p] = {"step": torch.zeros((), dtype=torch.float32),
                            "exp_avg": host.buffers["exp_avg"].view(off, n, shape),
                            "exp_avg_sq": host.buffers["exp_avg_sq"].view(off, n, shape)}
    return {"params": model, "opt_state": opt, "step": 0, "host": host}


class _Mover:
    """The copies of one step between the host buffers and the device, and
    its time split. On the card: host-to-device copies on the ``h2d`` stream
    and device-to-host copies on the ``d2h`` stream, each ordered by events
    and timed by a pair of them; ``compute_s`` is the compute stream's span
    from the step's start to the end of its backward, stalls on copies
    included. On the CPU: plain copies, timed by the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.split = {"h2d_s": 0.0, "d2h_s": 0.0, "compute_s": 0.0, "update_s": 0.0,
                      "h2d_bytes": 0, "d2h_bytes": 0}
        self._events: List[Tuple[str, Any, Any]] = []
        self._t0 = timeit.default_timer()
        if self.cuda:
            self.current = torch.cuda.current_stream(device)
            self.h2d_stream = _side_stream("h2d", device)
            self.d2h_stream = _side_stream("d2h", device)
            # the device buffers of this step were allocated on the current
            # stream: copies into them come after its earlier work
            self.h2d_stream.wait_stream(self.current)
            self._start = self._event(self.current)

    @staticmethod
    def _event(stream):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def h2d(self, dst: torch.Tensor, src: torch.Tensor, after=None):
        """Copy host ``src`` into device ``dst`` (after event ``after``);
        returns the event the compute stream waits on (None on the CPU)."""
        self.split["h2d_bytes"] += src.numel() * src.element_size()
        if not self.cuda:
            t0 = timeit.default_timer()
            dst.copy_(src)
            self.split["h2d_s"] += timeit.default_timer() - t0
            return None
        s = self.h2d_stream
        if after is not None:
            s.wait_event(after)
        start = self._event(s)
        with torch.cuda.stream(s):
            dst.copy_(src, non_blocking=True)
        end = self._event(s)
        self._events.append(("h2d_s", start, end))
        return end

    def ready(self, event) -> None:
        """The compute stream waits for a copy."""
        if event is not None:
            self.current.wait_event(event)

    def mark(self):
        """An event on the compute stream after the work queued so far."""
        return self._event(self.current) if self.cuda else None

    def d2h(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Copy device ``src`` (complete on the compute stream) into host
        ``dst``; ``src`` may be dropped by the caller at once."""
        self.split["d2h_bytes"] += src.numel() * src.element_size()
        if not self.cuda:
            t0 = timeit.default_timer()
            dst.copy_(src)
            self.split["d2h_s"] += timeit.default_timer() - t0
            return
        s = self.d2h_stream
        s.wait_stream(self.current)
        start = self._event(s)
        with torch.cuda.stream(s):
            dst.copy_(src, non_blocking=True)
        end = self._event(s)
        src.record_stream(s)
        self._events.append(("d2h_s", start, end))

    def sender(self, dst: torch.Tensor):
        """A post-accumulate-grad hook that sends a parameter's gradient to
        ``dst`` and frees it on the device."""
        def hook(p: torch.Tensor) -> None:
            self.d2h(dst, p.grad)
            p.grad = None
        return hook

    def drain(self) -> None:
        """Wait on the host for every copy to the host, and read the times."""
        if not self.cuda:
            self.split["compute_s"] = (timeit.default_timer() - self._t0
                                       - self.split["h2d_s"] - self.split["d2h_s"])
            return
        end = self._event(self.current)
        done = self._event(self.d2h_stream)
        done.synchronize()
        end.synchronize()
        for key, a, b in self._events:
            self.split[key] += a.elapsed_time(b) / 1e3
        self.split["compute_s"] = self._start.elapsed_time(end) / 1e3


class _Streamer:
    """The two device buffers of stream mode and the block they hold: block
    i runs from buffer i % 2; fetching a block waits for its buffer's
    previous block to finish."""

    def __init__(self, host: HostState, slots: Sequence[nn.Module], block_fn, mover: _Mover):
        layout = host.layout
        self.host, self.block_fn, self.mover = host, block_fn, mover
        self.bufs = [torch.empty(layout.block_numel, dtype=layout.dtype, device=mover.device)
                     for _ in slots]
        self.slots = list(slots)
        self.params = [_bind(m, b, layout.block) for m, b in zip(self.slots, self.bufs)]
        self.holds = [-1] * len(slots)
        self.ready_ev: List[Any] = [None] * len(slots)
        # the buffers were just allocated: their first fetch follows the
        # compute stream's earlier work
        self.free_ev: List[Any] = [mover.mark()] * len(slots)
        self.n = len(layout.blocks)

    def fetch(self, i: int) -> None:
        s = i % 2
        if i < 0 or i >= self.n or self.holds[s] == i:
            return
        start, end = self.host.layout.blocks[i]
        self.ready_ev[s] = self.mover.h2d(self.bufs[s][: end - start],
                                          self.host.params[start:end], after=self.free_ev[s])
        self.holds[s] = i

    def forward(self, i: int, x: torch.Tensor) -> torch.Tensor:
        self.fetch(i)
        self.fetch(i + 1)
        s = i % 2
        self.mover.ready(self.ready_ev[s])
        y = self.block_fn(self.slots[s], x)
        self.free_ev[s] = self.mover.mark()
        return y

    def backward(self, i: int, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        self.fetch(i)
        self.fetch(i - 1)
        s = i % 2
        self.mover.ready(self.ready_ev[s])
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            y = self.block_fn(self.slots[s], xg)
            grads = torch.autograd.grad(y, [xg, *self.params[s]], dy)
        self.free_ev[s] = self.mover.mark()
        start = self.host.layout.blocks[i][0]
        for (_, off, n, shape), g in zip(self.host.layout.block, grads[1:]):
            self.mover.d2h(self.host.grads[start + off:start + off + n].view(shape), g)
        return grads[0]


class _StreamedBlock(torch.autograd.Function):
    """One block of stream mode: forward runs it from a fetched buffer and
    saves only its input; backward fetches, recomputes and differentiates."""

    @staticmethod
    def forward(ctx, x, streamer: _Streamer, i: int):
        ctx.streamer, ctx.i = streamer, i
        ctx.save_for_backward(x)
        return streamer.forward(i, x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return ctx.streamer.backward(ctx.i, x, dy), None, None


class HostOffload(SPMDTechnique):
    name = "offload"
    technique = Techniques.OFFLOAD
    host_state = True
    # one device: its ``zero`` config over several devices is a later item
    replicates = False
    # one eager step at a time with host copies inside: run sequentially in
    # a co-schedule group
    supports_coschedule = False
    # a GPT-J-6B step at 24 layers takes 2.4-4.1 s on an H100's host (PERF.md
    # section 5): one warm-up and two timed steps keep its three trials near 30 s
    trial_steps = (1, 2)

    def __init__(self) -> None:
        super().__init__()
        # the host state the trials of one task step, drawn once
        self._shared: Dict[str, Dict[str, Any]] = {}
        # each step's time split (``_Mover.split``) with its task and config
        self.splits: collections.deque = collections.deque(maxlen=4096)

    def candidate_configs(self, task, n_devices) -> List[Dict[str, Any]]:
        """The JAX package's grid on one device: streaming first (lowest
        device memory, the configuration the technique exists for) where
        the model has pipeline hints and no auxiliary loss, then bulk with
        and without remat. Empty for a user optimizer callable."""
        if callable(task.hparams.optimizer):
            log.info("offload: task %s has a user optimizer callable; its state cannot be "
                     "placed in host memory, no config", task.name)
            return []
        spec = task.get_model()
        grid: List[Dict[str, Any]] = []
        if "pipeline" in spec.hints and not self._aux_incompatible(spec):
            grid.append({"stream": True, "remat": True})
        grid.append({"stream": False, "remat": True})
        grid.append({"stream": False, "remat": False})
        return grid

    @staticmethod
    def _aux_incompatible(spec: Any) -> bool:
        return spec.apply_with_aux_fn is not None

    def _model_overrides(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = super()._model_overrides(config)
        if config.get("stream"):
            # streaming recomputes each block itself; the model must not
            # checkpoint its blocks again
            out["remat"] = False
        return out

    def _trial_state(self, task: Any, bundle: Any) -> Dict[str, Any]:
        state = self._shared.get(task.name)
        if state is None:
            state = self._shared[task.name] = bundle.init()
        return state

    def execute(self, task: Any, devices: Sequence[Any], tid: int,
                override_batch_count: Optional[int] = None,
                window_size: Optional[int] = None) -> None:
        """``SPMDTechnique.execute``; the task's live state, a host state,
        is then one that ``release_host_states`` drops."""
        super().execute(task, devices, tid, override_batch_count, window_size)
        _HOLDERS[id(task)] = weakref.ref(task)

    def search(self, task: Any, devices: Sequence[Any], tid: int):
        try:
            return super().search(task, devices, tid)
        finally:
            # free the trials' host state before anything draws another
            self._shared.pop(task.name, None)
            gc.collect()

    def make_step_fns(self, spec, task, config, device, ds):
        device = torch.device(device)
        stream = bool(config.get("stream"))
        if stream:
            if self._aux_incompatible(spec):
                raise ValueError(
                    f"{self.name}: model has an auxiliary loss (apply_with_aux_fn) that "
                    f"streaming would drop; use bulk offload or dp for aux-loss models")
            if not config.get("remat", True):
                raise ValueError(f"{self.name}: stream mode always recomputes its blocks "
                                 f"(remat on), got {config}")
            pipe = spec.hints.get("pipeline")
            if pipe is None:
                raise ValueError(f"{self.name}: stream mode runs the model's pipeline hints "
                                 f"(hints['pipeline']: embed, block, head); it has none")
        elif spec.apply_with_aux_fn is not None:
            raise NotImplementedError(
                f"{self.name}: auxiliary-loss models are a later item of the PyTorch port")
        bkey = spec.hints.get("block_param_key", "blocks")
        loss_fn = task.loss_fn
        pin = device.type == "cuda"
        record = {"task": task.name, "config": dict(config)}

        def init_state(materialize: bool = True) -> Dict[str, Any]:
            return make_host_state(spec, task, pin, materialize)

        def bulk_loss(host: HostState, mover: _Mover, batch) -> torch.Tensor:
            layout = host.layout
            model = spec.abstract_init()
            flat = torch.empty(layout.numel, dtype=layout.dtype, device=device)
            mover.ready(mover.h2d(flat, host.params))
            for (name, off, n, shape), p in zip(layout.entries,
                                                _bind(model, flat, layout.entries)):
                p.register_post_accumulate_grad_hook(mover.sender(host.grads[off:off + n].view(shape)))
            del flat
            return loss_fn(spec.apply_fn(model, batch), batch)

        def stream_loss(host: HostState, mover: _Mover, batch) -> torch.Tensor:
            layout = host.layout
            model = spec.abstract_init()
            blocks = getattr(model, bkey)
            slots = [blocks[0], blocks[1] if len(blocks) > 1 else copy.deepcopy(blocks[0])]
            setattr(model, bkey, nn.ModuleList())  # the embedding, norm and head only
            other = torch.empty(layout.other_numel, dtype=layout.dtype, device=device)
            for h0, h1, d0 in layout.runs:
                mover.ready(mover.h2d(other[d0:d0 + h1 - h0], host.params[h0:h1]))
            by_name = {e[0]: e for e in layout.entries}
            for (name, *_), p in zip(layout.other, _bind(model, other, layout.other)):
                _, off, n, shape = by_name[name]
                p.register_post_accumulate_grad_hook(mover.sender(host.grads[off:off + n].view(shape)))
            del other
            streamer = _Streamer(host, slots, pipe["block"], mover)
            x = pipe["embed"](model, batch)
            for i in range(len(layout.blocks)):
                x = _StreamedBlock.apply(x, streamer, i)
            return loss_fn(pipe["head"](model, x), batch)

        step_loss = stream_loss if stream else bulk_loss

        def train_step(state, batch):
            t0 = timeit.default_timer()
            host = state["host"]
            mover = _Mover(device)
            loss = step_loss(host, mover, batch)
            loss.backward()
            mover.drain()
            t1 = timeit.default_timer()
            state["opt_state"].step()
            mover.split["update_s"] = timeit.default_timer() - t1
            state["step"] += 1
            self.splits.append(dict(record, step=state["step"], step_s=timeit.default_timer() - t0,
                                    **mover.split))
            return state, loss.detach()

        return init_state, train_step
