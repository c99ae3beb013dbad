"""Fused multi-model stacking: N sweep members trained as one stacked program.

Counterpart of ``saturn_tpu/parallel/fused.py`` on one device. Members that
share an architecture and differ only in hyperparameters (an lr sweep) keep
their parameters and optimizer moments stacked on a leading member axis, and
one program advances all of them a batch per lockstep step: the model's
stacked forward (``ModelSpec.stacked_loss_fn``: the dense products batched
over the member axis, attention with the members folded into its batch, the
fused CE head once per member) and a stacked optimizer whose lr is an
(N, 1, ...) tensor (:class:`StackedOptimizer`). On the card a window of K
lockstep steps is one CUDA graph, as a solo window is
(``parallel/spmd_base.py``); on the CPU the plain version runs K eager steps.

The JAX package vmaps the solo step, which keeps each member bit for bit on
its solo trajectory. Here a batched product may round unlike the solo one,
so a member is held to its solo run within a tolerance (``tests/
test_torch_fused.py``; the card's figure in ``PERF.md``).

Lifecycle, as in the JAX package: ``fusion_candidates`` proposes groups of
one :func:`fusion_fingerprint`, the trial runner measures the stacked
lockstep time (``Strategy.fused_per_batch_time``), the solver prices fusion
against solo and co-scheduled runs (``solver/milp.py``), and the engine's
fused launcher drives :func:`run_fused_interval`. Its unfuse path slices a
member out of the stack at a unit boundary (a guardian detach), crosses the
``fused.unfuse`` crash barrier, checkpoints the member as the sharded
manifest a solo run restores (in the JAX tree, as the JAX package writes a
member's), emits a ``fused_unfuse`` event and goes on with the other members.

Only one device is carried: a stack never spans a multi-device block
(``usable_devices``), and a task whose ``chip_range`` allows more than one
device does not fuse (``fusion_candidates``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import timeit
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from saturn_tpu_torch.health import sentinel
from saturn_tpu_torch.ops import stacking
from saturn_tpu_torch.parallel.spmd_base import _Bundle, observed_losses, stage_tokens, unit_plan
from saturn_tpu_torch.utils import checkpoint as ckpt
from saturn_tpu_torch.utils import metrics, timing

log = logging.getLogger("saturn_tpu_torch")

#: Version of the fusion machinery in the fingerprint: bump when the stacked
#: program's semantics change.
FUSION_SET_VERSION = 1


def fusion_signature() -> str:
    return f"fused-stack-v{FUSION_SET_VERSION}"


# ----------------------------------------------------------- fingerprinting
def fusion_fingerprint(task: Any) -> Optional[str]:
    """Compatibility key: two tasks may share a stack iff their fingerprints
    match. It covers what the stacked program's shape depends on (the model
    config, the meta-device parameters, the batch shape and dtype, the
    optimizer, the loss) and leaves out what rides along per member (lr).
    None: the task cannot fuse (a user optimizer callable, a model without a
    stacked forward, a model factory that fails); None matches nothing.
    Cached on the task."""
    cached = getattr(task, "_fusion_fingerprint", False)
    if cached is not False:
        return cached
    fp = _fingerprint_uncached(task)
    task._fusion_fingerprint = fp
    return fp


def _fingerprint_uncached(task: Any) -> Optional[str]:
    opt = task.hparams.optimizer
    if not isinstance(opt, str):
        return None  # a callable optimizer has no comparable identity
    try:
        spec = task.get_model()
        eb = np.asarray(task.get_dataset().example_batch())
        model = spec.abstract_init()
    except Exception as e:
        log.debug("fusion_fingerprint(%s) failed: %r", getattr(task, "name", "?"), e)
        return None
    if spec.stacked_loss_fn is None or spec.stacked_model_fn is None:
        return None
    cfg = getattr(spec, "config", None)
    try:
        cfg_sig = (sorted((k, repr(v)) for k, v in vars(cfg).items())
                   if cfg is not None and hasattr(cfg, "__dict__") else repr(cfg))
    except TypeError:
        cfg_sig = repr(cfg)
    param_sig = [(n, tuple(p.shape), str(p.dtype)) for n, p in model.named_parameters()]
    loss_tag = getattr(task.loss_fn, "supports_fused_head", None) or getattr(
        task.loss_fn, "__name__", repr(task.loss_fn))
    payload = json.dumps({
        "fusion": fusion_signature(),
        "config": cfg_sig,
        "params": param_sig,
        "batch": [tuple(eb.shape), str(eb.dtype)],
        "optimizer": opt,
        "loss": loss_tag,
    }, sort_keys=True, default=repr)
    return hashlib.sha1(payload.encode()).hexdigest()


def fusion_candidates(task_list: Sequence[Any], min_members: int = 2,
                      max_members: int = 8) -> List[List[str]]:
    """Fusable sets among ``task_list``: groups of task names sharing a
    :func:`fusion_fingerprint`, oversized cohorts split into chunks of
    ``max_members``. Only tasks confined to one device fuse: a task that may
    run on a wider block would train with other arithmetic depending on
    whether the scheduler fused it (the JAX package's rule)."""
    by_fp: Dict[str, List[str]] = {}
    for t in task_list:
        fp = fusion_fingerprint(t)
        if fp is None:
            continue
        widths = getattr(t, "chip_range", None) or []
        if any(int(c) != 1 for c in widths):
            continue
        by_fp.setdefault(fp, []).append(t.name)
    groups: List[List[str]] = []
    for names in by_fp.values():
        step = max(int(max_members), 2)
        for i in range(0, len(names), step):
            chunk = names[i:i + step]
            if len(chunk) >= max(int(min_members), 2):
                groups.append(chunk)
    return groups


def usable_devices(devices: Sequence[Any], n_members: int) -> List[Any]:
    """The devices a stack of ``n_members`` runs on: one, the block's first
    (the JAX package shards the member axis over the largest prefix of the
    block that divides it; multi-device blocks are a later item here)."""
    return list(devices[:1])


# ----------------------------------------------------------- the optimizer
class StackedOptimizer:
    """AdamW, Adam or SGD over stacked parameters with a per-member lr.

    ``HParams.make_optimizer``'s math (optax's: b1 0.9, b2 0.999, eps 1e-8,
    AdamW's weight decay 1e-4), member by member, in tensor ops over the
    stacked tensors: the lr is an (M,) tensor broadcast as (M, 1, ...), the
    bias corrections read an (M,) step count on the device, and the moments
    are allocated with the optimizer, so its step reads nothing back to the
    host and a CUDA graph can capture it (torch's ``capturable`` update:
    torch's optimizers take one scalar lr per parameter group, and slices of
    one stacked parameter cannot be parameters of their own). ``state``
    maps each parameter to its moments, as a torch optimizer's does. (Torch's
    functional update run per member over its views was tried too: the
    lockstep step took 1-7 % longer, ``PERF.md`` §6.)"""

    BETAS = (0.9, 0.999)
    EPS = 1e-8
    WEIGHT_DECAY = 1e-4

    def __init__(self, params: Sequence[torch.Tensor], name: str, lrs: Sequence[float]):
        if name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"a stacked optimizer is adamw, adam or sgd, got {name!r}")
        self.params = list(params)
        self.name = name
        device = self.params[0].device
        self.lr = torch.tensor([float(v) for v in lrs], dtype=torch.float32, device=device)
        self.steps = torch.zeros(len(lrs), dtype=torch.float32, device=device)
        self.state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        if name != "sgd":
            for p in self.params:
                self.state[p] = {"exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}

    def _b(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return t.view((-1,) + (1,) * (p.dim() - 1))

    @torch.no_grad()
    def step(self) -> None:
        if self.name == "sgd":
            for p in self.params:
                p.sub_(self._b(self.lr, p) * p.grad)
            return
        b1, b2 = self.BETAS
        self.steps.add_(1.0)
        bc1 = 1.0 - torch.pow(b1, self.steps)
        bc2_sqrt = (1.0 - torch.pow(b2, self.steps)).sqrt()
        step_size_neg = -(self.lr / bc1)
        decay = 1.0 - self.lr * self.WEIGHT_DECAY
        for p in self.params:
            g, st = p.grad, self.state[p]
            m, v = st["exp_avg"], st["exp_avg_sq"]
            if self.name == "adamw":
                p.mul_(self._b(decay, p))
            m.lerp_(g, 1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            ssn = self._b(step_size_neg, p)
            denom = (v.sqrt() / (self._b(bc2_sqrt, p) * ssn)).add_(self.EPS / ssn)
            p.addcdiv_(m, denom)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None


# ---------------------------------------------------------- the program
class _SoloView:
    """A member's parameters as a module's ``state_dict`` and
    ``named_parameters`` (what a checkpoint write reads of
    ``state["params"]``); ``jax_layout`` where the solo model has the JAX
    package's tree (``models/convert.jax_layout``)."""

    def __init__(self, sd: "OrderedDict[str, torch.Tensor]", jax_layout: bool = False):
        self._sd = sd
        self.jax_layout = jax_layout

    def state_dict(self):
        return self._sd

    def named_parameters(self):
        return iter(self._sd.items())


@dataclass
class FusedProgram:
    """The stacked program of one (fingerprint, config, N, device)."""

    n_members: int
    device: torch.device
    spec: Any
    opt_name: str
    member_batch_shape: Tuple[int, ...]
    bundle: _Bundle
    names: List[str]                   # the parameter names, in order
    _init_tree: Any = None
    _lock: Any = field(default_factory=threading.Lock)

    @property
    def jax_layout(self) -> bool:
        """Whether a member's solo model has the JAX package's tree, which
        its checkpoint then keys by (``models/convert.state_layout``)."""
        from saturn_tpu_torch.models.convert import jax_layout

        return jax_layout(self.spec.abstract_init())

    def new_state(self, lrs: Sequence[float]) -> Dict[str, Any]:
        """An uninitialised stacked state of the program's N members:
        ``{params, opt_state, step, base}`` (``step`` counts the stack's
        lockstep steps, ``base[i]`` member i's step before them)."""
        if len(lrs) != self.n_members:
            raise ValueError(f"{len(lrs)} lrs for a stack of {self.n_members}")
        model = self.spec.stacked_model_fn(self.n_members, self.device)
        opt = StackedOptimizer(list(model.parameters()), self.opt_name, lrs)
        return {"params": model, "opt_state": opt, "step": 0,
                "base": [0] * self.n_members}

    def tree(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The stacked state as a dict of (N, ...) tensors (views): the
        parameters, the moments and the optimizer's step counts."""
        model, opt = state["params"], state["opt_state"]
        params = OrderedDict((n, p.detach()) for n, p in model.named_parameters())
        out = {"params": params, "opt_step": opt.steps}
        if opt.name != "sgd":
            out["exp_avg"] = OrderedDict((n, opt.state[p]["exp_avg"])
                                         for n, p in model.named_parameters())
            out["exp_avg_sq"] = OrderedDict((n, opt.state[p]["exp_avg_sq"])
                                            for n, p in model.named_parameters())
        return out

    def init_member_tree(self) -> Dict[str, Any]:
        """A fresh member's tree on the host: the solo init (seed 0, the
        solo ``bundle.init()``'s weights) and zero moments, made once."""
        with self._lock:
            if self._init_tree is None:
                model = self.spec.init_fn(torch.Generator().manual_seed(0), torch.device("cpu"))
                params = OrderedDict((n, p.detach()) for n, p in model.named_parameters())
                tree = {"params": params, "opt_step": torch.tensor(0.0)}
                if self.opt_name != "sgd":
                    tree["exp_avg"] = OrderedDict((n, torch.zeros_like(p))
                                                  for n, p in params.items())
                    tree["exp_avg_sq"] = OrderedDict((n, torch.zeros_like(p))
                                                     for n, p in params.items())
                self._init_tree = tree
            return self._init_tree

    def member_tree_from_payload(self, saved: Dict[str, Any]) -> Dict[str, Any]:
        """A member's tree from a solo checkpoint's payload (``checkpoint.
        load``): parameters by name, moments by the parameter order."""
        params = OrderedDict((n, saved["params"][n]) for n in self.names)
        per = saved["opt_state"].get("state", {})
        tree = {"params": params,
                "opt_step": torch.as_tensor(
                    per.get(0, {}).get("step", 0.0), dtype=torch.float32).reshape(())}
        if self.opt_name != "sgd":
            for key in ("exp_avg", "exp_avg_sq"):
                tree[key] = OrderedDict(
                    (n, per[i][key] if i in per else torch.zeros_like(params[n]))
                    for i, n in enumerate(self.names))
        return tree

    def member_state(self, state: Dict[str, Any], i: int, task: Any) -> Dict[str, Any]:
        """Member ``i`` of a stacked state in the solo format
        ``checkpoint.save`` writes and a solo run restores: its parameters
        (views of slice i), a torch optimizer of the member's hparams holding
        its moments and step count, and its step."""
        tree = stacking.member_slice(self.tree(state), i)
        params = tree["params"]
        opt = task.hparams.make_optimizer(list(params.values()))
        n_steps = tree["opt_step"].detach().reshape(()).to("cpu", torch.float32)
        for n, p in params.items():
            if self.opt_name == "sgd":
                opt.state[p] = {"momentum_buffer": None}
            else:
                opt.state[p] = {"step": n_steps.clone(), "exp_avg": tree["exp_avg"][n],
                                "exp_avg_sq": tree["exp_avg_sq"][n]}
        return {"params": _SoloView(params, self.jax_layout), "opt_state": opt,
                "step": int(state["base"][i]) + int(state["step"])}


#: (fingerprint, config, N, device) -> FusedProgram. An unfuse from N to N-1
#: members reuses an (N-1)-stack of the same fingerprint.
_PROGRAMS: Dict[Any, FusedProgram] = {}
_PROGRAMS_LOCK = threading.Lock()


def _selected(rep: Any, inner: Any, config: Optional[Dict[str, Any]]):
    if inner is None and rep.selected_strategy is not None:
        inner = rep.selected_strategy.executor
    if config is None:
        sel = rep.selected_strategy
        config = dict(sel.params or {}) if sel is not None else {}
    return inner, dict(config)


def build_fused_program(members: Sequence[Any], devices: Sequence[Any],
                        inner: Optional[Any] = None,
                        config: Optional[Dict[str, Any]] = None) -> FusedProgram:
    """The stacked program for ``members`` (built once per fingerprint,
    config, member count and device). ``inner`` is the technique whose
    ``fused_loss_ok`` and model overrides apply (member 0's selected
    executor by default). Every member must share a fusion fingerprint."""
    if not members:
        raise ValueError("build_fused_program: empty member list")
    rep = members[0]
    inner, config = _selected(rep, inner, config)
    fp = fusion_fingerprint(rep)
    if fp is None:
        raise ValueError(f"task {rep.name!r} is not fusable (no fusion fingerprint)")
    for m in members[1:]:
        if fusion_fingerprint(m) != fp:
            raise ValueError(f"fused member {m.name!r} has a different fusion fingerprint "
                             f"than {rep.name!r} — the group is not stack-compatible")
    dev = torch.device(usable_devices(devices, len(members))[0])
    key = (fp, tuple(sorted(config.items())), len(members), str(dev))
    with _PROGRAMS_LOCK:
        hit = _PROGRAMS.get(key)
    if hit is not None:
        return hit
    prog = _build_program(rep, len(members), dev, inner, config)
    with _PROGRAMS_LOCK:
        return _PROGRAMS.setdefault(key, prog)


def uses_fused_head(spec: Any, loss_fn: Any, fused_loss_ok: bool = True) -> bool:
    """Whether a member's step runs the fused CE head: exactly where its
    solo step would (``SPMDTechnique.step_fns_from_forward``'s rule)."""
    tag = getattr(loss_fn, "supports_fused_head", None)
    return (getattr(spec, "fused_loss_fn", None) is not None and fused_loss_ok
            and spec.apply_with_aux_fn is None and tag is not None
            and tag == getattr(spec, "fused_loss_objective", None))


def _build_program(rep: Any, n: int, dev: torch.device, inner: Any,
                   config: Dict[str, Any]) -> FusedProgram:
    overrides = inner._model_overrides(config) if inner is not None else {}
    spec = rep.get_model(**overrides)
    fused_ce = uses_fused_head(spec, rep.loss_fn, bool(getattr(inner, "fused_loss_ok", True)))
    loss_fn = None if fused_ce else rep.loss_fn
    eb = np.asarray(rep.get_dataset().example_batch())

    def train_step(state, batch):
        model, opt = state["params"], state["opt_state"]
        losses = spec.stacked_loss_fn(model, batch, loss_fn)
        losses.sum().backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return state, losses.detach()

    def unused():
        raise RuntimeError("a fused program's state comes from FusedProgram.new_state")

    bundle = _Bundle(device=dev, init=unused, empty=unused, step=train_step,
                     loss_shape=(n,))
    names = [name for name, _ in spec.abstract_init().named_parameters()]
    return FusedProgram(n_members=n, device=dev, spec=spec, opt_name=rep.hparams.optimizer,
                        member_batch_shape=tuple(eb.shape), bundle=bundle, names=names)


def release_programs() -> None:
    """Free every stacked program's CUDA graphs and graph memory pools."""
    with _PROGRAMS_LOCK:
        progs = list(_PROGRAMS.values())
        _PROGRAMS.clear()
    for prog in progs:
        prog.bundle.release_windows()


# ----------------------------------------------------------- stacked states
@torch.no_grad()
def _load_member(prog: FusedProgram, state: Dict[str, Any], i: int, tree: Dict[str, Any]):
    """Copy a member's tree (host or device) into slice ``i`` of ``state``."""
    dst = stacking.member_slice(prog.tree(state), i)
    stacking.tree_map(lambda d, s: d.copy_(s), dst, tree)


def stack_state(prog: FusedProgram, trees: Sequence[Dict[str, Any]], lrs: Sequence[float],
                bases: Sequence[int]) -> Dict[str, Any]:
    """A stacked state of ``prog`` holding the members' trees, slice by
    slice (no second copy of the stack)."""
    state = prog.new_state(lrs)
    for i, tree in enumerate(trees):
        _load_member(prog, state, i, tree)
    state["base"] = [int(b) for b in bases]
    return state


def _live_key(fp: str, config: Dict[str, Any], dev: torch.device, names: Sequence[str]):
    return ("fused", fp, tuple(sorted(config.items())), str(dev), tuple(names))


def _resume(members: Sequence[Any], prog: FusedProgram, key) -> Dict[str, Any]:
    """The stacked state of ``members``: the live stack when every member
    holds the same one under ``key`` (the previous interval ran this group),
    else each member's checkpoint (its data cursor follows the step) or a
    fresh init. Every member's live state is dropped first."""
    lives = [m._live_state for m in members]
    for m in members:
        m._live_state = None
    if all(lv is not None and lv[0] == key for lv in lives) and all(
            lv[1] is lives[0][1] for lv in lives):
        return lives[0][1]
    del lives
    trees, bases = [], []
    for m in members:
        if m.has_ckpt():
            saved = ckpt.load(m.ckpt_path)
            trees.append(prog.member_tree_from_payload(saved))
            bases.append(int(saved["step"]))
            m.current_batch = m.cursor_for_step(int(saved["step"]))
        else:
            trees.append(prog.init_member_tree())
            bases.append(0)
    return stack_state(prog, trees, [m.hparams.lr for m in members], bases)


def _shrink(prog: FusedProgram, new_prog: FusedProgram, state: Dict[str, Any], i: int,
            members: Sequence[Any]) -> Dict[str, Any]:
    """The state with member ``i`` sliced out, on ``new_prog``'s N-1 stack
    (``members`` are the survivors)."""
    tree = stacking.remove_member(prog.tree(state), i)
    bases = [b for j, b in enumerate(state["base"]) if j != i]
    out = new_prog.new_state([m.hparams.lr for m in members])
    with torch.no_grad():
        stacking.tree_map(lambda d, s: d.copy_(s), new_prog.tree(out), tree)
    out["base"] = [b + int(state["step"]) for b in bases]
    return out


# --------------------------------------------------------------- intervals
@dataclass
class MemberResult:
    """One member's outcome of a fused interval."""

    name: str
    steps: int = 0                      # batches retired in the stack
    final_loss: Optional[float] = None
    fault: Optional[BaseException] = None   # sentinel fault (state discarded)
    detached_at: Optional[int] = None   # unfuse point (interval-relative)


@dataclass
class FusedIntervalReport:
    """What :func:`run_fused_interval` hands back to the engine."""

    n_steps: int
    window: int
    members: Dict[str, MemberResult]
    detached: List[Tuple[Any, int]]     # (task, steps retired at the unfuse)
    per_step_s: float = 0.0             # steady-state lockstep seconds
    samples_per_sec: float = 0.0        # over the whole stack
    elapsed_s: float = 0.0
    losses: Dict[str, List[float]] = field(default_factory=dict)


def _stage(members: Sequence[Any], starts: Dict[str, int], prog: FusedProgram,
           off: int, size: int, kind: str) -> torch.Tensor:
    """The (M, B, T) lockstep batch at interval offset ``off``, or the
    (K, M, B, T) window of ``size`` batches, staged on the device."""
    names = [m.name for m in members]

    def at(j):
        return stacking.stack_member_batches(
            [m.batch_at(starts[m.name] + j) for m in members], member_names=names,
            expect=prog.member_batch_shape)

    host = np.stack([at(off + j) for j in range(size)]) if kind == "window" else at(off)
    return stage_tokens(host, prog.device)


def run_fused_interval(
    members: Sequence[Any],
    devices: Sequence[Any],
    tid: int = 0,
    batch_counts: Optional[Sequence[int]] = None,
    inner: Optional[Any] = None,
    config: Optional[Dict[str, Any]] = None,
    window_size: Optional[int] = None,
    detach_requested: Optional[Callable[[Any], bool]] = None,
    publish_gate: Optional[Callable[[], None]] = None,
) -> FusedIntervalReport:
    """One engine interval of a fused group: lockstep batches for every
    member through the stacked program.

    The lockstep budget is the least of the members' budgets (the engine
    gives the others their shortfall back). The interval runs as the solo
    path's ``unit_plan``: ``n // K`` windows (CUDA graphs of K lockstep
    steps on the card) and a tail of one-step windows, an eager warm-up
    step first on a state no window of the program has captured.

    ``detach_requested`` (default: the member's ``_fused_detach`` flag, set
    by the guardian) is polled at every unit boundary: a detaching member
    is unfused (its slice checkpointed after the ``fused.unfuse`` barrier,
    a ``fused_unfuse`` event, the stack rebuilt without it) and returned in
    ``report.detached`` for the engine to resume solo. Sentinel faults are
    per member, over each member's loss column as ``sentinel.fold`` folds a
    solo interval: a faulted member's interval is discarded (no checkpoint,
    no live state) while the others commit. ``publish_gate`` (the engine's
    preemption check) is called after the readback, before any member's
    fold or checkpoint: where it raises, the whole interval is discarded."""
    if not members:
        raise ValueError("run_fused_interval: empty group")
    detach_requested = detach_requested or (lambda t: bool(getattr(t, "_fused_detach", False)))
    cur: List[Any] = list(members)
    inner, config = _selected(cur[0], inner, config)
    budgets = [int(b) for b in (batch_counts if batch_counts is not None
                                else [m.total_batches for m in cur])]
    n = max(min(budgets), 0) if budgets else 0
    report = FusedIntervalReport(n_steps=n, window=1,
                                 members={m.name: MemberResult(name=m.name) for m in cur},
                                 detached=[])
    if n <= 0:
        return report

    fp = fusion_fingerprint(cur[0])
    prog = build_fused_program(cur, devices, inner=inner, config=config)
    state = _resume(cur, prog, _live_key(fp, config, prog.device, [m.name for m in cur]))
    starts = {m.name: m.current_batch for m in cur}
    k = inner._window(cur[0], window_size) if inner is not None else 1
    report.window = k
    names0 = [m.name for m in cur]
    batch_size = int(prog.member_batch_shape[0]) if prog.member_batch_shape else 1

    # per-segment loss columns: (member names, [(steps, N) host-bound tensors])
    segments: List[Tuple[List[str], List[torch.Tensor]]] = []
    seg: List[torch.Tensor] = []
    done = 0
    first_unit = None
    t_all0 = t_steady = timeit.default_timer()
    while done < n:
        leaving = [m for m in cur if detach_requested(m)]
        if leaving and len(cur) - len(leaving) >= 1:
            if seg:
                segments.append(([m.name for m in cur], seg))
                seg = []
            for m in leaving:
                idx = cur.index(m)
                ckpt.barrier("fused.unfuse", task=m.name, step=done, tid=tid)
                ckpt.save(m.ckpt_path, prog.member_state(state, idx, m))
                metrics.event("fused_unfuse", task=m.name, group=names0, step=done,
                              n_remaining=len(cur) - 1)
                log.info("fused group: unfused member %s at interval step %d (%d member(s) "
                         "remain)", m.name, done, len(cur) - 1)
                report.members[m.name].steps = done
                report.members[m.name].detached_at = done
                report.detached.append((m, done))
                cur.pop(idx)
                new_prog = build_fused_program(cur, devices, inner=inner, config=config)
                state = _shrink(prog, new_prog, state, idx, cur)
                prog = new_prog
        elif leaving:
            log.warning("fused group: detach requested for every member — finishing the "
                        "interval fused (nothing to unfuse into)")
        bundle = prog.bundle
        units = unit_plan(n - done, k, warm=k > 1 and not bundle.warmed(state))
        sizes = sorted({size for kind, _, size in units if kind == "window"}, reverse=True)
        for u, (kind, off, size) in enumerate(units):
            if u > 0 and any(detach_requested(m) for m in cur) and len(cur) > 1:
                break  # unfuse at the outer boundary
            batch = _stage(cur, starts, prog, done, size, kind)
            if kind == "warm":
                state, loss = bundle.warm_step(state, batch)
            if u == 0 and sizes:
                bundle.capture(sizes, state, batch.shape[-3:])
            if kind == "window":
                state, loss = bundle.fused(size)(state, batch)
            elif kind == "step":
                state, loss = bundle.step(state, batch)
            seg.append(loss.reshape(size, len(cur)))
            done += size
            if first_unit is None and n > size:
                first_unit = size
                # the first unit pays one-time costs (captures): keep it out
                # of the realized lockstep time
                timing.synchronize(prog.device)
                t_steady = timeit.default_timer()
    if seg:
        segments.append(([m.name for m in cur], seg))

    # one readback for the interval, then the per-member folds
    host = [(names, torch.cat(mats).float().cpu().numpy()) for names, mats in segments]
    t_end = timeit.default_timer()
    if publish_gate is not None:
        try:
            publish_gate()
        except Exception:
            state = None
            raise
    # each member's column; a detached member's ends at its unfuse point
    # (its solo resume owns the rest)
    columns: Dict[str, List[np.ndarray]] = {nm: [] for nm in names0}
    for names, mat in host:
        for i, nm in enumerate(names):
            columns[nm].append(mat[:, i])
    for m, _ in report.detached:
        report.losses[m.name] = np.concatenate(columns[m.name]).tolist() \
            if columns[m.name] else []
    cfg = sentinel.get_config()
    faulted: set = set()
    for m in cur:
        vec = np.concatenate(columns[m.name]) if columns[m.name] else np.zeros(0, np.float32)
        report.losses[m.name] = vec.tolist()
        # a fault injector's poisoning of this member's observed column,
        # never of the stack's state (the solo path's ``_screen``)
        poison = vars(m).pop("_health_poison", None)
        if not len(vec):
            continue
        if cfg.enabled:
            seen = observed_losses(vec, poison, lambda j, m=m: m.dataset_index(starts[m.name] + j))
            carry = m._sentinel_carry if m._sentinel_carry is not None else sentinel.carry_init()
            rep = sentinel.fold(carry, seen, cfg)
            fault = sentinel.inspect(rep)
            if fault is not None:
                cause, first_off, bad_count = fault
                bad = {int(j) for j in np.flatnonzero(~np.isfinite(seen))} | {int(first_off)}
                batches = tuple(sorted({m.dataset_index(starts[m.name] + j) for j in bad}))
                window = first_off // max(k, 1)
                report.members[m.name].fault = sentinel.NumericFaultError(
                    m.name, window, cause, step=first_off,
                    loss=float(rep[sentinel.REP_LAST_LOSS]), batch_indices=batches,
                    bad_count=bad_count)
                metrics.event("task_numeric_fault", task=m.name, cause=cause, window=window,
                              step=int(first_off), bad_count=int(bad_count),
                              batches=list(batches), fused=True)
                log.warning("fused member %s: sentinel tripped (%s) at interval step %d — "
                            "discarding the member's interval", m.name, cause, first_off)
                faulted.add(m.name)
                continue
            m._sentinel_carry = rep[:2].copy()
        report.members[m.name].final_loss = float(vec[-1])
        report.members[m.name].steps = n
        m.last_losses = vec.tolist()

    # per-member checkpoints in the solo format; the stack stays live for
    # the members that committed (a faulted member restores its checkpoint)
    key = _live_key(fp, config, prog.device, [m.name for m in cur])
    for i, m in enumerate(cur):
        if m.name not in faulted:
            ckpt.save_async(m.ckpt_path, prog.member_state(state, i, m))
    if not faulted:
        for m in cur:
            m._live_state = (key, state)
    per_step = ((t_end - t_steady) / max(n - first_unit, 1) if first_unit is not None
                else (t_end - t_all0) / max(n, 1))
    report.per_step_s = per_step
    report.elapsed_s = t_end - t_all0
    report.samples_per_sec = n * len(names0) * batch_size / max(report.elapsed_s, 1e-9)
    final = {nm: round(r.final_loss, 6) for nm, r in report.members.items()
             if r.final_loss is not None}
    metrics.event("fused_interval", members=names0, n_members=len(names0), batches=n,
                  window=k, per_step_s=per_step,
                  samples_per_sec=round(report.samples_per_sec, 2), losses=final,
                  detached=[m.name for m, _ in report.detached], faulted=sorted(faulted))
    log.info("fused group %s: ran %d lockstep batches (K=%d, %d members, %.4fs/lockstep "
             "step, %.1f samples/s)", names0, n, k, len(names0), per_step,
             report.samples_per_sec)
    return report


def time_stacked(members: Sequence[Any], devices: Sequence[Any], inner: Any = None,
                 config: Optional[Dict[str, Any]] = None, n_windows: int = 2
                 ) -> Tuple[float, Dict[str, Any]]:
    """Seconds per lockstep step of the stacked program of ``members`` on a
    fresh init, timed as a solo trial times its window: one eager warm-up
    step, then ``timing.time_fused_window`` over windows of K (the K that
    ``execute`` dispatches), every window staged before the timed region;
    with K = 1 single steps. Also returns the peak device memory. Reads
    batches with ``batch_at`` and neither checkpoints nor moves a cursor.
    The program's graphs are freed after."""
    prog = build_fused_program(members, devices, inner=inner, config=config)
    inner, config = _selected(members[0], inner, config)
    dev = prog.device
    k = inner._window(members[0]) if inner is not None else 1
    starts = {m.name: 0 for m in members}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    timing.reset_peak_memory(dev)
    state = stack_state(prog, [prog.init_member_tree()] * len(members),
                        [m.hparams.lr for m in members], [0] * len(members))
    bundle = prog.bundle
    try:
        state, _ = bundle.warm_step(state, _stage(members, starts, prog, 0, 1, "warm"))
        if k > 1:
            t = timing.time_fused_window(
                bundle.fused(k), state,
                lambda j: _stage(members, starts, prog, 1 + j * k, k, "window"), k,
                n_timed=n_windows, n_warmup=1)
        else:
            t = timing.time_train_step(bundle.step, state,
                                       _stage(members, starts, prog, 1, 1, "step"),
                                       n_timed=3, n_warmup=1)
        peak = timing.peak_memory_bytes(dev)
    finally:
        del state
        bundle.release_windows()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return t, {"peak_bytes": peak, "k": k}
