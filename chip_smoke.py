#!/usr/bin/env python3
"""Drive the PyTorch port (``saturn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an exception and a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, and the build of the CUDA kernels from
   ``saturn_tpu_torch/csrc/flash_attn.cu`` and ``csrc/linear_ce.cu`` (one
   ``nvcc`` each, started together), with each kernel's ptxas line and the
   wgmma / TMA / cp.async / mma.sync / setmaxnreg instructions in its SASS
   (``cuobjdump``); the flash kernels (the forward at head dim 64 and 128,
   the head-dim-256 forward, dQ, dK/dV) and the CE forward, ds, dx and dW
   kernels must hold wgmma and TMA tile loads, the head-dim-256 forward,
   dQ and dK/dV also setmaxnreg.
2. Kernels against their plain PyTorch versions: flash forward, dQ and
   dK/dV at the GPT-2-small training shape (B 8, H 12, T 512, D 64, bf16,
   causal), a grouped-query shape (B 2, H 32, KV 4, T 1024, D 64), the main
   shape non-causal (BERT-base's), one tile (T 64), T 320 (T % 128 == 64),
   head dim 128 with grouped queries (H 8, KV 2) and, with long walks, (B 4,
   H 16, KV 4, T 2048), causal and not; the CE head's forward,
   dx and dW at the main shape (N 4096, D 768, V 50304), at an odd shape
   (N 4000, V 50257, the last 64 labels ignored), at D 1024 and at D 64 (odd
   shape), each in stash and in recompute mode, and in recompute mode over
   five vocab slabs, the last ragged (N 6000, V 50257, labels at every slab's
   edge columns, an ignored tail); the recompute-mode ds kernel alone on one
   slab at the main and the five-slab shape; and the shapes of phase 4's
   b8 x 1024 run: the CE head in recompute mode and its ds kernel at N 8192,
   D 768, V 50304 (seven slabs), the flash kernels at B 8, H 12, T 1024,
   causal; and head dim 256, GPT-J-6B's attention in phase 8b: timed at
   (B 8, H 16, T 512), causal, checked with grouped queries at T 192 and
   320, causal and not, on one tile, causal and not, at T 1024 and at B 1,
   H 1, and the forward, dQ and dK/dV run twice bitwise equal. Each
   kernel's device time, the plain version's and the library call's, all
   read from torch.profiler, and the kernel's bound on the card.
   The library call of a forward kernel is the library's forward (SDPA; the
   unfused ``F.linear`` + ``F.cross_entropy``), of a backward kernel the
   library's backward alone, run on a graph built outside the timed window.
   Beside each CE kernel, the time of cuBLAS on its product alone
   (``torch.matmul`` of x by Wᵀ with a bf16 (N, V) result beside
   ``ce_fwd``, of the bf16 (N, V) stash by the (V, D) W beside ``ce_dx``, of
   a bf16 (V, N) by the (N, D) x beside ``ce_dw``): yardsticks, in no table
   column.
3. The port's main path at full width: a heterogeneous sweep of two
   GPT-2-small tasks (b8 x 512, differing only in lr, ``pretraining_loss``)
   and one BERT-base task (b8 x 512, ``mlm_loss``), synthetic data, through
   ``register_default_library`` -> ``search(["dp"])`` (with a fresh profile
   cache under ``chiprun_out/``, so its trials run: one per signature, the
   second GPT-2 task is a cache hit) -> ``orchestrate`` (its defaults: the
   anytime solver, the health guardian) in intervals of INTERVAL_SHARE of
   the shortest task's profiled runtime, so that each task runs several; every
   checkpoint must reach its ``batch_count`` with finite, falling losses,
   and all six kernels must have run. Trials time K-step windows (K =
   ``max_window()``, 8) and the intervals run through them, the tail and
   short intervals through a window of one step: each interval's K,
   windows, tail, eager warm-up step and capture time are logged, and an
   interval whose config did not change must not have restored the
   checkpoint. The kernel launch counts of this phase go into the kernels
   line.
4. The kernels on the training path: dp ``execute`` of GPT-2-small for 10
   steps pinned to flash attention, from the same init and batches as a run
   pinned to dense and a flash run over the logits (a loss without the
   fused-head tag), each run twice: in windows of 8 (an eager step, the
   captures, one window, a tail of one one-step window) and one step at a
   time. Exactly 12
   launches of each flash kernel and 1 of each CE kernel per step where they
   apply, none elsewhere, in both runs; the windowed losses equal the eager
   ones within WINDOW_ATOL per step (the log says whether bitwise); the
   three configs' trajectories agree within the bf16 band. Then GPT-2-small
   at its published context, b8 x 1024 (N 8192), where ``ce.auto_stash``
   picks recompute mode: flash + fused head in windows of 8 and eager, and
   flash over the logits eager as the loss reference, with the same checks,
   the peak memory of each run, and the size of the recompute-mode ds
   scratch (N x ``ce.slab_width`` bf16) held under ``ce.SLAB_BYTES_MAX``.
5. Where a step's time goes, for the three pinned configs: synchronized
   per-step times, peak device memory, and a torch.profiler window (device
   busy share, each kernel's launches and device time inside the step, top
   operators). For flash + fused also the steady-state per-batch time of 3
   windows of 8 without a synchronize between them, beside the eager path's
   over the same 24 steps, in turns; the device busy time and idle share
   over the windows, with each kernel's launches per step as the profiler
   saw them inside the replays (they must be phase 4's); the peak memory of
   the windows. The same windows profile for flash + fused at b8 x 1024
   (recompute mode).
6. A sweep past the MILP's task limit: 13 GPT-2-small tasks (b8 x 512,
   synthetic data, 16 batches each) through ``search(["dp"])`` and
   ``orchestrate`` with the defaults (the health guardian, the anytime
   solver) and a fresh profile cache. Twelve differ only in lr
   (``pretraining_loss``, the fused head); the 13th runs an untagged loss
   over the logits that is NaN on its dataset's batch 12 (a marked row:
   sqrt(-1) computed on the card inside the captured window). Checked:
   the first search runs 2 trials (one per signature) and answers 11 from
   the cache, a repeat search runs none; the 13th task faults after a
   checkpoint, is retried from it, has batch 12 quarantined after its
   second fault and completes; every checkpoint written holds finite
   weights (checked before each write); every task completes with finite
   losses below the initial one; the metrics file holds the solve, solver
   tier, profile-cache and guardian events; the memory allocated falls
   back once the tasks complete. Printed: the solve's tier, wall time and
   makespan against the serial sum of runtimes, the peak memory, the
   checkpoint bytes written (the phase then deletes its checkpoints) and
   the phase's time. Its kernel launches join phase 3's in the kernels line.
7. Kill-replay of a sweep through the durability journal: two GPT-2-small
   tasks (b8 x 512, flash + fused head, ``dp``, AdamW, 16 batches each,
   differing only in lr; search from a profile cache of the phase's own,
   seeded from phase 3's) in intervals of KILL_INTERVAL_SHARE of the
   shortest profiled runtime, so that each task runs at least 3. One
   uninterrupted ``orchestrate(resume_dir=A)`` is the reference; then a
   chain on journal B and a second checkpoint directory, fresh tasks for
   each incarnation: the first killed by ``CrashInjector("mid-fsync",
   hit=2)`` (its journal tail torn), the second by ``("mid-interval",
   hit=1)`` (its checkpoint written, its progress not committed), the third
   running to the end. Checked: every task completes; each final checkpoint
   is at step 16 with parameters and AdamW moments bitwise equal to the
   reference run's; B replays strictly as one ``seq`` chain with the JAX
   package's record kinds and three recoveries, its torn tail in a
   ``.corrupt`` sidecar; B's progress is 16 for each task; the memory
   allocated after each killed incarnation is back where it was before the
   first; all six kernels ran. Printed: the journal's commit times, each
   resume's replay, reconcile (with ``verify`` of each checkpoint) and fold
   times, and the chain's time against the reference run's. Its launches
   are logged apart and leave the kernels line as phases 3 and 6 made it.
8. Host offload (``parallel/offload.py``). a) GPT-2-small b8 x 512 over
   the logits (an untagged loss), 4 steps one at a time from the seed-0
   init under offload stream, offload bulk (remat off) and dp: the offload
   losses within OFFLOAD_REL of dp's (the log says whether bitwise), exact
   flash launches (12 of each kernel per step, the forward twice in
   stream mode, which recomputes every block), the host state pinned, and
   the memory each run holds on the card after its steps under dp's by at
   least the AdamW moments. b) GPT-J-6B at its published shape (28
   layers, d_model 4096, 16 heads, d_ff 16384, rotary 64, parallel
   residual, vocab 50304, b8 x 512, bf16 compute, fp32 params, AdamW; cut
   in depth only, to 24 layers, where the host has less than
   HOST_MIN_BYTES of memory available or the save dir less than
   DISK_MIN_BYTES free, and the facts logged): 8b-1, ``search(["dp",
   "offload"])`` must find every dp config infeasible by the static screen
   (no init drawn) and each offload config timed or out of device memory;
   8b-2, at GPTJ_CKPT_LAYERS (the machine's cap on disk writes a call
   holds no deeper checkpoint), ``search(["offload"])`` and
   ``orchestrate`` train the winner for 4 batches to a checkpoint at step
   4 with exactly one launch of each flash kernel (head dim 256) per layer
   and step (the forward twice where blocks are recomputed); the
   checkpoint, restored in place into a fresh host state, holds finite
   weights, and stream against bulk on it and one batch agree within
   STREAM_BULK_LOSS_REL (loss) and STREAM_BULK_GRAD_REL (gradients by
   relative norm); the card's memory returns to where 8b-2 began. c)
   GPT-J-6B at GPTJ_PARITY_LAYERS over the logits, 4 steps from one seed-0
   init through each technique's bundle (no checkpoint) under offload
   stream, offload bulk and dp: offload's losses within OFFLOAD_REL of dp's,
   exact flash launches. Printed: each step's host->card, compute,
   card->host and host-update seconds, the peak card memory, the pinned
   host bytes, the checkpoint's bytes and write seconds, the host states'
   draw seconds, the trials' kernel launches, and the bytes the run has
   passed to write calls before 8b-2's checkpoint.

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/``.

    python3 chip_smoke.py --flash-sweep [--head-dim D] [--root DIR]

builds the kernels and only times the three flash kernels against SDPA's
forward and backward alone (dQ + dK/dV against the backward) over a sweep
of sequence lengths and batch sizes (``chiprun_out/flash_sweep.json``): how
their time scales with the work. Each time is the median of three profiled
windows, as phase 2 takes it, held to its bound (a time under it is taken
again, and flagged if it stays there). ``--head-dim`` keeps the sweep's rows at
that head dim. ``--root`` times the port of another checkout instead (a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists), built from its own sources and not held to this
script's SASS rules, into ``chiprun_out/flash_sweep_<DIR's name>.json``:
run it beside this tree's sweep in one call to compare two commits on one
card.

    python3 chip_smoke.py --staging-ab

builds the kernels and only times flash + fused at b8 x 512 with each
unit's batch staged inline, as ``execute`` stages it, against staging on a
second thread one unit ahead, in windows of 8 and one step at a time
(``chiprun_out/staging_ab.json``).

    python3 chip_smoke.py --offload

builds the kernels, checks them at head dim 256 and runs phase 8
(``chiprun_out/offload.json``).
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")
CKPTS = os.path.join(REPO, "saturn_ckpts", "chip_smoke")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BF16_BAND = 2e-2           # the bf16 tolerance of tests/test_flash.py and tests/test_ce.py
FLASH_LSE_ATOL = 1e-5      # flash lse (f32) against the plain version, absolute
FLASH_O_ATOL = 2.0 ** -8   # flash o: one bf16 step of the plain value (rtol 2^-7) plus this
FLASH_GRAD_REL = 2e-3      # flash dq, dk and dv against the plain version, by relative norm
                           # (readings on an H100: lse at most 9.5e-7, gradients 4.4e-4)
CE_ROW_ATOL = 1e-4         # CE loss and lse (f32) against the plain version
CE_GRAD_REL = 2e-3         # CE dx and dW against the plain version, by relative norm
                           # (readings on an H100: at most 3.5e-4; loss and lse 7.6e-6)
STEPS_PINNED = 10
WINDOW = 8                 # the window of phases 4 and 5 (DEFAULT_MAX_WINDOW)
WINDOW_ATOL = 1e-5         # windowed against eager losses, absolute per step
INTERVAL_SHARE = 0.55      # phase 3: interval over the shortest task's profiled runtime
# The main path's shapes: GPT-2-small and BERT-base, b8 x 512.
DEVICE = "cuda"
GPT2, BERT = "gpt2-small", "bert-base"
BATCH, SEQ, VOCAB, LAYERS = 8, 512, 50304, 12
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
CE_NAMES = ("ce_fwd", "ce_dx", "ce_dw")
KERNEL_NAMES = FLASH_NAMES + CE_NAMES
SOURCES = {
    "flash_fwd": "saturn_tpu/ops/flash.py:132",
    "flash_dq": "saturn_tpu/ops/flash.py:250",
    "flash_dkv": "saturn_tpu/ops/flash.py:276",
    "ce_fwd": "saturn_tpu/ops/ce.py:208",
    "ce_dx": "saturn_tpu/ops/ce.py:290",
    "ce_dw": "saturn_tpu/ops/ce.py:314",
}
#: How each kernel's launches begin in a profile (``csrc/flash_attn.cu``,
#: ``csrc/linear_ce.cu``).
KERNEL_SYMBOLS = {
    # fwd_kernel<64>, fwd_kernel<128>; fwd_pingpong_kernel at head dim 256
    "flash_fwd": ("(anonymous namespace)::fwd_kernel<",
                  "(anonymous namespace)::fwd_pingpong_kernel("),
    # dq_kernel<64>, dq_kernel<128>; dq_wide_kernel at head dim 256
    "flash_dq": ("(anonymous namespace)::dq_kernel<", "(anonymous namespace)::dq_wide_kernel("),
    # dkv_kernel<64>, dkv_kernel<128>; dkv_wide_kernel at head dim 256
    "flash_dkv": ("(anonymous namespace)::dkv_kernel<",
                  "(anonymous namespace)::dkv_wide_kernel("),
    "ce_fwd": ("(anonymous namespace)::ce_fwd_",),  # ce_fwd_sm90_kernel<, ce_fwd_combine_kernel
    # ce_dx_sm90_kernel<, ce_dx_reduce_kernel
    "ce_dx": ("(anonymous namespace)::ce_dx_",),
    "ce_dw": ("(anonymous namespace)::ce_dw_",),  # ce_dw_sm90_kernel<
}
#: A CE wrapper's second kernel (the forward's combine, dx's split-K
#: reduction): its time counts to the wrapper's, its launches do not.
SECOND_KERNELS = ("ce_fwd_combine_kernel", "ce_dx_reduce_kernel")
#: The recompute-mode ds kernel: ce_dx and ce_dw each launch it once per
#: vocab slab, just before the slab's product kernel.
DS_SYMBOL = "(anonymous namespace)::ce_ds_sm90_kernel"


def log(msg: str) -> None:
    print(msg, flush=True)


#: Instructions counted in each kernel's SASS: wgmma, TMA tile loads,
#: cp.async copies, mma.sync, setmaxnreg.
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA", "USETMAXREG")
#: Kernels whose SASS must hold wgmma and TMA tile loads, by source.
WGMMA_KERNELS = {"flash_attn": ("fwd_kernel", "fwd_pingpong_kernel", "dq_kernel",
                                "dq_wide_kernel", "dkv_kernel", "dkv_wide_kernel"),
                 "linear_ce": ("ce_fwd_sm90_kernel", "ce_ds_sm90_kernel", "ce_dx_sm90_kernel",
                               "ce_dw_sm90_kernel")}
#: Of those, the kernels whose SASS must also hold setmaxnreg (their
#: producer gives registers to their consumers), by source.
SETMAXREG_KERNELS = {"flash_attn": ("fwd_pingpong_kernel", "dq_wide_kernel", "dkv_wide_kernel")}


def sass_kernel_name(fn: str):
    """(kernel name, its int or bool template arguments as digits joined by
    commas, or None) of a mangled SASS function name, or (fn, None) when it
    names no ``*_kernel``."""
    m = re.search(r"((?:ce_)?[a-z]+(?:_[a-z]+)?(?:_sm90)?_kernel)(?:I((?:L[ib]\d+E)+)E)?", fn)
    if not m:
        return fn, None
    return m.group(1), ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m.group(2) else None


def sass_counts(sass: str):
    """{mangled function name: {op: count}} of SASS_OPS in a SASS dump."""
    ops, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            ops[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                ops[fn][op] += op in line
    return ops


def check_sass(cuda_build, src: str) -> None:
    """Log, per kernel of the built library, how many of each SASS_OPS
    instruction its SASS holds (``cuobjdump --dump-sass``); raise if a kernel
    of WGMMA_KERNELS[src] is missing or holds no HGMMA or no UTMALDG, or one
    of SETMAXREG_KERNELS[src] holds no USETMAXREG."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(cuda_build.library_path(src))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    with open(os.path.join(OUT, f"sass_{src}.txt"), "w") as f:
        f.write(sass)
    required, seen = set(WGMMA_KERNELS.get(src, ())), set()
    for fn, counts in sorted(sass_counts(sass).items()):
        base, arg = sass_kernel_name(fn)
        name = f"{base}<{arg}>" if arg else base
        log(f"    SASS {src} {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if base in required:
            seen.add(base)
            missing = [op for op in ("HGMMA", "UTMALDG")
                       + (("USETMAXREG",) if base in SETMAXREG_KERNELS.get(src, ()) else ())
                       if not counts[op]]
            if missing:
                raise AssertionError(f"{name} in {src}: no {' or '.join(missing)} in its SASS")
    if seen != required:
        raise AssertionError(f"no SASS found for {required - seen} in {src}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def topology():
    from saturn_tpu_torch.core.mesh import SliceTopology

    return SliceTopology()


def events_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` between two CUDA events: device
    time plus whatever host work between launches the device waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_events(prof):
    """(name, start us, end us) of every kernel, copy and memset that
    torch.profiler recorded on the card (annotation ranges left out)."""
    from torch.autograd import DeviceType

    return sorted(
        ((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
        key=lambda x: x[1])


class LaunchShapeError(AssertionError):
    """A CE wrapper's kernels ran in a sequence that is no run of launches."""


def ce_run_launches(name: str, run: str) -> int:
    """Launches of the CE wrapper ``name`` in ``run``, the kinds of an
    unbroken run of its events in order: "d" the ds kernel, "p" its product
    kernel, "s" its second kernel. A launch is "p" or "ps" (the forward, and
    stash mode's backward), or "dp" once per vocab slab and then "s" where
    the wrapper has one (recompute mode); a recompute-mode launch that no
    "s" ends ends the run, and one run holds launches of one mode. Any other
    sequence raises: a product with no ds before it in a slab loop, two ds
    in a row, a second kernel with no product before it. Two stash-mode
    products in a row are two launches, which the exact launch counts catch
    where one call ran its kernel twice."""
    if not re.fullmatch(r"(?:ps?)+|(?:(?:dp)+s)*(?:dp)*", run):
        raise LaunchShapeError(f"{name}: its kernels ran as {run!r} (d ds, p product, s second "
                             f"kernel), not as launches of p[s] or (dp)+[s]")
    return len(re.findall(r"(?:dp)+s?|ps?", run))


def step_kernels(events, n: int):
    """{kernel name: {launches_per_step, device_ms_per_step}} of the device
    events of ``n`` profiled steps, in order, each kernel found by
    KERNEL_SYMBOLS; a ds kernel (DS_SYMBOL) belongs to the CE wrapper of the
    next CE event. Each flash event is one launch of its wrapper. A CE
    wrapper's launches are counted over each run of its events with no other
    CE event between them, by ``ce_run_launches``: the time of its ds and
    second kernels counts to the wrapper, their launches do not."""
    owner = [next((name for name, symbols in KERNEL_SYMBOLS.items()
                   if any(s in e for s in symbols)), None) for e, _, _ in events]
    follows = None  # the CE wrapper of the next CE event
    for i in reversed(range(len(events))):
        if DS_SYMBOL in events[i][0]:
            if follows is None:
                raise LaunchShapeError(f"a ds kernel at {events[i][1]} us with no CE kernel "
                                       f"after it")
            owner[i] = follows
        elif owner[i] in CE_NAMES:
            follows = owner[i]
    launches, device_us = dict.fromkeys(KERNEL_SYMBOLS, 0), dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    runs = []  # [CE wrapper, kinds of its events] of each unbroken run
    for (e, a, b), name in zip(events, owner):
        if name is None:
            continue
        device_us[name] += b - a
        if name not in CE_NAMES:
            launches[name] += 1
            continue
        kind = ("d" if DS_SYMBOL in e else "s" if any(s in e for s in SECOND_KERNELS)
                else "p")
        if runs and runs[-1][0] == name:
            runs[-1][1] += kind
        else:
            runs.append([name, kind])
    for name, run in runs:
        launches[name] += ce_run_launches(name, run)
    return {name: {"launches_per_step": launches[name] / n,
                   "device_ms_per_step": device_us[name] / 1e3 / n} for name in KERNEL_SYMBOLS}


def busy_ms(events) -> float:
    """Milliseconds of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, a, b in events:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


class NoDeviceActivity(AssertionError):
    """A profiled window in which torch.profiler saw no device work."""


def profiled(fn, n: int, attempts: int = 5):
    """Run ``fn`` ``n`` times under torch.profiler, synchronized at the end;
    returns the device events. torch.profiler now and then records none of a
    window's device work, sometimes several windows running: such a window
    is taken again, up to ``attempts`` windows in all, and then this raises."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            return prof, events
    raise NoDeviceActivity(f"torch.profiler recorded no device activity in {attempts} windows")


SHORT_PROFILES: list = []  # every profile short of its launch count, for chip_smoke.json


def counted_profile(fn, calls: int, steps: int, want, label: str, attempts: int = 3):
    """``profiled(fn, calls)``, ``steps`` training steps in all, whose
    kernels' launches per step must be ``want`` (``step_kernels``); returns
    (prof, events, kernels). Every launch of a
    step or a graph replay happens, so a count below the want in one profile
    is a lost trace event (seen on the card: 287 of 288): that profile is
    recorded in SHORT_PROFILES (which kernels, seen against wanted) and
    taken again, up to ``attempts`` in all; a count above the want raises
    at once, as does a count still short after the last attempt. A profile
    whose CE kernels ran out of shape (``LaunchShapeError``: a lost ds or
    product event looks like one) is recorded and taken again the same way,
    and raises if the last attempt is out of shape too."""
    for attempt in range(attempts):
        prof, events = profiled(fn, calls)
        try:
            kernels = step_kernels(events, steps)
        except LaunchShapeError as e:
            SHORT_PROFILES.append({"label": label, "attempt": attempt + 1, "steps": steps,
                                   "out_of_shape": str(e)})
            if attempt == attempts - 1:
                raise
            log(f"  {label}: profile {attempt + 1} out of shape ({e}); taking it again")
            continue
        seen = {name: k["launches_per_step"] for name, k in kernels.items()}
        if seen == want:
            return prof, events, kernels
        SHORT_PROFILES.append({"label": label, "attempt": attempt + 1, "steps": steps,
                               "short": {x: [seen[x], want[x]] for x in want
                                         if seen[x] != want[x]}})
        if any(seen[x] > want[x] for x in want) or attempt == attempts - 1:
            raise AssertionError(f"{label}: the profiler saw {seen} launches per step, "
                                 f"want {want}")
        log(f"  {label}: profile {attempt + 1} lost trace events ({seen} launches per "
            f"step); taking it again")


def device_ms(fn, n: int = 20, warmup: int = 3, windows: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the union of its kernels',
    copies' and memsets' intervals over ``n`` profiled calls, divided by
    ``n``; the median of ``windows`` such windows, which leaves out a window
    whose device events the profiler partly lost. Host work between launches
    (argument checks, allocation, the ctypes call, autograd's bookkeeping) is
    left out. Where the profiler records nothing at all, the time between
    CUDA events instead (host dispatch included), and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        try:
            times.append(busy_ms(profiled(fn, n)[1]) / n)
        except NoDeviceActivity as e:
            log(f"  ({e}: this time is between CUDA events, host dispatch included)")
            return events_ms(fn, n, warmup=0)
    return float(np.median(times))


def bound(flops: float, nbytes: float):
    """(bound ms, what sets it) on the card."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_rows(rows, timings, work, lib_label):
    """Device, event and plain times, bound and library time of each kernel."""
    for name, (fn, plain, lib_ms) in timings.items():
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes)
        rows[name].update(
            ms=device_ms(fn), events_ms=events_ms(fn), plain_ms=device_ms(plain, n=5),
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
        r = rows[name]
        log(f"  {name}: device {r['ms']:.4f} ms (between CUDA events, host dispatch "
            f"included: {r['events_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
            f"{lib_label(name)} {lib_ms:.4f} ms), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}")


# ------------------------------------------------------------------ phase 2
def kernel_inputs(B, H, KV, T, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((n, T, D), generator=g, device="cuda").to(torch.bfloat16)
    return mk(B * H), mk(B * KV), mk(B * KV), mk(B * H)


def work(B, H, KV, T, D, causal):
    """(FLOPs, bytes) per kernel for these inputs: products over the (q, k)
    pairs the mask keeps, each input read once and each output written once."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    q_bytes, kv_bytes, row_bytes = B * H * T * D * 2, B * KV * T * D * 2, B * H * T * 4
    return {
        "flash_fwd": (4 * D * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_dq": (6 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        "flash_dkv": (8 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
        # the whole backward as one function (SDPA's backward alone): the five
        # products S, dP, dV, dK, dQ; dq, dk and dv written once
        "flash_bwd": (10 * D * pairs,
                      2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes + 2 * kv_bytes),
    }


def check_kernels(flash, shape, causal, seed, timed):
    """Each kernel against its plain version on the same inputs; with
    ``timed``, also the times. Returns {name: row}.

    Tolerances: lse (f32, the same arithmetic in another order) within
    FLASH_LSE_ATOL; o within one bf16 step of the plain value (rtol 2^-7)
    plus FLASH_O_ATOL: both versions round P to bf16, the kernel at each
    tile's running max, the plain version at the final one; dq, dk and dv by
    relative norm within FLASH_GRAD_REL."""
    B, H, KV, T, D = shape
    q, k, v, do = kernel_inputs(B, H, KV, T, D, seed)
    o, lse = flash.flash_fwd(q, k, v, causal, H, KV)
    o_ref, lse_ref = flash.flash_fwd_reference(q, k, v, causal, H, KV)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV)
    dk, dv = flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV)
    dq_ref = flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV)
    dk_ref, dv_ref = flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV)
    torch.cuda.synchronize()
    where = f"(B,H,KV,T,D)={shape} causal={causal}"
    for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name} {where}: non-finite output")
    torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=FLASH_LSE_ATOL,
                               msg=lambda m: f"flash lse {where}: {m}")
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2.0 ** -7, atol=FLASH_O_ATOL,
                               msg=lambda m: f"flash o {where}: {m}")
    rel = {"dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref), "dv": rel_err(dv, dv_ref)}
    bad = {n: r for n, r in rel.items() if not r <= FLASH_GRAD_REL}
    if bad:
        raise AssertionError(f"flash {where}: relative errors {bad} above {FLASH_GRAD_REL}")
    err = {n: (got.float() - want.float()).abs().max().item()
           for n, got, want in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    # what the o check needs beyond one bf16 step: max(|err| - 2^-7 |plain|)
    o_excess = ((o.float() - o_ref.float()).abs() - 2.0 ** -7 * o_ref.float().abs()).max().item()
    rows = {
        "flash_fwd": {"max_abs_err": max(err["o"], err["lse"]), "o_max_abs_err": err["o"],
                      "lse_max_abs_err": err["lse"], "o_beyond_one_step": o_excess},
        "flash_dq": {"max_abs_err": err["dq"], "rel_err": rel["dq"]},
        "flash_dkv": {"max_abs_err": max(err["dk"], err["dv"]), "rel_err": max(rel["dk"], rel["dv"])},
    }
    log(f"  flash kernels vs plain at {where}: max|err| "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
        + f"; o beyond one bf16 step {o_excess:.3e} (within {FLASH_O_ATOL:g}), lse within "
        + f"{FLASH_LSE_ATOL:g}; relative " + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
        + f" (within {FLASH_GRAD_REL:g})")
    if not timed:
        return rows

    q4, k4, v4 = (t.view(B, -1, T, D) for t in (q, k, v))
    sdpa_kw = {"is_causal": causal, **({"enable_gqa": True} if KV != H else {})}
    q4g = q4.detach().clone().requires_grad_(True)
    k4g = k4.detach().clone().requires_grad_(True)
    v4g = v4.detach().clone().requires_grad_(True)
    do4 = do.view(B, H, T, D)

    out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, **sdpa_kw)  # the graph, built once

    def sdpa_bwd():
        torch.autograd.grad(out4, (q4g, k4g, v4g), do4, retain_graph=True)

    sdpa_fwd_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw))
    sdpa_bwd_ms = device_ms(sdpa_bwd)
    timings = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, causal, H, KV),
                      lambda: flash.flash_fwd_reference(q, k, v, causal, H, KV), sdpa_fwd_ms),
        "flash_dq": (lambda: flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV),
                     lambda: flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV),
                     sdpa_bwd_ms),
        "flash_dkv": (lambda: flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV),
                      lambda: flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV),
                      sdpa_bwd_ms),
    }
    time_rows(rows, timings, work(B, H, KV, T, D, causal),
              lambda n: "SDPA " + ("fwd" if n == "flash_fwd" else "bwd alone"))
    log_backward_family("flash dq + dkv", rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"],
                        "SDPA's backward alone", sdpa_bwd_ms)
    return rows


def log_backward_family(kernels, kernels_ms, library, library_ms) -> None:
    """One line comparing a family's summed backward kernels with the
    library's backward alone (device times)."""
    log(f"  {kernels}: {kernels_ms:.4f} ms against {library} {library_ms:.4f} ms "
        f"({kernels_ms / library_ms:.2f}x)")


def ce_work(N, D, V, stash):
    """(FLOPs, bytes) per CE kernel: one product pass of 2 N V D (two in the
    recompute-mode backward), each input read once, each output written once."""
    ops = 2 * N * V * D
    x_b, w_b, s_b, row_b, dw_b = N * D * 2, V * D * 2, N * V * 2, N * 4, V * D * 4
    passes = 1 if stash else 2
    return {
        "ce_fwd": (ops, x_b + w_b + row_b + 2 * row_b + (s_b if stash else 0)),
        "ce_dx": (passes * ops, (s_b if stash else x_b) + w_b + 3 * row_b + x_b),
        "ce_dw": (passes * ops, (s_b if stash else w_b) + x_b + 3 * row_b + dw_b),
    }


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over all elements, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def check_ce(ce, N, D, V, stash, seed, tail, timed):
    """The CE kernels against their plain versions: x ~ N(0, 1), W ~
    N(0, 0.05) in bf16, the cotangent of a summed loss (1 per counted row).

    Tolerances: loss and lse (f32, the same arithmetic in another order)
    within CE_ROW_ATOL absolute; the bf16 stash within one bf16 step of the
    plain value (rtol 2^-7) plus CE_ROW_ATOL; dx and dW by relative norm,
    within CE_GRAD_REL. The one-hot term dominates both gradients here (in
    dW, -x summed into the label rows; the softmax part is spread thin over
    all V rows), so dx and dW are also compared with every label ignored and
    g = 1: the softmax part alone, by relative norm within CE_GRAD_REL. In
    recompute mode the first rows' labels sit at the first and last column
    of each vocab slab (``slab_labels``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device=DEVICE) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=DEVICE, dtype=torch.int32)
    if not stash:
        edges = slab_labels(ce, N, V)
        labels[:len(edges)] = edges
    if tail:
        labels[-tail:] = -1
    g = (labels >= 0).float()
    loss, lse, s = ce.ce_fwd(x, w, labels, stash)
    dx = ce.ce_dx(x, w, labels, lse, g, s)
    dw = ce.ce_dw(x, w, labels, lse, g, s)
    loss_r, lse_r, s_r = ce.ce_fwd_reference(x, w, labels, stash)
    dx_r = ce.ce_dx_reference(x, w, labels, lse, g, s_r)
    dw_r = ce.ce_dw_reference(x, w, labels, lse, g, s_r)
    none, ones = torch.full_like(labels, -1), torch.ones_like(g)
    soft = (ce.ce_dx(x, w, none, lse, ones, s), ce.ce_dw(x, w, none, lse, ones, s))
    soft_r = (ce.ce_dx_reference(x, w, none, lse, ones, s_r),
              ce.ce_dw_reference(x, w, none, lse, ones, s_r))
    torch.cuda.synchronize()
    where = f"N={N} V={V} {'stash' if stash else 'recompute'}"
    for name, t in (("loss", loss), ("lse", lse), ("dx", dx), ("dw", dw), ("softmax dx", soft[0]),
                    ("softmax dw", soft[1])) + ((("stash", s),) if stash else ()):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"ce {name} {where}: non-finite output")
    counted = dx[:N - tail].float().abs().sum(1)
    if tail and torch.count_nonzero(dx[-tail:]) or not (counted > 0).all():
        raise AssertionError(f"ce {where}: an ignored row got a gradient or a counted row none")
    errs = {}
    for name, got, want in (("loss", loss, loss_r), ("lse", lse, lse_r)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=CE_ROW_ATOL,
                                   msg=lambda m: f"ce {name} {where}: {m}")
        errs[name] = (got - want).abs().max().item()
    if stash:
        torch.testing.assert_close(s.float(), s_r.float(), rtol=2.0 ** -7, atol=CE_ROW_ATOL,
                                   msg=lambda m: f"ce stash {where}: {m}")
        errs["stash"] = (s.float() - s_r.float()).abs().max().item()
    rel = {"dx": rel_err(dx, dx_r), "dw": rel_err(dw, dw_r),
           "softmax dx": rel_err(soft[0], soft_r[0]), "softmax dw": rel_err(soft[1], soft_r[1])}
    bad = {k: v for k, v in rel.items() if not v <= CE_GRAD_REL}
    if bad:
        raise AssertionError(f"ce {where}: relative errors {bad} above {CE_GRAD_REL}")
    errs["dx"] = (dx.float() - dx_r.float()).abs().max().item()
    errs["dw"] = (dw - dw_r).abs().max().item()
    rows = {
        "ce_fwd": {"max_abs_err": max(errs[k] for k in ("loss", "lse", "stash") if k in errs),
                   "loss_lse_max_abs_err": max(errs["loss"], errs["lse"]),
                   "stash_max_abs_err": errs.get("stash")},
        "ce_dx": {"max_abs_err": errs["dx"], "rel_err": rel["dx"],
                  "softmax_rel_err": rel["softmax dx"]},
        "ce_dw": {"max_abs_err": errs["dw"], "rel_err": rel["dw"],
                  "softmax_rel_err": rel["softmax dw"]},
    }
    log(f"  CE kernels vs plain at D={D} {where} (ignored tail {tail}): max|err| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (loss, lse within {CE_ROW_ATOL:g}" + ("; stash within 2^-7 relative" if stash else "")
        + "); relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (within {CE_GRAD_REL:g})")
    if not timed:
        return rows

    lab64 = labels.long()
    xg, wg = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)

    def lib_fwd():
        return F.cross_entropy(F.linear(x, w).float(), lab64, ignore_index=-1, reduction="none")

    lib_out = F.cross_entropy(F.linear(xg, wg).float(), lab64, ignore_index=-1,
                              reduction="none")  # the graph, built once

    def lib_bwd():
        torch.autograd.grad(lib_out, (xg, wg), g, retain_graph=True)

    lib_fwd_ms, lib_bwd_ms = device_ms(lib_fwd), device_ms(lib_bwd)
    timings = {
        "ce_fwd": (lambda: ce.ce_fwd(x, w, labels, stash),
                   lambda: ce.ce_fwd_reference(x, w, labels, stash), lib_fwd_ms),
        "ce_dx": (lambda: ce.ce_dx(x, w, labels, lse, g, s),
                  lambda: ce.ce_dx_reference(x, w, labels, lse, g, s_r), lib_bwd_ms),
        "ce_dw": (lambda: ce.ce_dw(x, w, labels, lse, g, s),
                  lambda: ce.ce_dw_reference(x, w, labels, lse, g, s_r), lib_bwd_ms),
    }
    time_rows(rows, timings, ce_work(N, D, V, stash),
              lambda n: "linear + cross_entropy " + ("fwd" if n == "ce_fwd" else "bwd alone"))
    log_backward_family(f"ce dx + dw ({'stash' if stash else 'recompute'})",
                        rows["ce_dx"]["ms"] + rows["ce_dw"]["ms"],
                        "linear + cross_entropy's backward alone", lib_bwd_ms)
    del lib_out
    # cuBLAS on each product alone: yardsticks, not the kernels' library call
    ms = device_ms(lambda: torch.matmul(x, w.t()))
    rows["ce_fwd"]["cublas_product_ms"] = ms
    log(f"  cuBLAS yardstick for ce_fwd's product: torch.matmul of the (N, D) x by the "
        f"(D, V) Wᵀ, bf16 (N, V) out: {ms:.4f} ms (ce_fwd {rows['ce_fwd']['ms']:.4f} ms)")
    if stash:
        ms = device_ms(lambda: torch.matmul(s, w))  # the bf16 (N, V) stash as ds
        rows["ce_dx"]["cublas_product_ms"] = ms
        log(f"  cuBLAS yardstick for ce_dx's product: torch.matmul of the bf16 (N, V) stash by "
            f"the (V, D) W, bf16 out: {ms:.4f} ms (ce_dx {rows['ce_dx']['ms']:.4f} ms)")
        ds_t = s.t()  # a bf16 (V, N) operand laid out as the kernel reads dsᵀ
        ms = device_ms(lambda: torch.matmul(ds_t, x))
        rows["ce_dw"]["cublas_product_ms"] = ms
        log(f"  cuBLAS yardstick for ce_dw's product: torch.matmul of the bf16 (V, N) dsᵀ by "
            f"the (N, D) x, bf16 out: {ms:.4f} ms (ce_dw {rows['ce_dw']['ms']:.4f} ms)")
    return rows


def slab_edges(ce, N, V):
    """(first, last column + 1) of each vocab slab of recompute mode at N x V."""
    vs = ce.slab_width(N, V)
    return [(v0, min(V, v0 + vs)) for v0 in range(0, V, vs)]


def slab_labels(ce, N, V):
    """The first and the last column of each vocab slab, as int32 labels."""
    return torch.tensor([c for v0, v1 in slab_edges(ce, N, V) for c in (v0, v1 - 1)],
                        dtype=torch.int32, device=DEVICE)


def check_ds(ce, N, D, V, seed, timed):
    """The recompute-mode ds kernel alone (``ce.ce_ds_slab``) against its
    plain version on one vocab slab: the second slab of
    ``ce.slab_width(N, V)`` columns (the first where one holds the whole
    vocab), labels at the edge
    columns of every slab, a non-uniform g and an ignored tail of N / 16
    rows. Both form ds in f32 and round it to bf16 once: within one bf16
    step of the plain value (rtol 2^-7), and 2^-126 absolute, since ex2.approx
    flushes what falls below the smallest normal float to 0. With ``timed``,
    the kernel over the whole vocab as one slab (the work of every slab of a
    recompute-mode backward kernel) beside its bound and its plain version."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device=DEVICE) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=DEVICE, dtype=torch.int32)
    edges = slab_labels(ce, N, V)
    labels[:len(edges)] = edges
    labels[N - N // 16:] = -1
    g = (torch.rand((N,), generator=gen, device=DEVICE) * 1.9 + 0.1) * (labels >= 0)
    _, lse, _ = ce.ce_fwd(x, w, labels, False)
    slabs = slab_edges(ce, N, V)
    v0, v1 = slabs[1] if len(slabs) > 1 else slabs[0]
    ds = ce.ce_ds_slab(x, w, labels, lse, g, v0, v1)
    want = ce.ce_ds_slab_reference(x, w, labels, lse, g, v0, v1)
    torch.cuda.synchronize()
    where = f"N={N} D={D} V={V} slab {v0}:{v1}"
    if ds.shape != want.shape or ds.dtype != torch.bfloat16 or not torch.isfinite(ds.float()).all():
        raise AssertionError(f"ce ds {where}: {ds.shape} {ds.dtype} against {want.shape}, or "
                             f"non-finite")
    torch.testing.assert_close(ds.float(), want.float(), rtol=2.0 ** -7, atol=2.0 ** -126,
                               msg=lambda m: f"ce ds {where}: {m}")
    err = (ds.float() - want.float()).abs().max().item()
    row = {"slab": [v0, v1], "max_abs_err": err, "rel_err": rel_err(ds, want)}
    log(f"  CE ds kernel vs plain at {where}: max|err| {err:.3e}, relative {row['rel_err']:.3e} "
        f"(within one bf16 step)")
    if not timed:
        return row
    ops = 2 * N * V * D
    nbytes = N * D * 2 + V * D * 2 + 3 * N * 4 + N * V * 2
    bound_ms, bound_by = bound(ops, nbytes)
    row.update(ms=device_ms(lambda: ce.ce_ds_slab(x, w, labels, lse, g, 0, V)),
               plain_ms=device_ms(lambda: ce.ce_ds_slab_reference(x, w, labels, lse, g, 0, V),
                                  n=5),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"  ce_ds over the whole vocab (V={V} as one slab): device {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f} ms), bound {bound_ms:.4f} ms by {bound_by}")
    return row


#: (B, H, T, D, causal) of the flash sweep: T at the main batch, causal and
#: not; the batch at the main T; head dim 128; head dim 256 at GPT-J-6B's
#: heads, causal T at b8 and T 512 not.
SWEEP = ([(BATCH, 12, T, 64, True) for T in (64, 128, 256, 512, 1024, 2048, 4096)]
         + [(BATCH, 12, T, 64, False) for T in (128, 256, 512, 1024)]
         + [(B, 12, SEQ, 64, True) for B in (1, 2, 4, 16, 32)]
         + [(4, 16, T, 128, True) for T in (512, 2048)]
         + [(BATCH, 16, T, 256, True) for T in (512, 1024, 2048)]
         + [(BATCH, 16, SEQ, 256, False)])


#: The work (``work``'s key) whose bound each time of a sweep row is held to.
SWEEP_WORK = {"fwd_ms": "flash_fwd", "dq_ms": "flash_dq", "dkv_ms": "flash_dkv",
              "sdpa_fwd_ms": "flash_fwd", "sdpa_bwd_ms": "flash_bwd"}


def bounded_ms(fn, bound_ms: float, attempts: int = 3):
    """(``device_ms(fn)``, how often it was taken again): a time under
    ``bound_ms``, which no run can be (the profiler lost device events in
    most of its windows), is taken again, up to ``attempts`` in all."""
    for attempt in range(attempts):
        ms = device_ms(fn)
        if ms >= bound_ms:
            break
    return ms, attempt


def flash_sweep(flash, sweep=SWEEP):
    """Device times of the three flash kernels and of SDPA's forward and
    backward alone over ``sweep`` (rows of SWEEP), each timed as phase 2
    times a kernel (``device_ms``: the median of three profiled windows);
    the forward's rate in TFLOP/s, and dQ + dK/dV against SDPA's backward
    alone. Each time is held to its bound (SWEEP_WORK): one under it is
    taken again (``bounded_ms``; the row's ``retaken`` counts how often),
    and one still under it is logged and named in the row's
    ``under_bound``."""
    rows = []
    for B, H, T, D, causal in sweep:
        q, k, v, do = kernel_inputs(B, H, H, T, D, 0)
        o, lse = flash.flash_fwd(q, k, v, causal, H, H)
        delta = (do.float() * o.float()).sum(-1)
        q4, k4, v4 = (t.view(B, H, T, D).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        n = T // 64
        timings = {
            "fwd_ms": lambda: flash.flash_fwd(q, k, v, causal, H, H),
            "dq_ms": lambda: flash.flash_dq(q, k, v, do, lse, delta, causal, H, H),
            "dkv_ms": lambda: flash.flash_dkv(q, k, v, do, lse, delta, causal, H, H),
            "sdpa_fwd_ms": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
            "sdpa_bwd_ms": lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view(B, H, T, D),
                                                       retain_graph=True)}
        w = work(B, H, H, T, D, causal)
        bounds = {name: bound(*w[SWEEP_WORK[name]])[0] for name in timings}
        timed = {name: bounded_ms(fn, bounds[name]) for name, fn in timings.items()}
        row = {"B": B, "H": H, "T": T, "D": D, "causal": causal,
               "tile_steps": B * H * (n * (n + 1) // 2 if causal else n * n),
               **{name: ms for name, (ms, _) in timed.items()}, "bound_ms": bounds,
               "retaken": {name: k for name, (_, k) in timed.items() if k},
               "under_bound": [name for name in timings if timed[name][0] < bounds[name]]}
        row["fwd_tflops"] = w["flash_fwd"][0] / row["fwd_ms"] / 1e9
        row["bwd_vs_sdpa"] = (row["dq_ms"] + row["dkv_ms"]) / row["sdpa_bwd_ms"]
        rows.append(row)
        where = f"B{B} H{H} T{T} D{D} causal={causal}"
        log(f"  {where}: {row['tile_steps']} tile steps; "
            f"fwd {row['fwd_ms']:.4f} ms ({row['fwd_tflops']:.0f} TFLOP/s), SDPA fwd "
            f"{row['sdpa_fwd_ms']:.4f}; dq {row['dq_ms']:.4f} + dkv {row['dkv_ms']:.4f} "
            f"against SDPA bwd alone {row['sdpa_bwd_ms']:.4f} ({row['bwd_vs_sdpa']:.2f}x)")
        for name, k in row["retaken"].items():
            log(f"  {where}: {name} read under its bound {bounds[name]:.4f} ms, taken again "
                f"{k} time(s)")
        for name in row["under_bound"]:
            log(f"  {where}: {name} {row[name]:.4f} ms is UNDER its bound "
                f"{bounds[name]:.4f} ms: windows short of device events")
        del out4
    return rows


#: GPT-J-6B's attention at b8 x 512 (phase 8b's path): B, H, KV, T, D.
GPTJ_ATTN = (BATCH, 16, 16, SEQ, 256)


def check_head_dim_256(flash):
    """The flash kernels at head dim 256: timed at GPT-J-6B's shape (causal);
    checked with grouped queries where T % 128 == 64 (the last q block's
    second warpgroup has no rows: T 192, 320), causal and not, on one tile,
    over walks of 16 (T 1024) and on a grid of four blocks (B 1, H 1); the
    forward, dQ and dK/dV twice at GPT-J's shape, causal, bitwise equal."""
    rows = check_kernels(flash, GPTJ_ATTN, True, 16, timed=True)
    for seed, (shape, causal) in enumerate((((2, 8, 2, 320, 256), True),
                                            ((2, 8, 2, 320, 256), False),
                                            ((2, 8, 2, 192, 256), True),
                                            ((2, 8, 2, 192, 256), False),
                                            ((2, 4, 4, 64, 256), True),
                                            ((2, 4, 4, 64, 256), False),
                                            ((2, 16, 16, 1024, 256), True),
                                            ((1, 1, 1, SEQ, 256), True)), start=17):
        check_kernels(flash, shape, causal, seed, timed=False)
    B, H, KV, T, D = GPTJ_ATTN
    q, k, v, do = kernel_inputs(B, H, KV, T, D, 16)
    first, second = flash.flash_fwd(q, k, v, True, H, KV), flash.flash_fwd(q, k, v, True, H, KV)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"flash forward at {GPTJ_ATTN}: two runs on the same inputs differ")
    o, lse = first
    delta = (do.float() * o.float()).sum(-1)
    first, second = (flash.flash_dq(q, k, v, do, lse, delta, True, H, KV) for _ in range(2))
    if not torch.equal(first, second):
        raise AssertionError(f"flash dQ at {GPTJ_ATTN}: two runs on the same inputs differ")
    first, second = (flash.flash_dkv(q, k, v, do, lse, delta, True, H, KV) for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"flash dK/dV at {GPTJ_ATTN}: two runs on the same inputs differ")
    log(f"  flash forward, dQ and dK/dV at (B,H,KV,T,D)={GPTJ_ATTN}: two runs bitwise equal")
    return rows


# ------------------------------------------------------------------ phase 3
def lm_task(sat, name, lr, batch_count, save_dir, model=GPT2, loss_fn=None, wrap=None,
            seq=SEQ, **kwargs):
    """A GPT-2 (``pretraining_loss``) or BERT (``mlm_loss``, [MASK] id kept
    out of the data) task at the main path's shapes (at ``seq`` tokens a
    row), synthetic tokens (passed through ``wrap`` when given)."""
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.bert import build_bert, mlm_loss
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss

    bert = model == BERT
    build = build_bert if bert else build_gpt2
    return sat.Task(
        get_model=lambda **kw: build(model, **{"seq_len": seq, **kw}),
        get_dataloader=lambda: (wrap or (lambda ds: ds))(make_lm_dataset(
            context_length=seq, batch_size=BATCH, vocab_size=VOCAB, seed=0,
            reserved_ids=1 if bert else 0)),
        loss_fn=loss_fn or (mlm_loss if bert else pretraining_loss),
        hparams=sat.HParams(lr=lr, batch_count=batch_count, kwargs=kwargs),
        name=name,
        save_dir=save_dir,
    )


def initial_loss(task) -> float:
    """Loss of the seed-0 init on batch 0 (where every run starts)."""
    spec = task.get_model(attention="dense")
    model = spec.init_fn(torch.Generator().manual_seed(0), torch.device(DEVICE))
    tokens = torch.from_numpy(task.batch_at(0)).to(DEVICE, torch.long)
    with torch.no_grad():
        loss = task.loss_fn(spec.apply_fn(model, tokens), tokens).item()
    del model
    torch.cuda.empty_cache()
    return loss


def reset_counts(flash, ce) -> None:
    flash.reset_launch_counts()
    ce.reset_launch_counts()


def counts(flash, ce):
    return {**flash.LAUNCHES, **ce.LAUNCHES}


def main_path(sat, flash, ce, card):
    from saturn_tpu_torch.parallel import spmd_base
    from saturn_tpu_torch.solver import anytime
    from saturn_tpu_torch.utils import checkpoint as ckpt

    names = sat.library.register_default_library()
    tasks = [lm_task(sat, f"gpt2s-lr{i}", lr, 20, CKPTS) for i, lr in enumerate((6e-4, 1e-3))]
    tasks.append(lm_task(sat, "bert-base", 1e-3, 20, CKPTS, model=BERT))
    loss0 = {t.name: initial_loss(t) for t in tasks}
    topo = topology()
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    cache_dir = os.path.join(OUT, "main_path_profile_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)  # its trials must run
    stats = sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir)
    t_search = time.perf_counter() - t0
    tech = tasks[0].strategies[1].executor
    k_trial = spmd_base.max_window()
    log(f"  library {names}; search profiled {stats['trials_run']} (task, size) points "
        f"({stats['cache_hits']} profile-cache hits: the GPT-2 tasks differ only in lr), "
        f"{len(tech.trials)} configs, in {t_search:.1f}s, each trial timing windows of "
        f"K={k_trial}:")
    for task_name, size, config, spb, outcome in tech.trials:
        log(f"    trial {task_name} g={size} {config}: "
            + (f"{spb:.6f} s/batch (K={k_trial} windows)" if spb is not None
               else f"infeasible ({outcome})")
            + f"  [{card}]")
    if k_trial != WINDOW:
        raise AssertionError(f"trials timed windows of {k_trial}, want {WINDOW}")
    if any(spb is None for *_, spb, _ in tech.trials):
        raise AssertionError("a trial did not fit in device memory: see the lines above")
    won = {t.name: t.strategies[1].params for t in tasks}
    log(f"  chosen configs: {won}")
    interval = INTERVAL_SHARE * min(t.strategies[1].runtime for t in tasks)
    log(f"  interval {interval:.3f}s ({INTERVAL_SHARE} of the shortest profiled runtime)")
    plan = anytime.anytime_resolve(tasks, topo, None, interval)
    for n, a in plan.assignments.items():
        log(f"  plan: {n} on block [{a.block.offset}:{a.block.end}] start {a.start:.3f}s "
            f"runtime {a.runtime:.3f}s (makespan {plan.makespan:.3f}s)")
    dev = torch.device(DEVICE, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = sat.orchestrate(tasks, interval=interval, topology=topo)
    t_orch = time.perf_counter() - t0
    # live states, graphs and their pools of the tasks not yet finished
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    launches = counts(flash, ce)
    log(f"  orchestrate: completed {out['completed']} in {t_orch:.1f}s; peak memory "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved; kernel launches over search + orchestrate {launches}")
    unchanged = check_intervals(tech.intervals)
    for r in tech.intervals:
        log(f"    interval {r['task']} {r['config']}: {r['n']} batches, K={r['k']}, "
            f"{r['windows']} windows, tail {r['tail']}"
            + (" (one-step windows)" if r["k"] > 1 and r["tail"] else "")
            + (f", eager warm-up step and capture {r['capture_s']:.3f}s" if r["warm"] else "")
            + (", restored the checkpoint" if r["restored"] else ", no restore")
            + (f", {r['per_batch_s'] * 1e3:.2f} ms/batch" if r["per_batch_s"] else "")
            + f"; host s: state {r['state_s']:.3f}, units {r['run_s']:.3f}, checkpoint "
            f"copy {r['save_s']:.3f}  [{card}]")
    log(f"  {unchanged} intervals ran an unchanged config: none restored the checkpoint; "
        f"{len(tech.intervals)} intervals, host s summed: state "
        f"{sum(r['state_s'] for r in tech.intervals):.3f}, units "
        f"{sum(r['run_s'] for r in tech.intervals):.3f}, checkpoint copy "
        f"{sum(r['save_s'] for r in tech.intervals):.3f}")
    results = {}
    for t in tasks:
        saved = ckpt.load(t.ckpt_path)
        if saved["step"] != t.hparams.batch_count:
            raise AssertionError(f"{t.name}: checkpoint step {saved['step']} != "
                                 f"batch_count {t.hparams.batch_count}")
        losses = np.asarray(t.last_losses)
        if not np.isfinite(losses).all() or not losses[-1] < loss0[t.name]:
            raise AssertionError(f"{t.name}: losses {losses} not finite or not below "
                                 f"the initial {loss0[t.name]:.4f}")
        tok_s = BATCH * SEQ / t.last_per_batch_s
        log(f"  {t.name}: step {saved['step']}/{t.hparams.batch_count}, loss "
            f"{loss0[t.name]:.4f} -> {losses[-1]:.4f}, last interval "
            f"{t.last_per_batch_s * 1e3:.2f} ms/step, {tok_s:.0f} tokens/s  [{card}]")
        results[t.name] = {"config": won[t.name], "initial_loss": loss0[t.name],
                           "final_loss": float(losses[-1]),
                           "ms_per_step": t.last_per_batch_s * 1e3, "tokens_per_s": tok_s}
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    trials = [{"task": n, "config": c, "s_per_batch": s, "k": k_trial}
              for n, _, c, s, _ in tech.trials]
    return launches, {"tasks": results, "trials": trials, "search_s": t_search,
                      "orchestrate_s": t_orch, "orchestrate_peak_bytes": peak,
                      "intervals": tech.intervals}


def check_intervals(intervals) -> int:
    """Raise unless the intervals ran through windows of WINDOW, and no
    interval whose task ran the same config in its previous interval
    restored the checkpoint; returns how many intervals kept their config."""
    if not any(r["k"] == WINDOW and r["windows"] for r in intervals):
        raise AssertionError(f"no interval ran windows of {WINDOW}: {intervals}")
    last, unchanged = {}, 0
    for r in intervals:
        if last.get(r["task"]) == r["config"]:
            unchanged += 1
            if r["restored"]:
                raise AssertionError(f"{r['task']} restored the checkpoint in an interval "
                                     f"whose config {r['config']} did not change")
        last[r["task"]] = r["config"]
    if not unchanged:
        raise AssertionError("no task ran two intervals: lower INTERVAL_SHARE")
    return unchanged


# ------------------------------------------------------------------ phase 4
def untagged_loss(logits, tokens):
    """pretraining_loss without the fused-head tag: the step runs it over
    the logits."""
    from saturn_tpu_torch.models.loss import pretraining_loss

    return pretraining_loss(logits, tokens)


#: (label, attention, loss) of the pinned GPT-2-small runs.
PINNED = (("flash", "flash", None), ("dense", "dense", None),
          ("flash-logits", "flash", untagged_loss))


def want_launches(attention, loss_fn, steps=1):
    """Launches of each kernel in ``steps`` training steps: one of each flash
    kernel per layer with flash attention, one of each CE kernel on the
    fused head."""
    want = {n: (LAYERS * steps if attention == "flash" else 0) for n in FLASH_NAMES}
    want.update({n: (0 if loss_fn else steps) for n in CE_NAMES})
    return want


def pinned_task(sat, label, attention, loss_fn, k=1, seq=SEQ):
    """The pinned task of ``label``; its eager run (``k`` 1) keeps the
    checkpoint that phase 5 reads."""
    where = label if k == 1 else f"{label}-k{k}"
    task = lm_task(sat, f"pinned-{where}", 6e-4, STEPS_PINNED, os.path.join(CKPTS, where),
                   loss_fn=loss_fn, seq=seq)
    config = {"attention": attention, "remat": False}
    return task, config


def compare_windowed(label, windowed, eager) -> str:
    """How the windowed losses hold against the eager ones: "bitwise", or
    "within WINDOW_ATOL" with the largest difference; raise beyond it."""
    w, e = np.asarray(windowed), np.asarray(eager)
    if w.shape != e.shape:
        raise AssertionError(f"{label}: {w.shape} windowed losses against {e.shape} eager")
    if (w == e).all():
        return "bitwise"
    diff = np.abs(w - e).max()
    if not diff <= WINDOW_ATOL:
        raise AssertionError(f"{label}: windowed losses {w} vs eager {e}: max |diff| "
                             f"{diff:.3e} above {WINDOW_ATOL:g}")
    return f"within {WINDOW_ATOL:g} (max |diff| {diff:.3e})"


def pinned_runs(sat, flash, ce, card):
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    runs = {}
    for label, attention, loss_fn in PINNED:
        for k in (WINDOW, 1):
            task, config = pinned_task(sat, label, attention, loss_fn, k)
            tech = DataParallel()
            task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
            task.select_strategy(1)
            reset_counts(flash, ce)
            tech.execute(task, [torch.device(DEVICE, 0)], 0,
                         override_batch_count=STEPS_PINNED, window_size=k)
            r = tech.intervals[-1]
            runs[label, k] = (task, counts(flash, ce), r)
            log(f"  pinned {label} K={k} ({r['windows']} windows, tail {r['tail']}"
                + (", eager warm-up step" if r["warm"] else "") + "): "
                f"{task.last_per_batch_s * 1e3:.2f} ms/step, "
                f"{BATCH * SEQ / task.last_per_batch_s:.0f} tokens/s, launches "
                f"{runs[label, k][1]}, losses {np.round(task.last_losses, 4).tolist()}  [{card}]")
    for label, attention, loss_fn in PINNED:
        want = want_launches(attention, loss_fn, STEPS_PINNED)
        for k in (WINDOW, 1):
            if runs[label, k][1] != want:
                raise AssertionError(f"{label} K={k} run launched {runs[label, k][1]}, "
                                     f"want {want}")
        if not runs[label, WINDOW][2]["windows"]:
            raise AssertionError(f"{label}: the K={WINDOW} run ran no window")
        held = compare_windowed(label, runs[label, WINDOW][0].last_losses,
                                runs[label, 1][0].last_losses)
        log(f"  {label}: windowed losses against eager: {held}; exact launch counts in both")
    for task, _, _ in runs.values():  # phase 5 measures one state at a time
        task.release_live_state()
        task.release_compiled()
    ckpt.flush()
    ref = np.asarray(runs["flash", 1][0].last_losses)
    for label in ("dense", "flash-logits"):
        other = np.asarray(runs[label, 1][0].last_losses)
        if not np.allclose(other, ref, rtol=BF16_BAND, atol=BF16_BAND):
            raise AssertionError(f"{label} losses {other} vs flash {ref} outside the bf16 band")
        log(f"  flash vs {label} loss trajectories: max |diff| "
            f"{np.abs(other - ref).max():.4e} (band 2e-2)")
    return {f"{x}-k{k}": {"ms_per_step": t.last_per_batch_s * 1e3,
                          "tokens_per_s": BATCH * SEQ / t.last_per_batch_s,
                          "losses": t.last_losses, "launches": c, "interval": r}
            for (x, k), (t, c, r) in runs.items()}


LONG_SEQ = 1024  # GPT-2's published context (n_ctx); b8 x 1024 is N 8192, past the stash limit


def long_context_runs(sat, flash, ce, card):
    """GPT-2-small at b8 x LONG_SEQ, where ``ce.auto_stash`` picks recompute
    mode for the fused head: ``pretraining_loss`` (stash=None) in windows of
    8 and one step at a time, and the untagged loss over the logits one step
    at a time as its loss reference, STEPS_PINNED steps each from the same
    init and batches. Exact launch counts (12 of each flash kernel and 1 of
    each CE kernel per step), windowed losses within WINDOW_ATOL of the
    eager ones, fused within the bf16 band of the logits path; ms per step,
    tokens/s and peak memory; the size of the ds scratch of one vocab slab
    (N x ``ce.slab_width`` bf16, the one allocation recompute mode adds)
    under ``ce.SLAB_BYTES_MAX``."""
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    n_tokens = BATCH * LONG_SEQ
    d_model = build_gpt2(GPT2, seq_len=LONG_SEQ).config.d_model
    if ce.auto_stash(n_tokens, VOCAB, d_model):
        raise AssertionError(f"auto_stash keeps the stash at N {n_tokens}: want recompute")
    dev = torch.device(DEVICE, 0)
    label = f"flash-{LONG_SEQ}"
    runs = {}
    for loss_fn, k in ((None, WINDOW), (None, 1), (untagged_loss, 1)):
        where = label + ("-logits" if loss_fn else "")
        task, config = pinned_task(sat, where, "flash", loss_fn, k, seq=LONG_SEQ)
        tech = DataParallel()
        task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
        task.select_strategy(1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(flash, ce)
        tech.execute(task, [dev], 0, override_batch_count=STEPS_PINNED, window_size=k)
        peak = {"allocated": torch.cuda.max_memory_allocated(dev),
                "reserved": torch.cuda.max_memory_reserved(dev)}
        r, launched = tech.intervals[-1], counts(flash, ce)
        want = want_launches("flash", loss_fn, STEPS_PINNED)
        if launched != want:
            raise AssertionError(f"{where} K={k} run launched {launched}, want {want}")
        if k > 1 and not r["windows"]:
            raise AssertionError(f"{where}: the K={k} run ran no window")
        runs[where, k] = (task, launched, r, peak)
        log(f"  pinned {where} b{BATCH}x{LONG_SEQ} K={k} ({r['windows']} windows, tail "
            f"{r['tail']}" + (", eager warm-up step" if r["warm"] else "") + "): "
            f"{task.last_per_batch_s * 1e3:.2f} ms/step, "
            f"{n_tokens / task.last_per_batch_s:.0f} tokens/s, peak memory "
            f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
            f"reserved, launches {launched} (exact), losses "
            f"{np.round(task.last_losses, 4).tolist()}  [{card}]")
        task.release_live_state()  # one state on the card at a time
        task.release_compiled()
    ckpt.flush()
    held = compare_windowed(label, runs[label, WINDOW][0].last_losses,
                            runs[label, 1][0].last_losses)
    fused = np.asarray(runs[label, 1][0].last_losses)
    logits = np.asarray(runs[label + "-logits", 1][0].last_losses)
    if not np.allclose(fused, logits, rtol=BF16_BAND, atol=BF16_BAND):
        raise AssertionError(f"{label}: fused losses {fused} vs logits {logits} outside the "
                             f"bf16 band")
    scratch = n_tokens * ce.slab_width(n_tokens, VOCAB) * 2
    if scratch > ce.SLAB_BYTES_MAX:
        raise AssertionError(f"the ds scratch takes {scratch} bytes, above "
                             f"{ce.SLAB_BYTES_MAX}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  {label}: recompute mode (auto_stash at N {n_tokens}); windowed losses against "
        f"eager: {held}; fused against logits: max |diff| {np.abs(fused - logits).max():.4e} "
        f"(band 2e-2); ds scratch {scratch / 2**20:.1f} MiB (slab of "
        f"{ce.slab_width(n_tokens, VOCAB)} columns, cap {ce.SLAB_BYTES_MAX / 2**20:.0f} MiB); "
        f"{seconds:.1f}s")
    return {"recompute": True, "slab_scratch_bytes": scratch, "windowed_vs_eager": held,
            "seconds": seconds,
            **{f"{x}-k{k}": {"ms_per_step": t.last_per_batch_s * 1e3,
                             "tokens_per_s": n_tokens / t.last_per_batch_s,
                             "losses": t.last_losses, "launches": c, "interval": r,
                             "peak_bytes": p}
               for (x, k), (t, c, r, p) in runs.items()}}


# ------------------------------------------------------------------ phase 5
def profile_steps(sat, card, n_sync=8, n_prof=4):
    """Where a training step's time goes, for each pinned config: per-step
    times with a synchronize after every step and the peak device memory
    over them, then ``n_prof`` steps under torch.profiler. From the profile:
    the device's busy time per step and its idle share of the median
    synchronized step, each kernel's launches and device time per step
    (phase 2's kernel times, read inside the real step), and the top
    operators (``chiprun_out/profile_*.txt``)."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    out = {}
    dev = torch.device(DEVICE, 0)
    for label, attention, loss_fn in PINNED:
        task, config = pinned_task(sat, label, attention, loss_fn)
        bundle = DataParallel().build(task, [dev], config)
        state = ckpt.restore(task.ckpt_path, bundle.empty())
        batch = bundle.stage(task.batch_at(0))
        for _ in range(2):
            state, _ = bundle.step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        synced = []
        for _ in range(n_sync):
            t0 = time.perf_counter()
            state, _ = bundle.step(state, batch)
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        # the step updates ``state`` in place
        want = want_launches(attention, loss_fn)
        prof, events, kernels = counted_profile(lambda: bundle.step(state, batch), n_prof,
                                                n_prof, want, label)
        busy = busy_ms(events) / n_prof
        try:
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
        except (KeyError, AttributeError, ValueError):
            table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
        with open(os.path.join(OUT, f"profile_{label}.txt"), "w") as f:
            f.write(table)
        step_ms = float(np.median(synced))
        flash_ms = sum(kernels[n]["device_ms_per_step"] for n in FLASH_NAMES)
        ce_ms = sum(kernels[n]["device_ms_per_step"] for n in CE_NAMES)
        readbacks = sum("DtoH" in n for n, _, _ in events) / n_prof
        out[label] = {"synced_ms": synced, "device_busy_ms": busy,
                      "idle_share": 1 - busy / step_ms, "kernels": kernels,
                      "readbacks_per_step": readbacks, "peak_bytes": peak}
        log(f"  {label}: synced steps {np.round(synced, 2).tolist()} ms (median "
            f"{step_ms:.2f}); peak memory {peak / 2**30:.2f} GiB; {readbacks:g} "
            f"device-to-host copies per step; device busy {busy:.2f} ms/step, idle share "
            f"{1 - busy / step_ms:.3f} of the median synced step; flash kernels "
            f"{flash_ms:.3f} ms/step, CE kernels {ce_ms:.3f} ms/step on the device; "
            + ", ".join(f"{n} {k['device_ms_per_step'] / max(want[n], 1):.4f} ms/launch"
                        for n, k in kernels.items() if want[n]) + f"  [{card}]")
        del state, bundle
        torch.cuda.empty_cache()
    return out


def optimizer_ab(bundle, state, batch, rounds):
    """The eager step's device time with the capturable optimizer and with
    the same optimizer not capturable (step counts on the host), in turns."""
    opt = state["opt_state"]
    accepted = inspect.signature(type(opt).__init__).parameters
    plain = type(opt)(state["params"].parameters(),
                      **{k: v for k, v in opt.defaults.items()
                         if k in accepted and k != "capturable"},
                      capturable=False) if "capturable" in opt.defaults else opt
    plain.load_state_dict(opt.state_dict())
    eager_busy = {"capturable": [], "plain": []}
    for _ in range(rounds):
        for name, o in (("capturable", opt), ("plain", plain)):
            state["opt_state"] = o
            eager_busy[name].append(busy_ms(profiled(lambda: bundle.step(state, batch), 4)[1]) / 4)
    state["opt_state"] = opt
    return eager_busy


def profile_windows(sat, card, k=WINDOW, n_windows=3, rounds=2, label="flash", seq=SEQ,
                    compare_optimizers=True):
    """The flash + fused config (the pinned task ``label`` at b x ``seq``)
    in windows of ``k``: the steady-state per-batch time of ``n_windows``
    windows without a synchronize between them, beside the eager path's over
    the same ``n_windows * k`` steps, in turns (windows, steps, windows,
    steps, ...); the device busy time and idle share over the windows
    (torch.profiler), the flash and CE kernels' device time per step inside
    them, and the peak memory of the windows, allocated and reserved (the
    graph's pool is reserved). With ``compare_optimizers``, also
    ``optimizer_ab``."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    _, attention, loss_fn = PINNED[0]
    task, config = pinned_task(sat, label, attention, loss_fn, seq=seq)
    bundle = DataParallel().build(task, [dev], config)
    state = ckpt.restore(task.ckpt_path, bundle.empty())
    n = n_windows * k
    batches = [task.batch_at(i) for i in range(n)]
    windows = [stage_tokens(np.stack(batches[w * k:(w + 1) * k]), dev)
               for w in range(n_windows)]
    steps = [bundle.stage(b) for b in batches]
    window = bundle.fused(k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, _ = bundle.warm_step(state, steps[0])
    t0 = time.perf_counter()
    state, _ = window(state, windows[0])  # the capture, then a replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def run_windows():
        for w in windows:
            window(state, w)

    def run_steps():
        for b in steps:
            bundle.step(state, b)

    run_windows()
    torch.cuda.synchronize()
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    times = {"windowed": [], "eager": []}
    for _ in range(rounds):
        for name, fn in (("windowed", run_windows), ("eager", run_steps)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / n)
    # the profiler's count inside the replays, independent of LAUNCHES (which
    # a replay advances by what its capture recorded)
    _, events, kernels = counted_profile(run_windows, 1, n, want_launches(attention, loss_fn),
                                         f"{label} windows")
    busy = busy_ms(events) / n
    windowed_ms = float(np.median(times["windowed"]))
    flash_ms = sum(kernels[x]["device_ms_per_step"] for x in FLASH_NAMES)
    ce_ms = sum(kernels[x]["device_ms_per_step"] for x in CE_NAMES)
    eager_busy = optimizer_ab(bundle, state, steps[0], rounds) if compare_optimizers else None
    out = {"seq": seq, "k": k, "windows": n_windows, "capture_s": capture_s,
           "ms_per_batch": times, "device_busy_ms": busy, "idle_share": 1 - busy / windowed_ms,
           "flash_ms_per_step": flash_ms, "ce_ms_per_step": ce_ms,
           "seconds": time.perf_counter() - t_phase,
           "readbacks_per_step": sum("DtoH" in e for e, _, _ in events) / n,
           "kernels": kernels, "peak_bytes": peak, "eager_device_busy_ms": eager_busy}
    log(f"  {label} b{BATCH}x{seq} in windows of {k}: capture {capture_s:.3f}s; per batch "
        f"without a synchronize between steps, {n} steps, in turns: windowed "
        f"{np.round(times['windowed'], 3).tolist()} ms, eager "
        f"{np.round(times['eager'], 3).tolist()} ms; device busy {busy:.2f} ms/step, idle "
        f"share {out['idle_share']:.3f} of the windowed batch; flash kernels {flash_ms:.3f} "
        f"ms/step, CE kernels {ce_ms:.3f} ms/step; "
        f"{out['readbacks_per_step']:g} device-to-host copies per step; peak memory "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved; launches per step seen by the profiler "
        + ", ".join(f"{name} {kk['launches_per_step']:g}" for name, kk in kernels.items())
        + (f"; eager device busy per step, in turns: capturable "
           f"{type(state['opt_state']).__name__} "
           f"{np.round(eager_busy['capturable'], 3).tolist()} ms, not capturable "
           f"{np.round(eager_busy['plain'], 3).tolist()} ms" if eager_busy else "")
        + f"; {out['seconds']:.1f}s  [{card}]")
    bundle.release_windows()
    del state, bundle, windows, steps
    torch.cuda.empty_cache()
    return out


def staging_ab(sat, card, k=WINDOW, n_windows=4, rounds=3):
    """Staging inline on the dispatching thread (what ``execute`` does)
    against staging on a second thread one unit ahead through a queue of
    depth 2 (what the JAX package's ``DevicePrefetcher`` does), flash +
    fused at b8 x 512 on one state: the per-batch time of ``n_windows``
    windows of ``k``, and of the same steps one at a time, each run staging
    its own batches from the host and ending in one loss readback, in turns
    (inline, thread, then thread, inline, ``rounds`` times)."""
    import queue
    import threading

    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    dev = torch.device(DEVICE, 0)
    task, config = pinned_task(sat, "flash", "flash", None)
    bundle = DataParallel().build(task, [dev], config)
    state = bundle.init()
    n = n_windows * k

    def stager(size):
        def stage(u):
            host = np.stack([task.batch_at(u * size + j) for j in range(size)])
            return stage_tokens(host if size > 1 else host[0], dev)
        return stage

    def inline(count, stage):
        for u in range(count):
            yield stage(u)

    def threaded(count, stage):
        q = queue.Queue(maxsize=2)
        producer = threading.Thread(target=lambda: [q.put(stage(u)) for u in range(count)],
                                    daemon=True)
        producer.start()
        for _ in range(count):
            yield q.get()
        producer.join()

    window = bundle.fused(k)
    state, _ = bundle.warm_step(state, stager(1)(0))
    window(state, stager(k)(0))  # the capture, then a replay
    torch.cuda.synchronize()
    out = {"card": card, "k": k, "batches": n}
    for label, size, run in (("windowed", k, window), ("eager", 1, bundle.step)):
        times = {"inline": [], "thread": []}
        for r in range(rounds):
            for mode in (("inline", "thread") if r % 2 == 0 else ("thread", "inline")):
                feed = inline if mode == "inline" else threaded
                t0 = time.perf_counter()
                losses = [run(state, batch)[1].reshape(-1)
                          for batch in feed(n // size, stager(size))]
                torch.cat(losses).cpu()
                times[mode].append((time.perf_counter() - t0) * 1e3 / n)
        out[label] = times
        log(f"  {label} ({n} batches per run, in turns): staged inline "
            f"{np.round(times['inline'], 3).tolist()} ms/batch, on a thread "
            f"{np.round(times['thread'], 3).tolist()} ms/batch  [{card}]")
    bundle.release_windows()
    del state, bundle
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 6
SWEEP_TASKS = 12           # lr points of GPT-2-small, fused head; a 13th runs the logits
SWEEP_BATCHES = 16
MARKED_BATCH = 12          # the 13th task's dataset index whose loss is NaN
MARK = VOCAB - 1           # a whole row of this id marks that batch (synthetic data never does)
SWEEP_INTERVAL_BATCHES = 9.5  # interval: this many of the 13th task's profiled batches


class PoisonedDataset:
    """A dataset whose batch ``index`` (modulo the epoch) has its first row
    set to ``mark``: a loss that tests for the mark is NaN there."""

    def __init__(self, base, index: int, mark: int):
        self.base, self.index, self.mark = base, index, mark
        self.batch_size = base.batch_size

    def __len__(self) -> int:
        return len(self.base)

    def batch(self, i: int):
        b = np.array(self.base.batch(i))
        if i % len(self.base) == self.index:
            b[0, :] = self.mark
        return b

    def example_batch(self):
        return self.base.example_batch()


def nan_on_mark_loss(logits, tokens):
    """The pretraining loss over the logits (no fused-head tag), plus
    sqrt(-1) = NaN on a batch whose first row is all ``MARK``: a NaN
    computed on the card inside the captured window. No gradient flows
    through it, so only the marked step's loss is non-finite and the
    sentinel blames that batch alone (it blames every non-finite step, as
    the JAX package does); that no faulted attempt writes a checkpoint is
    held by the sequence of writes (``check_writes``)."""
    return untagged_loss(logits, tokens) + torch.sqrt(-(tokens[0] == MARK).all().float())


def sweep_tasks(sat, save_dir):
    """The sweep: SWEEP_TASKS GPT-2-small tasks that differ only in lr
    (``pretraining_loss``, the fused head), and one whose loss runs over the
    logits and is NaN on its batch MARKED_BATCH."""
    tasks = [lm_task(sat, f"sweep-lr{i}", 2e-4 + 1e-4 * i, SWEEP_BATCHES, save_dir,
                     model=GPT2) for i in range(SWEEP_TASKS)]
    sick = lm_task(sat, "sweep-nan", 6e-4, SWEEP_BATCHES, save_dir, model=GPT2,
                   loss_fn=nan_on_mark_loss,
                   wrap=lambda ds: PoisonedDataset(ds, MARKED_BATCH, MARK))
    return tasks + [sick]


def check_search(stats, trials: int, hits: int) -> None:
    """Raise unless a search ran ``trials`` (task, size) trials and answered
    ``hits`` from the profile cache."""
    got = (stats["trials_run"], stats["cache_hits"])
    if got != (trials, hits):
        raise AssertionError(f"search ran {got[0]} trials with {got[1]} cache hits, "
                             f"want {trials} and {hits}")


def nonfinite(tensors) -> list:
    """Names of the tensors of a ``{name: tensor}`` map holding a NaN or Inf."""
    names = list(tensors)
    if not names:
        return []
    ok = torch.stack([torch.isfinite(tensors[n]).all() for n in names]).cpu()
    return [n for n, good in zip(names, ok.tolist()) if not good]


class CheckedWrites:
    """Wrap ``checkpoint.save_async``: every state written must hold finite
    weights (checked on the device before the host copy); records every
    write's (path, step) in order."""

    def __init__(self, ckpt):
        self.ckpt, self.save = ckpt, ckpt.save_async
        self.writes: list = []  # (path, step) of every write, in order

    def __enter__(self):
        def checked(path, state, **kwargs):
            bad = nonfinite(dict(state["params"].named_parameters()))
            if bad:
                raise AssertionError(f"{path}: a checkpoint write of non-finite weights {bad}")
            self.writes.append((path, int(state["step"])))
            return self.save(path, state, **kwargs)

        self.ckpt.save_async = checked
        return self

    def __exit__(self, *exc):
        self.ckpt.save_async = self.save

    def steps(self, path: str) -> list:
        """The step of every write to ``path``, in order."""
        return [step for p, step in self.writes if p == path]

    def bytes_written(self) -> int:
        self.ckpt.flush()
        return sum(os.path.getsize(p) for p, _ in self.writes)


def check_writes(name: str, steps: list, runs: list, total: int) -> None:
    """Raise unless a task's checkpoint writes (their steps, in order) are
    one per interval of ``runs`` (the executor's records of the intervals
    that ran to their end), each at the step where its interval ended, the
    last at ``total``: an attempt that the sentinel faulted, or that the
    watchdog abandoned, writes nothing."""
    want = np.cumsum([r["n"] for r in runs]).tolist()
    if steps != want or want[-1:] != [total]:
        raise AssertionError(f"{name}: checkpoint writes at steps {steps}, want one at the "
                             f"end of each interval that ran to its end, {want}, the last "
                             f"at {total}")


def sweep_events(path: str, sick: str, index: int) -> dict:
    """Read the sweep's metrics file back (``metrics.read_events``): it must
    hold ``solve``, ``solver_tier``, ``profile_cache`` and ``health``
    events, and ``sick``'s guardian trail must be fault, backoff, fault,
    quarantine of ``[index]``, backoff, then its completion. Returns the
    events by kind."""
    from saturn_tpu_torch.utils import metrics

    events = metrics.read_events(path)
    by_kind: dict = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e)
    for kind in ("solve", "solver_tier", "profile_cache", "health", "task_completed"):
        if not by_kind.get(kind):
            raise AssertionError(f"no {kind} event in {path}")
    trail = [(e["code"], e.get("batches")) for e in by_kind["health"] if e["task"] == sick]
    want = [("SAT-H001", None), ("SAT-H003", None), ("SAT-H001", None),
            ("SAT-H010", [index]), ("SAT-H003", None)]
    if trail != want:
        raise AssertionError(f"{sick}: guardian trail {trail}, want {want}")
    if sick not in [e["task"] for e in by_kind["task_completed"]]:
        raise AssertionError(f"{sick} did not complete")
    return by_kind


def sweep_phase(sat, flash, ce, card):
    """13 GPT-2-small tasks, past ``milp_task_limit``: search -> a repeat
    search -> orchestrate with the defaults (the guardian, the anytime
    ladder), a fresh profile cache and a metrics file."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    save_dir = os.path.join(CKPTS, "sweep")
    cache_dir = os.path.join(OUT, "sweep_profile_cache")
    events_path = os.path.join(OUT, "sweep_events.jsonl")
    shutil.rmtree(cache_dir, ignore_errors=True)
    if os.path.exists(events_path):
        os.unlink(events_path)
    tasks = sweep_tasks(sat, save_dir)
    sick = tasks[-1]
    loss0 = initial_loss(tasks[0])  # seed-0 init, batch 0: every task's start
    topo = topology()
    dev = torch.device(DEVICE, 0)
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated(dev)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    stats = sat.search(tasks, technique_names=["dp"], topology=topo,
                       profile_cache=cache_dir, metrics_path=events_path)
    t_search = time.perf_counter() - t0
    check_search(stats, 2, len(tasks) - 2)
    t0 = time.perf_counter()
    again = sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir)
    t_again = time.perf_counter() - t0
    check_search(again, 0, len(tasks))
    log(f"  search: {stats['trials_run']} trials (fused head, logits), "
        f"{stats['cache_hits']} profile-cache hits, {t_search:.1f}s; repeat search "
        f"{again['trials_run']} trials, {again['cache_hits']} hits, {t_again:.1f}s  [{card}]")
    configs = {t.name: t.strategies[1].params for t in tasks}
    pbt = {t.name: t.strategies[1].per_batch_time for t in tasks}
    log(f"  configs {configs[tasks[0].name]} (fused), {configs[sick.name]} (logits); "
        f"profiled {pbt[tasks[0].name] * 1e3:.2f} and {pbt[sick.name] * 1e3:.2f} ms/batch")
    interval = SWEEP_INTERVAL_BATCHES * pbt[sick.name]
    serial = sum(t.strategies[1].runtime for t in tasks)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with CheckedWrites(ckpt) as writes:
        out = sat.orchestrate(tasks, interval=interval, topology=topo,
                              metrics_path=events_path)
    t_orch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cuda.memory_allocated(dev)
    launches = counts(flash, ce)
    if sorted(out["completed"]) != sorted(t.name for t in tasks) or out["failed"]:
        raise AssertionError(f"sweep: completed {out['completed']}, failed {out['failed']}")
    if after > base_bytes + 256 * 2**20:
        raise AssertionError(f"sweep: {after / 2**30:.2f} GiB still allocated after every "
                             f"task completed (before: {base_bytes / 2**30:.2f} GiB)")
    events = sweep_events(events_path, sick.name, MARKED_BATCH)
    tiers = events["solver_tier"]
    first = tiers[0]
    log(f"  interval {interval:.3f}s ({SWEEP_INTERVAL_BATCHES} of the logits task's batches); "
        f"initial solve: tier {first['tier']} ({first['tier_name']}, tried "
        f"{first['tiers_tried']}) in {first['wall_s'] * 1e3:.1f} ms of a "
        f"{first['deadline_s'] * 1e3:.1f} ms deadline, makespan {first['makespan_s']:.3f}s "
        f"against a serial sum of runtimes {serial:.3f}s (+ {len(tasks) - 1} x 1 s of "
        f"ordering slack on one device); {len(tiers)} solves, tiers "
        f"{sorted({e['tier'] for e in tiers})}, at most {max(e['wall_s'] for e in tiers) * 1e3:.1f}"
        f" ms  [{card}]")
    faults = [e for e in events.get("task_numeric_fault", []) if e["task"] == sick.name]
    runs = [r for r in sick.strategies[1].executor.intervals if r["task"] == sick.name]
    # the faulted attempts record nothing; the first after the quarantine restores
    if sick.quarantined_batches != (MARKED_BATCH,) or not any(r["restored"] for r in runs):
        raise AssertionError(f"{sick.name}: quarantined {sick.quarantined_batches}, "
                             f"intervals {runs}")
    log(f"  {sick.name}: {len(faults)} numeric faults at interval step "
        f"{[e['step'] for e in faults]} (dataset batches {[e['batches'] for e in faults]}) "
        f"after a checkpoint at step {runs[0]['n']}; batch {MARKED_BATCH} quarantined after "
        f"the second; the next attempt restored that checkpoint and completed; checkpoint "
        f"writes at steps {writes.steps(sick.ckpt_path)}")
    for t in tasks:
        losses = np.asarray(t.last_losses)
        check_writes(t.name, writes.steps(t.ckpt_path),
                     [r for r in t.strategies[1].executor.intervals if r["task"] == t.name],
                     SWEEP_BATCHES)
        if not np.isfinite(losses).all() or not losses[-1] < loss0:
            raise AssertionError(f"{t.name}: losses {losses} not finite or not below {loss0}")
    n_bytes = writes.bytes_written()
    names = {t.name for t in tasks}
    recs = [r for r in sick.strategies[1].executor.intervals if r["task"] in names]
    split = {x: sum(r[f"{x}_s"] for r in recs) for x in ("state", "run", "save")}
    log(f"  {len(recs)} intervals ran to their end, {sum(r['warm'] for r in recs)} with an "
        f"eager warm-up step and captures ({sum(r['capture_s'] or 0 for r in recs):.1f}s of "
        f"captures); host s summed: state {split['state']:.1f} (fresh inits and restores), "
        f"units {split['run']:.1f}, checkpoint copy and wait {split['save']:.1f}  [{card}]")
    log(f"  {len(out['completed'])} tasks completed in {t_orch:.1f}s, every final loss below "
        f"the initial {loss0:.4f}; {len(writes.writes)} checkpoint writes, all finite, one "
        f"per interval that ran to its end, {n_bytes / 1e9:.2f} GB "
        f"({n_bytes / len(writes.writes) / 1e9:.2f} GB each); peak "
        f"{peak / 2**30:.2f} GiB allocated, {after / 2**30:.2f} GiB after (before "
        f"{base_bytes / 2**30:.2f}); launches {launches}  [{card}]")
    shutil.rmtree(save_dir, ignore_errors=True)
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched in the sweep")
    seconds = time.perf_counter() - t_phase
    log(f"  sweep phase {seconds:.1f}s  [{card}]")
    return launches, {"search": stats, "repeat_search": again, "search_s": t_search,
                      "orchestrate_s": t_orch, "interval_s": interval, "serial_s": serial,
                      "solver_tiers": tiers, "faults": faults, "host_s": split,
                      "checkpoint_writes": len(writes.writes),
                      "sick_writes": writes.steps(sick.ckpt_path),
                      "checkpoint_bytes": n_bytes, "peak_bytes": peak,
                      "after_bytes": after, "before_bytes": base_bytes, "seconds": seconds}


# ------------------------------------------------------------------ phase 7
KILL_BATCHES = 16
KILL_INTERVAL_SHARE = 0.4  # of the shortest profiled runtime: about 6 batches an interval
KILL_MIN_INTERVALS = 3     # intervals each task of the reference run must take
KILL_CHAIN = (("mid-fsync", 2), ("mid-interval", 1), (None, None))  # (point, hit) per incarnation
JOURNAL_KINDS = ("segment_open", "recovery", "plan_commit", "task_progress",
                 "ckpt_published", "interval_commit", "task_completed")
MEMORY_SLACK = 256 * 2**20  # bytes a phase may leave allocated beyond where it began


class CallTimes:
    """Time every call of the functions ``targets`` names (``label=(holder,
    attribute)``) inside the block; ``seconds[label]`` lists them."""

    def __init__(self, **targets):
        self.targets = targets
        self.seconds = {label: [] for label in targets}
        self.saved = {}

    def __enter__(self):
        for label, (holder, attr) in self.targets.items():
            self.saved[label] = fn = getattr(holder, attr)
            setattr(holder, attr, self._timed(label, fn))
        return self

    def _timed(self, label, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label].append(time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        for label, (holder, attr) in self.targets.items():
            setattr(holder, attr, self.saved[label])


def check_same_state(name: str, want: dict, got: dict) -> None:
    """Raise unless two checkpoint payloads (``checkpoint.load``) hold the
    same step, parameters and optimizer state, bit for bit."""
    if got["step"] != want["step"]:
        raise AssertionError(f"{name}: step {got['step']}, want {want['step']}")
    pairs = [(f"params[{k}]", got["params"].get(k), v) for k, v in want["params"].items()]
    gs, ws = got["opt_state"]["state"], want["opt_state"]["state"]
    if set(gs) != set(ws) or set(got["params"]) != set(want["params"]):
        raise AssertionError(f"{name}: the checkpoints hold different entries")
    for i, entry in ws.items():
        pairs += [(f"opt_state[{i}][{k}]", gs[i].get(k), v) for k, v in entry.items()]
    for label, g, w in pairs:
        same = (torch.equal(g, w) if isinstance(w, torch.Tensor) and isinstance(g, torch.Tensor)
                else g == w)
        if not same:
            raise AssertionError(f"{name}: {label} differs from the uninterrupted run's")
    if got["opt_state"]["param_groups"] != want["opt_state"]["param_groups"]:
        raise AssertionError(f"{name}: optimizer param groups differ")


def check_progress(progress: dict, want: dict) -> None:
    """Raise unless the journal's progress (``replay_batch_state``) counts
    each task's batches exactly once."""
    if progress != want:
        raise AssertionError(f"journaled progress {progress}, want {want}")


def check_memory(label: str, after: int, before: int, slack: int = MEMORY_SLACK) -> None:
    if after > before + slack:
        raise AssertionError(f"{label}: {after / 2**30:.3f} GiB allocated, "
                             f"{before / 2**30:.3f} GiB before")


def check_kill_journal(root: str, incarnations: int) -> dict:
    """Raise unless the journal replays strictly as one ``seq`` chain over
    ``incarnations`` recoveries, holds the JAX package's record kinds, and
    its torn tail went to a ``.corrupt`` sidecar. Returns the record count
    of each kind."""
    from saturn_tpu_torch.durability import replay

    recs = replay(root, strict=True)
    seqs = [r["seq"] for r in recs]
    if seqs != list(range(1, len(recs) + 1)):
        raise AssertionError(f"{root}: seq {seqs} is not one chain from 1")
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    missing = [k for k in JOURNAL_KINDS if k not in kinds]
    if missing or kinds.get("recovery") != incarnations:
        raise AssertionError(f"{root}: record kinds {kinds}; missing {missing}, want "
                             f"{incarnations} recovery records")
    if not [n for n in os.listdir(root) if ".corrupt" in n]:
        raise AssertionError(f"{root}: no .corrupt sidecar of the torn tail")
    return kinds


def idle_commits(jmod, root: str, n: int = 20) -> list:
    """Seconds of ``n`` journal commits of one small record each into a
    journal of its own, with no checkpoint write in flight."""
    from saturn_tpu_torch.utils import checkpoint as ckpt

    ckpt.flush()
    shutil.rmtree(root, ignore_errors=True)
    out = []
    with jmod.Journal(root) as journal:
        for i in range(n):
            journal.append("task_progress", task="probe", batches=i)
            t0 = time.perf_counter()
            journal.commit()
            out.append(time.perf_counter() - t0)
    return out


def kill_replay_phase(sat, flash, ce, card):
    """Two GPT-2-small tasks (b8 x 512, fused head, differing only in lr):
    one uninterrupted ``orchestrate(resume_dir=A)``, then a chain of three
    incarnations on journal B with fresh tasks each, killed at ``mid-fsync``
    (hit 2) and at ``mid-interval`` (hit 1), the third running to the end."""
    import gc
    import traceback

    from saturn_tpu_torch.durability import journal as jmod
    from saturn_tpu_torch.durability import recovery as rmod
    from saturn_tpu_torch.executor import orchestrator
    from saturn_tpu_torch.resilience import CrashInjector, SimulatedKill
    from saturn_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    root = os.path.join(CKPTS, "kill_replay")
    journals = {k: os.path.join(OUT, f"kill_replay_journal_{k}") for k in "AB"}
    cache_dir = os.path.join(OUT, "kill_replay_profile_cache")
    for d in (root, cache_dir, *journals.values()):
        shutil.rmtree(d, ignore_errors=True)
    main_cache = os.path.join(OUT, "main_path_profile_cache")
    if os.path.isdir(main_cache):  # phase 3 profiled this signature: no trial to run again
        shutil.copytree(main_cache, cache_dir)
    topo = topology()
    dev = torch.device(DEVICE, 0)

    def tasks_in(save_dir):
        tasks = [lm_task(sat, f"kill-lr{i}", lr, KILL_BATCHES, save_dir)
                 for i, lr in enumerate((6e-4, 1e-3))]
        sat.search(tasks, technique_names=["dp"], topology=topo, profile_cache=cache_dir)
        return tasks

    reset_counts(flash, ce)
    ref = tasks_in(os.path.join(root, "reference"))
    interval = KILL_INTERVAL_SHARE * min(t.strategies[1].runtime for t in ref)
    with CallTimes(commit=(jmod.Journal, "commit"), fsync=(os, "fsync")) as timer:
        t0 = time.perf_counter()
        out = sat.orchestrate(ref, interval=interval, topology=topo, resume_dir=journals["A"])
        t_ref = time.perf_counter() - t0
    names = sorted(t.name for t in ref)
    if sorted(out["completed"]) != names or out["failed"]:
        raise AssertionError(f"reference run: {out}")
    records = ref[0].strategies[1].executor.intervals
    runs = {n: [r["n"] for r in records if r["task"] == n] for n in names}
    if min(len(v) for v in runs.values()) < KILL_MIN_INTERVALS:
        raise AssertionError(f"reference intervals {runs}: lower KILL_INTERVAL_SHARE")
    want = {t.name: ckpt.load(t.ckpt_path) for t in ref}
    commit_s, fsync_s = timer.seconds["commit"], timer.seconds["fsync"]
    idle_s = idle_commits(jmod, os.path.join(OUT, "kill_replay_journal_idle"))
    log(f"  reference: interval {interval:.3f}s ({KILL_INTERVAL_SHARE} of the shortest "
        f"profiled runtime), batches per interval {runs}, {t_ref:.1f}s; {len(commit_s)} "
        f"journal commits, median {np.median(commit_s) * 1e3:.2f} ms, max "
        f"{max(commit_s) * 1e3:.2f} ms; the run's {len(fsync_s)} fsyncs (the commits' and "
        f"the journal's opening and closing) median {np.median(fsync_s) * 1e3:.2f} ms, max "
        f"{max(fsync_s) * 1e3:.2f} ms; with no checkpoint "
        f"write in flight a commit takes median {np.median(idle_s) * 1e3:.2f} ms, max "
        f"{max(idle_s) * 1e3:.2f}  [{card}]")
    del ref, records
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)

    chain = []
    t_chain = time.perf_counter()
    for point, hit in KILL_CHAIN:
        tasks = tasks_in(os.path.join(root, "chain"))
        inj = CrashInjector(point, hit=hit) if point else None
        timer = CallTimes(replay=(rmod, "replay_batch_state"),
                          reconcile=(rmod, "reconcile_checkpoints"),
                          fold=(orchestrator, "_fold_batch_recovery"),
                          checkpoint_step=(orchestrator, "_checkpoint_step"),
                          verify=(ckpt, "verify"), saved_step=(ckpt, "saved_step"),
                          commit=(jmod.Journal, "commit"))
        killed = None
        t0 = time.perf_counter()
        with timer:
            try:
                out = sat.orchestrate(tasks, interval=interval, topology=topo,
                                      resume_dir=journals["B"],
                                      crash_barrier=inj.barrier if inj else None)
            except SimulatedKill as e:
                killed = str(e)
                traceback.clear_frames(e.__traceback__)
        seconds = time.perf_counter() - t0
        step = {n: timer.seconds[n][0] if timer.seconds[n] else None
                for n in ("replay", "reconcile", "fold")}
        # the fold's checkpoint reads: waiting for a write in flight, verify, the step
        step["checkpoint_wait"] = (sum(timer.seconds["checkpoint_step"])
                                   - sum(timer.seconds["verify"])
                                   - sum(timer.seconds["saved_step"]))
        entry = {"kill": point, "hit": hit, "killed": killed, "seconds": seconds,
                 "recovery_s": step, "verify_s": timer.seconds["verify"],
                 "saved_step_s": timer.seconds["saved_step"],
                 "commit_s": timer.seconds["commit"],
                 "progress": rmod.replay_batch_state(journals["B"]).progress}
        if point is not None:
            if killed is None:
                raise AssertionError(f"the kill at {point} (hit {hit}) never fired: {out}")
            for t in tasks:  # the dead incarnation's states, graphs and pools
                t.release_live_state()
                t.release_compiled()
            del tasks
            gc.collect()
            entry["allocated_after"] = after = torch.cuda.memory_allocated(dev)
            check_memory(f"after the kill at {point}", after, before)
        chain.append(entry)
        log(f"  incarnation {len(chain)}: " + (f"killed at {point} (hit {hit})" if killed
                                                else "ran to the end")
            + f" in {seconds:.1f}s; recovery s: replay {step['replay']:.4f}, reconcile "
            f"{step['reconcile']:.3f}, fold {step['fold']:.3f} ({len(entry['verify_s'])} "
            f"checkpoint(s) verified in {sum(entry['verify_s']):.3f}s, "
            f"{step['checkpoint_wait']:.3f}s waiting for writes in flight); journaled progress "
            f"{entry['progress']}"
            + (f"; {entry['allocated_after'] / 2**30:.3f} GiB allocated after, "
               f"{before / 2**30:.3f} before" if killed else "") + f"  [{card}]")
    t_chain = time.perf_counter() - t_chain
    if sorted(out["completed"]) != names or out["failed"]:
        raise AssertionError(f"last incarnation: {out}")
    for t in tasks:
        check_same_state(t.name, want[t.name], ckpt.load(t.ckpt_path))
    progress = rmod.replay_batch_state(journals["B"]).progress
    check_progress(progress, {n: KILL_BATCHES for n in names})
    kinds = check_kill_journal(journals["B"], len(KILL_CHAIN))
    launches = counts(flash, ce)
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched in the kill-replay phase")
    del tasks, want
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"  every task at step {KILL_BATCHES}, parameters and AdamW moments bitwise equal "
        f"to the reference run's; journal B replays strictly, {kinds}, its torn tail in a "
        f".corrupt sidecar; launches {launches}")
    log(f"  kill chain {t_chain:.1f}s against the reference run's {t_ref:.1f}s; phase "
        f"{seconds:.1f}s  [{card}]")
    return {"interval_s": interval, "reference_s": t_ref, "reference_intervals": runs,
            "commit_s": {"median": float(np.median(commit_s)), "max": max(commit_s),
                         "n": len(commit_s), "fsync": fsync_s,
                         "idle_median": float(np.median(idle_s)), "idle_max": max(idle_s)},
            "incarnations": chain, "chain_s": t_chain, "journal_kinds": kinds,
            "progress": progress, "launches": launches, "allocated_before": before,
            "seconds": seconds}


# ------------------------------------------------------------------ phase 8
OFFLOAD_STEPS = 4
OFFLOAD_REL = 1e-4          # offload against dp: the repo's trajectory tolerance, relative
STREAM_BULK_LOSS_REL = 1e-5  # GPT-J-6B stream against bulk on one state and batch
STREAM_BULK_GRAD_REL = 1e-3  # the same, gradients by relative norm
STREAM = {"stream": True, "remat": True}
BULK = {"stream": False, "remat": False}
GPTJ = "gptj-6b"
GPTJ_LAYERS, GPTJ_CUT_LAYERS = 28, 24  # 24: the shallowest whose dp state passes the headroom
#: The depth of 8b-2, whose run writes a checkpoint of params and AdamW moments
#: (12 bytes a parameter): the card's machine takes at most 45 GiB of disk writes
#: a call, deleted files included, and 24 layers' checkpoint is 56.3 GiB. The
#: run cannot read what is left of that budget (``bytes_written``), so the depth
#: is the one a whole run has been seen to pass at.
GPTJ_CKPT_LAYERS = 4
#: The depth of 8c, GPT-J-6B offload against dp: dp's state (15.1 GiB) fits the card.
GPTJ_PARITY_LAYERS = 4
HOST_MIN_BYTES = 100 * 2**30  # host memory free for 28 layers' 65.3 GiB state, grads and the rest
DISK_MIN_BYTES = 75e9         # disk free at the save dir for one 28-layer checkpoint (70 GB)


def host_facts(free_text: str, nproc_text: str, df_text: str) -> dict:
    """The host's memory (``free -b``), cores (``nproc``) and free disk
    (``df -B1 --output=avail DIR``) as numbers: bytes and a count."""
    lines = [ln.split() for ln in free_text.strip().splitlines()]
    header = lines[0]
    mem = next(ln for ln in lines if ln[0] == "Mem:")
    values = dict(zip(header, (int(v) for v in mem[1:])))
    return {"mem_total": values["total"], "mem_available": values["available"],
            "cores": int(nproc_text.strip()),
            "disk_free": int(df_text.strip().splitlines()[-1].strip())}


def gptj_depth(facts: dict):
    """GPT-J-6B's depth on this host and why it was cut (None if not): 28
    layers where the host holds the offload state and its checkpoint, else
    24."""
    short = []
    if facts["mem_available"] < HOST_MIN_BYTES:
        short.append(f"{facts['mem_available'] / 2**30:.1f} GiB of host memory available, "
                     f"under {HOST_MIN_BYTES / 2**30:.0f} GiB")
    if facts["disk_free"] < DISK_MIN_BYTES:
        short.append(f"{facts['disk_free'] / 1e9:.1f} GB of disk free at the save dir, "
                     f"under {DISK_MIN_BYTES / 1e9:.0f} GB")
    return (GPTJ_CUT_LAYERS, "; ".join(short)) if short else (GPTJ_LAYERS, None)


SPLIT_KEYS = ("h2d_s", "compute_s", "d2h_s", "update_s", "step_s")


def split_summary(splits) -> dict:
    """Per-step lines and medians of offload steps' time splits
    (``HostOffload.splits`` records)."""
    lines = [f"step {r['step']}: host->card {r['h2d_s']:.3f}s ({r['h2d_bytes'] / 1e9:.2f} GB), "
             f"compute {r['compute_s']:.3f}s, card->host {r['d2h_s']:.3f}s "
             f"({r['d2h_bytes'] / 1e9:.2f} GB), host update {r['update_s']:.3f}s, "
             f"step {r['step_s']:.3f}s" for r in splits]
    median = {k: float(np.median([r[k] for r in splits])) if splits else None for k in SPLIT_KEYS}
    return {"lines": lines, "median": median, "steps": len(splits)}


def rel_diff(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def want_offload_launches(recompute: bool, steps: int, layers: int = LAYERS) -> dict:
    """Flash launches of ``steps`` steps over the logits: one of each kernel
    per layer, the forward twice where the blocks are recomputed."""
    want = {n: layers * steps for n in FLASH_NAMES}
    want["flash_fwd"] *= 2 if recompute else 1
    want.update({n: 0 for n in CE_NAMES})
    return want


def bytes_written() -> int:
    """Bytes this process has passed to write calls so far (``wchar`` of
    ``/proc/self/io``), deleted files included. The chip machine counts a
    call's disk writes on its host, where the run cannot read them."""
    with open("/proc/self/io") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("wchar:"))


def parity_programs():
    """(label, technique class, config, whether the blocks are recomputed)
    of the offload-against-dp runs over the logits."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.offload import HostOffload

    return (("offload-stream", HostOffload, STREAM, True),
            ("offload-bulk", HostOffload, BULK, False),
            ("dp-logits", DataParallel, {"remat": False}, False))


def offload_parity(sat, flash, ce, card):
    """Phase 8a: offload stream and bulk against dp over the logits at
    GPT-2-small, b8 x 512, from one seed-0 init, one step at a time."""
    import gc

    from saturn_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device(DEVICE, 0)
    runs = {}
    for label, cls, config, recompute in parity_programs():
        task = lm_task(sat, f"parity-{label}", 6e-4, OFFLOAD_STEPS,
                       os.path.join(CKPTS, "parity", label), loss_fn=untagged_loss)
        tech = cls()
        task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
        task.select_strategy(1)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        tech.execute(task, [dev], 0, override_batch_count=OFFLOAD_STEPS, window_size=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts(flash, ce)
        want = want_offload_launches(recompute, OFFLOAD_STEPS)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        state = task._live_state[1]
        held = torch.cuda.memory_allocated(dev) - base
        run = {"losses": task.last_losses, "launches": got, "held_bytes": held,
               "seconds": seconds, "ms_per_step": task.last_per_batch_s * 1e3}
        if "host" in state:
            host = state["host"]
            if not host.pinned() or not next(state["params"].parameters()).is_pinned():
                raise AssertionError(f"{label}: the host state is not pinned")
            run.update(pinned_bytes=host.nbytes(),
                       splits=split_summary([r for r in tech.splits if r["task"] == task.name]))
        runs[label] = run
        log(f"  {label} {config}: losses {np.round(task.last_losses, 5).tolist()}, "
            f"{run['ms_per_step']:.1f} ms/step, launches {got}, "
            f"{held / 2**30:.3f} GiB held on the card after the steps"
            + (f", {run['pinned_bytes'] / 2**30:.2f} GiB pinned on the host" if "host" in state
               else "") + f"  [{card}]")
        for line in run.get("splits", {}).get("lines", []):
            log(f"    {line}  [{card}]")
        task.release_live_state()
        task.release_compiled()
        ckpt.flush()
    ref = runs["dp-logits"]
    n_params = sum(p.numel() for p in lm_task(
        sat, "parity-count", 6e-4, 1, CKPTS).get_model().abstract_init().parameters())
    moments = 2 * 4 * n_params
    for label in ("offload-stream", "offload-bulk"):
        diff = rel_diff(runs[label]["losses"], ref["losses"])
        bitwise = runs[label]["losses"] == ref["losses"]
        if not diff <= OFFLOAD_REL:
            raise AssertionError(f"{label}: losses {runs[label]['losses']} against dp's "
                                 f"{ref['losses']}: {diff:.3e} relative, over {OFFLOAD_REL:g}")
        below = ref["held_bytes"] - runs[label]["held_bytes"]
        if below < moments:
            raise AssertionError(f"{label} holds {runs[label]['held_bytes']} bytes on the card "
                                 f"after its steps, dp {ref['held_bytes']}: under dp's by less "
                                 f"than the AdamW moments ({moments})")
        runs[label].update(loss_rel_diff=diff, bitwise=bitwise)
        log(f"  {label} against dp over the logits: max relative loss difference {diff:.3e}"
            f" ({'bitwise equal' if bitwise else 'not bitwise'}); {below / 1e9:.2f} GB less "
            f"held on the card than dp (AdamW moments {moments / 1e9:.2f} GB)")
    return runs


class TechniqueSearches:
    """Every technique instance whose ``search`` runs inside the block."""

    def __enter__(self):
        from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique

        self.cls, self.orig, self.seen = SPMDTechnique, SPMDTechnique.search, []

        def search(tech, *args, **kwargs):
            if tech not in self.seen:
                self.seen.append(tech)
            return self.orig(tech, *args, **kwargs)

        SPMDTechnique.search = search
        return self

    def __exit__(self, *exc):
        self.cls.search = self.orig

    def named(self, name):
        return next(t for t in self.seen if t.name == name)


def run_text(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=60).stdout


def gptj_task(sat, name, layers, save_dir, loss_fn=None):
    """A GPT-J-6B task at ``layers`` layers (the rest at the published
    shape), AdamW at the reference's lr, b8 x 512 synthetic tokens."""
    task = lm_task(sat, name, 1e-4, OFFLOAD_STEPS, save_dir, model=GPTJ, loss_fn=loss_fn,
                   n_layers=layers)
    cfg = task.get_model().config
    n = sum(p.numel() for p in task.get_model().abstract_init().parameters())
    log(f"  {name}: GPT-J-6B at {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.ff_dim}, rotary {cfg.rotary_dim}, parallel residual "
        f"{cfg.parallel_residual}, vocab {cfg.vocab_size}, attention {cfg.attention}, "
        f"b{BATCH} x {SEQ}: {n:,} parameters; dp's fp32 params, grads and AdamW moments "
        f"{16 * n / 2**30:.1f} GiB, a checkpoint (params and moments) {12 * n / 2**30:.1f} GiB")
    return task, n


def gptj_search(sat, flash, ce, card, searched_inits):
    """Phase 8b-1: GPT-J-6B (cut in depth only where the host cannot hold
    it): dp screened out before any init, offload's configs timed on one
    shared host state."""
    import gc

    save_dir = os.path.join(CKPTS, "gptj")
    os.makedirs(save_dir, exist_ok=True)
    log(f"  host: free -g\n{run_text(['free', '-g']).rstrip()}")
    facts = host_facts(run_text(["free", "-b"]), run_text(["nproc"]),
                       run_text(["df", "-B1", "--output=avail", save_dir]))
    log(f"  host: {facts['cores']} cores, {facts['mem_total'] / 2**30:.1f} GiB of memory "
        f"({facts['mem_available'] / 2**30:.1f} GiB available), "
        f"{facts['disk_free'] / 1e9:.1f} GB of disk free at {save_dir}")
    layers, cut = gptj_depth(facts)
    if cut:
        log(f"  cut: GPT-J-6B at {layers} of its {GPTJ_LAYERS} layers, depth only: {cut}")
    task, n_params = gptj_task(sat, "gptj-6b", layers, save_dir)
    topo = topology()
    sat.library.register_default_library()
    cache_dir = os.path.join(OUT, "gptj_profile_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    with TechniqueSearches() as searched, searched_inits:
        stats = sat.search([task], technique_names=["dp", "offload"], topology=topo,
                           profile_cache=cache_dir)
    t_search = time.perf_counter() - t0
    trial_launches = counts(flash, ce)
    if not all(trial_launches[n] for n in FLASH_NAMES):
        raise AssertionError(f"{task.name}: the trials launched the flash kernels "
                             f"{trial_launches}, want each at head dim 256")
    gc.collect()
    dp, off = searched.named("dp"), searched.named("offload")
    outcomes = {"dp": [(c, o) for _, _, c, _, o in dp.trials],
                "offload": [(c, s, o) for _, _, c, s, o in off.trials]}
    if not dp.trials or any(o != "static" for _, o in outcomes["dp"]):
        raise AssertionError(f"dp trials {dp.trials}: want every config screened out statically")
    if any(o not in ("ok", "memory") for *_, o in outcomes["offload"]):
        raise AssertionError(f"offload trials {off.trials}")
    for c, o in outcomes["dp"]:
        log(f"    trial dp {c}: infeasible by the static screen, no init drawn")
    for c, spb, o in outcomes["offload"]:
        log(f"    trial offload {c}: " + (f"{spb:.3f} s/batch" if spb is not None
                                          else "infeasible (out of device memory)")
            + f"  [{card}]")
    split = split_summary(list(off.splits))
    for line in split["lines"]:
        log(f"      trial {line}  [{card}]")
    strat = task.strategies[1]
    if not strat.feasible or strat.executor.name != "offload":
        raise AssertionError(f"gptj-6b: no offload strategy won: {strat}")
    log(f"  search: {stats}, {t_search:.1f}s; won: offload {strat.params} at "
        f"{strat.per_batch_time:.3f} s/batch; the host state drawn in "
        f"{searched_inits.seconds['state']} s, its buffers allocated and pinned in "
        f"{searched_inits.seconds['buffer']} s; the trials' launches {trial_launches}  [{card}]")
    return {"facts": facts, "layers": layers, "cut": cut, "params": n_params,
            "stats": stats, "seconds": t_search, "trial_launches": trial_launches,
            "dp": outcomes["dp"],
            "offload": outcomes["offload"], "splits": split, "won": strat.params,
            "s_per_batch": strat.per_batch_time}


def grads_against(host, want: torch.Tensor):
    """The host state's gradients against ``want`` (the same flat layout, on
    the card), parameter by parameter: (relative norm of the difference,
    whether bitwise equal)."""
    num = den = 0.0
    same = True
    for _, off, n, _ in host.layout.entries:
        got = host.grads[off:off + n].to(want.device, non_blocking=True)
        ref = want[off:off + n]
        same = same and torch.equal(got, ref)
        num += float(((got - ref).double() ** 2).sum())
        den += float((ref.double() ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5, same


def gptj_train(sat, flash, ce, card, inits):
    """Phase 8b-2: GPT-J-6B at GPTJ_CKPT_LAYERS through search(["offload"])
    -> orchestrate to a checkpoint at step OFFLOAD_STEPS, restored in place;
    stream against bulk on that state and one batch."""
    import gc

    from saturn_tpu_torch.parallel.offload import HostOffload
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens
    from saturn_tpu_torch.utils import checkpoint as ckpt

    save_dir = os.path.join(CKPTS, "gptj")
    os.makedirs(save_dir, exist_ok=True)
    task, n_params = gptj_task(sat, "gptj-6b-ckpt", GPTJ_CKPT_LAYERS, save_dir)
    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    topo = topology()
    cache_dir = os.path.join(OUT, "gptj_profile_cache")
    with inits:
        sat.search([task], technique_names=["offload"], topology=topo, profile_cache=cache_dir)
    strat = task.strategies[1]
    off = strat.executor
    log(f"  search(['offload']): won {strat.params} at {strat.per_batch_time:.3f} s/batch  "
        f"[{card}]")
    torch.cuda.reset_peak_memory_stats(dev)
    n_before = len(off.splits)
    written = bytes_written()
    log(f"  written by this run before the checkpointed run: {written / 2**30:.2f} GiB "
        f"(write calls, deleted files included)")
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    with CallTimes(write=(ckpt, "_write")) as writes, inits:
        out = sat.orchestrate([task], interval=2.0 * strat.runtime + 60.0, topology=topo)
        ckpt.flush()
    t_orch = time.perf_counter() - t0
    launches = counts(flash, ce)
    want = want_offload_launches(bool(strat.params.get("stream") or strat.params.get("remat")),
                                 OFFLOAD_STEPS, GPTJ_CKPT_LAYERS)
    if launches != want:
        raise AssertionError(f"{task.name}: orchestrate launched {launches}, want {want}")
    log(f"  orchestrate's kernel launches (head dim 256): {launches}")
    peak = {"allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev)}
    if out["completed"] != [task.name]:
        raise AssertionError(f"{task.name} did not complete: {out}")
    steps = split_summary([r for r in list(off.splits)[n_before:] if r["task"] == task.name])
    for line in steps["lines"]:
        log(f"    {line}  [{card}]")
    ckpt_bytes = os.path.getsize(task.ckpt_path)
    log(f"  orchestrate: {t_orch:.1f}s, losses {np.round(task.last_losses, 4).tolist()}; peak "
        f"{peak['allocated'] / 2**30:.2f} GiB allocated, {peak['reserved'] / 2**30:.2f} GiB "
        f"reserved on the card; checkpoint {ckpt_bytes / 1e9:.2f} GB written in "
        f"{writes.seconds['write']} s; host states drawn in {inits.seconds['state']} s "
        f"(8b so far)  [{card}]")
    if not np.isfinite(task.last_losses).all():
        raise AssertionError(f"{task.name} losses {task.last_losses}")
    gc.collect()
    torch.cuda.empty_cache()
    check_memory(f"{task.name} after orchestrate", torch.cuda.memory_allocated(dev), before)

    # stream against bulk, one state (the checkpoint, restored in place) and one batch
    tech = HostOffload()
    t0 = time.perf_counter()
    state = ckpt.restore(task.ckpt_path, tech.build(task, [dev], STREAM).empty())
    t_restore = time.perf_counter() - t0
    host = state["host"]
    if state["step"] != OFFLOAD_STEPS:
        raise AssertionError(f"{task.name} checkpoint at step {state['step']}, "
                             f"want {OFFLOAD_STEPS}")
    bad = nonfinite(dict(state["params"].named_parameters()))
    if bad:
        raise AssertionError(f"{task.name} checkpoint holds non-finite weights: {bad}")
    if not host.pinned():
        raise AssertionError(f"{task.name}: the restored host state is not pinned")
    log(f"  restored step {state['step']} in place in {t_restore:.1f}s: finite weights, "
        f"{host.nbytes() / 2**30:.2f} GiB pinned on the host")
    state["opt_state"].step = lambda: None  # the check takes no update
    at = state["step"]
    batch = stage_tokens(task.batch_at(0), dev)
    _, loss_s = tech.build(task, [dev], STREAM).step(state, batch)
    loss_s = loss_s.item()
    grads_s = host.grads.to(dev)
    _, loss_b = tech.build(task, [dev], {"stream": False, "remat": True}).step(state, batch)
    loss_b = loss_b.item()
    grad_rel, same = grads_against(host, grads_s)
    bitwise = same and loss_s == loss_b
    loss_rel = abs(loss_b - loss_s) / abs(loss_s)
    check_split = split_summary(list(tech.splits))
    for line in check_split["lines"]:
        log(f"    check {line}  [{card}]")
    del grads_s, batch
    if not (loss_rel <= STREAM_BULK_LOSS_REL and grad_rel <= STREAM_BULK_GRAD_REL):
        raise AssertionError(f"{task.name} stream loss {loss_s} against bulk {loss_b} "
                             f"({loss_rel:.3e} relative), gradients {grad_rel:.3e} by relative "
                             f"norm: over {STREAM_BULK_LOSS_REL:g} / {STREAM_BULK_GRAD_REL:g}")
    log(f"  stream against bulk on step {at}'s state: loss {loss_s:.6f} / {loss_b:.6f} "
        f"({loss_rel:.2e} relative), gradients {grad_rel:.2e} by relative norm "
        f"({'bitwise equal' if bitwise else 'not bitwise'})")
    pinned_bytes = host.nbytes()
    del state, host
    gc.collect()
    torch.cuda.empty_cache()
    check_memory(f"{task.name} after the check", torch.cuda.memory_allocated(dev), before)
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"layers": GPTJ_CKPT_LAYERS, "params": n_params, "won": strat.params,
            "s_per_batch": strat.per_batch_time, "orchestrate_s": t_orch,
            "launches": launches, "written_before_bytes": written,
            "losses": task.last_losses, "steps": steps, "peak_bytes": peak,
            "pinned_bytes": pinned_bytes, "ckpt_bytes": ckpt_bytes,
            "ckpt_write_s": writes.seconds["write"], "restore_s": t_restore,
            "stream_vs_bulk": {"loss": [loss_s, loss_b], "loss_rel": loss_rel,
                               "grad_rel": grad_rel, "bitwise": bitwise,
                               "splits": check_split}}


def bundle_steps(tech, task, config, dev, steps: int):
    """``steps`` steps one at a time through the technique's bundle from the
    seed-0 init, on the task's first batches; no checkpoint is written. The
    per-step losses."""
    from saturn_tpu_torch.parallel.spmd_base import stage_tokens

    bundle = tech.build(task, [dev], config)
    state = bundle.init()
    losses = []
    for i in range(steps):
        state, loss = bundle.step(state, stage_tokens(task.batch_at(i), dev))
        losses.append(loss.reshape(()))
    out = torch.stack(losses).float().cpu().tolist()
    del state, bundle
    return out


def gptj_parity(sat, flash, ce, card):
    """Phase 8c: GPT-J-6B at GPTJ_PARITY_LAYERS over the logits (published
    widths: head dim 256, rotary, parallel residual), 4 steps from one seed-0
    init under offload stream, offload bulk and dp; no checkpoint (12 GB
    each at this depth)."""
    import gc

    dev = torch.device(DEVICE, 0)
    task, n_params = gptj_task(sat, "gptj-6b-parity", GPTJ_PARITY_LAYERS,
                               os.path.join(CKPTS, "gptj-parity"), loss_fn=untagged_loss)
    runs = {}
    for label, cls, config, recompute in parity_programs():
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts(flash, ce)
        t0 = time.perf_counter()
        losses = bundle_steps(cls(), task, config, dev, OFFLOAD_STEPS)
        seconds = time.perf_counter() - t0
        got = counts(flash, ce)
        want = want_offload_launches(recompute, OFFLOAD_STEPS, GPTJ_PARITY_LAYERS)
        if got != want:
            raise AssertionError(f"gptj {label}: launches {got}, want {want}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"gptj {label}: losses {losses}")
        runs[label] = {"losses": losses, "launches": got, "seconds": seconds}
        log(f"  {label} {config}: losses {np.round(losses, 5).tolist()}, launches {got}, "
            f"{seconds:.1f}s with the init  [{card}]")
    ref = runs["dp-logits"]["losses"]
    for label in ("offload-stream", "offload-bulk"):
        got = runs[label]["losses"]
        diff = rel_diff(got, ref)
        if not diff <= OFFLOAD_REL:
            raise AssertionError(f"gptj {label}: losses {got} against dp's {ref}: "
                                 f"{diff:.3e} relative, over {OFFLOAD_REL:g}")
        runs[label].update(loss_rel_diff=diff, bitwise=got == ref)
        log(f"  {label} against dp over the logits: max relative loss difference {diff:.3e} "
            f"({'bitwise equal' if got == ref else 'not bitwise'})")
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": GPTJ_PARITY_LAYERS, "params": n_params, "runs": runs}


def offload_phase(sat, flash, ce, card) -> dict:
    from saturn_tpu_torch.parallel import offload as offload_mod

    log("phase 8a: offload stream and bulk against dp over the logits, GPT-2-small b8x512")
    t0 = time.perf_counter()
    out = {"parity": offload_parity(sat, flash, ce, card)}
    log(f"  phase 8a took {time.perf_counter() - t0:.1f}s")
    for label, run, inits in (("8b-1", gptj_search, "search"), ("8b-2", gptj_train, "train")):
        log(f"phase {label}: GPT-J-6B b8x512 on one card, "
            + ("search(['dp', 'offload'])" if inits == "search"
               else f"{GPTJ_CKPT_LAYERS} layers, search(['offload']) -> orchestrate"))
        # every host state's allocation, pinning and draw, and its buffers alone
        timer = CallTimes(state=(offload_mod, "make_host_state"),
                          buffer=(offload_mod._HostBuffer, "__init__"))
        t0 = time.perf_counter()
        out[inits] = run(sat, flash, ce, card, timer)
        out[inits].update(phase_s=time.perf_counter() - t0, host_state_s=timer.seconds["state"],
                          host_buffer_s=timer.seconds["buffer"])
        log(f"  phase {label} took {out[inits]['phase_s']:.1f}s")
    log(f"phase 8c: GPT-J-6B b8x512 at {GPTJ_PARITY_LAYERS} layers, offload stream and bulk "
        "against dp over the logits")
    t0 = time.perf_counter()
    out["parity_gptj"] = gptj_parity(sat, flash, ce, card)
    log(f"  phase 8c took {time.perf_counter() - t0:.1f}s")
    return out


def option(argv, name: str, default=None):
    """The value after ``name`` in ``argv``, or ``default``."""
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    root = os.path.abspath(option(argv, "--root", REPO))  # whose port: --flash-sweep only
    if root != REPO and "--flash-sweep" not in argv:
        raise SystemExit("chip_smoke: --root goes with --flash-sweep")
    sys.path.insert(0, root)
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.ops import ce, flash
    from saturn_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    shutil.rmtree(CKPTS, ignore_errors=True)
    t_start = time.perf_counter()

    log("phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; device {kind}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    sources = ("flash_attn", "linear_ce")
    cuda_build.load_all(sources)
    log(f"  built and loaded the CUDA kernels of {sources} in {time.perf_counter() - t0:.1f}s")
    for src in sources:
        report = cuda_build.build_log(src)
        with open(os.path.join(OUT, f"ptxas_{src}.log"), "w") as f:
            f.write(report)
        for line in report.splitlines():
            # advisories C7510-C7519 ("Potential Performance Loss", an injected
            # warpgroup.wait): ptxas serialized or delayed a kernel's wgmma
            if ("registers" in line or "spill" in line or "(C751" in line
                    or "Performance Loss" in line):
                log(f"    ptxas {src}: {line.strip()}")
        if root == REPO:
            check_sass(cuda_build, src)
    if "--flash-sweep" in argv:
        head_dim = option(argv, "--head-dim")
        log(f"flash sweep of the port in {root}"
            + (f", head dim {head_dim}" if head_dim else ""))
        rows = flash_sweep(flash, [row for row in SWEEP
                                   if head_dim is None or row[3] == int(head_dim)])
        name = ("flash_sweep.json" if root == REPO
                else f"flash_sweep_{os.path.basename(root)}.json")
        with open(os.path.join(OUT, name), "w") as f:
            json.dump({"card": card, "kind": kind, "root": root, "rows": rows}, f, indent=1)
        return 0
    if "--staging-ab" in argv:
        log("staging: inline against a thread")
        with open(os.path.join(OUT, "staging_ab.json"), "w") as f:
            json.dump(staging_ab(sat, card), f, indent=1)
        return 0
    if "--offload" in argv:
        log("the flash kernels at head dim 256 (phase 8b's attention)")
        rows_d256 = check_head_dim_256(flash)
        offload = offload_phase(sat, flash, ce, card)
        with open(os.path.join(OUT, "offload.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "kernel_rows_d256": rows_d256,
                       "offload": offload,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
        shutil.rmtree(CKPTS, ignore_errors=True)
        return 0

    log("phase 2: kernels against their plain versions")
    main_shape = (BATCH, 12, 12, SEQ, 64)
    rows = check_kernels(flash, main_shape, True, 0, timed=True)
    check_kernels(flash, (2, 32, 4, 1024, 64), True, 1, timed=False)
    check_kernels(flash, main_shape, False, 2, timed=False)  # BERT-base's shape
    for seed, shape in enumerate(((BATCH, 12, 12, 64, 64), (4, 12, 12, 320, 64),
                                  (2, 8, 2, SEQ, 128), (4, 16, 4, 2048, 128)), start=10):
        for causal in (True, False):
            check_kernels(flash, shape, causal, seed, timed=False)
    N, D = BATCH * SEQ, 768
    rows.update(check_ce(ce, N, D, VOCAB, True, 3, 0, timed=True))
    recompute = check_ce(ce, N, D, VOCAB, False, 4, 0, timed=True)
    recompute["ce_ds"] = check_ds(ce, N, D, VOCAB, 9, timed=True)
    check_ce(ce, 4000, D, 50257, True, 5, 64, timed=False)
    check_ce(ce, 4000, D, 50257, False, 8, 64, timed=False)
    # the other widths of the dx and dW kernels in both modes: D tiles of 256 and of 64
    for stash in (True, False):
        check_ce(ce, N, 1024, VOCAB, stash, 6, 0, timed=False)
        check_ce(ce, 4000, 64, 50257, stash, 7, 64, timed=False)
    # recompute over 5 slabs, the last ragged, and N that no token tile divides
    check_ce(ce, 6000, D, 50257, False, 11, 64, timed=False)
    check_ds(ce, 6000, D, 50257, 12, timed=False)
    # the shapes of phase 4's b8 x 1024 run: its CE head in recompute mode at N 8192, its
    # flash kernels at T 1024
    check_ce(ce, BATCH * LONG_SEQ, D, VOCAB, False, 13, 0, timed=False)
    check_ds(ce, BATCH * LONG_SEQ, D, VOCAB, 14, timed=False)
    check_kernels(flash, (BATCH, 12, 12, LONG_SEQ, 64), True, 15, timed=False)
    # GPT-J-6B's attention (phase 8b): head dim 256
    rows_d256 = check_head_dim_256(flash)
    torch.cuda.empty_cache()

    log("phase 3: search -> orchestrate, two GPT-2-small tasks and one BERT-base task b8x512")
    launches, main_results = main_path(sat, flash, ce, card)

    log("phase 4: the kernels on the training path (dp execute, pinned)")
    pinned = pinned_runs(sat, flash, ce, card)
    pinned[f"b{BATCH}x{LONG_SEQ}"] = long_context_runs(sat, flash, ce, card)

    log("phase 5: where a step's time goes (pinned configs)")
    step_profile = profile_steps(sat, card)
    step_profile["flash-windows"] = profile_windows(sat, card)
    step_profile[f"flash-{LONG_SEQ}-windows"] = profile_windows(
        sat, card, label=f"flash-{LONG_SEQ}", seq=LONG_SEQ, compare_optimizers=False)

    log("phase 6: a sweep past milp_task_limit, 13 GPT-2-small tasks b8x512, defaults")
    sweep_launches, sweep = sweep_phase(sat, flash, ce, card)
    launches = {n: launches[n] + sweep_launches[n] for n in KERNEL_NAMES}
    log(f"  main-path launches, phases 3 and 6: {launches}")

    log("phase 7: kill-replay of a two-task GPT-2-small sweep b8x512 (resume_dir)")
    kill_replay = kill_replay_phase(sat, flash, ce, card)
    shutil.rmtree(CKPTS, ignore_errors=True)

    offload = offload_phase(sat, flash, ce, card)
    shutil.rmtree(CKPTS, ignore_errors=True)

    def entry(row, n_launches):
        return {"launches": n_launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = []
    for n in KERNEL_NAMES:
        k = {"name": n, "route": "cuda",
             "source": "saturn_tpu_torch/csrc/" + ("flash_attn.cu" if n in FLASH_NAMES
                                                  else "linear_ce.cu"),
             "replaces": SOURCES[n], **entry(rows[n], launches[n])}
        if n in FLASH_NAMES:
            # head dim 256 at GPT-J-6B's shape; launches: phase 8b-2's orchestrate
            k["head_dim_256"] = entry(rows_d256[n], offload["train"]["launches"][n])
        kernels.append(k)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "kernels": kernels, "kernel_rows": rows,
                   "kernel_rows_d256": rows_d256, "ce_recompute_rows": recompute, "main_path": main_results,
                   "pinned": pinned, "step_profile": step_profile, "sweep": sweep,
                   "kill_replay": kill_replay, "offload": offload,
                   "short_profiles": SHORT_PROFILES,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"profiles short of their launch count, each taken again: {len(SHORT_PROFILES)} "
        f"{SHORT_PROFILES}")
    log(f"done in {time.perf_counter() - t_start:.1f}s; {bytes_written() / 2**30:.2f} GiB "
        f"passed to write calls")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
