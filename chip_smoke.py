#!/usr/bin/env python3
"""Drive the PyTorch port (``saturn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an exception and a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, and the build of the CUDA kernels from
   ``saturn_tpu_torch/csrc/flash_attn.cu`` and ``csrc/linear_ce.cu`` (one
   ``nvcc`` each, started together), with each kernel's ptxas line and the
   wgmma / TMA / cp.async / mma.sync instructions in its SASS
   (``cuobjdump``); the three flash kernels, the CE forward and the
   stash-mode CE dx and dW kernels must hold wgmma and TMA tile loads.
2. Kernels against their plain PyTorch versions: flash forward, dQ and
   dK/dV at the GPT-2-small training shape (B 8, H 12, T 512, D 64, bf16,
   causal), a grouped-query shape (B 2, H 32, KV 4, T 1024, D 64), the main
   shape non-causal (BERT-base's), one tile (T 64), T 320 (T % 128 == 64),
   head dim 128 with grouped queries (H 8, KV 2) and, with long walks, (B 4,
   H 16, KV 4, T 2048), causal and not; the CE head's forward,
   dx and dW at the main shape (N 4096, D 768, V 50304) and at an odd shape
   (N 4000, V 50257, the last 64 labels ignored), each in stash and in
   recompute mode, and in stash mode at D 1024 and at D 64 (odd shape). Each
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
   ``register_default_library`` -> ``search(["dp"])`` -> ``orchestrate``;
   every checkpoint must reach its ``batch_count`` with finite, falling
   losses, and all six kernels must have run. The kernel launch counts of
   this phase go into the kernels line.
4. The kernels on the training path: dp ``execute`` of GPT-2-small for 10
   steps pinned to flash attention, from the same init and batches as a run
   pinned to dense and a flash run over the logits (a loss without the
   fused-head tag); exactly 12 launches of each flash kernel and 1 of each
   CE kernel per step where they apply, none elsewhere, and the three loss
   trajectories agree within the bf16 band.
5. Where a step's time goes, for the three pinned configs: synchronized
   per-step times, peak device memory, and a torch.profiler window (device
   busy share, each kernel's launches and device time inside the step, top
   operators).

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/``.

    python3 chip_smoke.py --flash-sweep

builds the kernels and only times the three flash kernels against SDPA's
forward and backward alone (dQ + dK/dV against the backward) over a sweep
of sequence lengths and batch sizes (``chiprun_out/flash_sweep.json``): how
their time scales with the work.
"""

from __future__ import annotations

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
    "flash_fwd": ("(anonymous namespace)::fwd_kernel<",),
    "flash_dq": ("(anonymous namespace)::dq_kernel<",),
    "flash_dkv": ("(anonymous namespace)::dkv_kernel<",),
    "ce_fwd": ("(anonymous namespace)::ce_fwd_",),  # ce_fwd_sm90_kernel<, ce_fwd_combine_kernel
    # ce_dx_sm90_kernel<, the recompute-mode ce_dx_kernel, ce_dx_reduce_kernel
    "ce_dx": ("(anonymous namespace)::ce_dx_",),
    "ce_dw": ("(anonymous namespace)::ce_dw_",),  # ce_dw_sm90_kernel<, recompute ce_dw_kernel
}
#: A CE wrapper's second kernel (the forward's combine, dx's split-K
#: reduction): its time counts to the wrapper's, its launches do not.
SECOND_KERNELS = ("ce_fwd_combine_kernel", "ce_dx_reduce_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


#: Instructions counted in each kernel's SASS: wgmma, TMA tile loads,
#: cp.async copies, mma.sync.
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")
#: Kernels whose SASS must hold wgmma and TMA tile loads, by source.
WGMMA_KERNELS = {"flash_attn": ("fwd_kernel", "dq_kernel", "dkv_kernel"),
                 "linear_ce": ("ce_fwd_sm90_kernel", "ce_dx_sm90_kernel", "ce_dw_sm90_kernel")}


def sass_kernel_name(fn: str):
    """(kernel name, its int or bool template argument as digits, or None) of
    a mangled SASS function name, or (fn, None) when it names no ``*_kernel``."""
    m = re.search(r"((?:ce_)?[a-z]+(?:_[a-z]+)?(?:_sm90)?_kernel)(?:IL[ib](\d+)E)?", fn)
    return (m.group(1), m.group(2)) if m else (fn, None)


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
    of WGMMA_KERNELS[src] is missing or holds no HGMMA or no UTMALDG."""
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
            missing = [op for op in ("HGMMA", "UTMALDG") if not counts[op]]
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


def step_kernels(events, n: int):
    """{kernel name: {launches_per_step, device_ms_per_step}} of the device
    events of ``n`` profiled steps, each kernel found by KERNEL_SYMBOLS; a
    second kernel's time counts to its wrapper, its launches do not."""
    kernels = {}
    for name, symbols in KERNEL_SYMBOLS.items():
        mine = [(e, a, b) for e, a, b in events if any(s in e for s in symbols)]
        kernels[name] = {
            "launches_per_step": sum(not any(s in e for s in SECOND_KERNELS)
                                     for e, _, _ in mine) / n,
            "device_ms_per_step": sum(b - a for _, a, b in mine) / 1e3 / n}
    return kernels


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
    g = 1: the softmax part alone, by relative norm within CE_GRAD_REL."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device=DEVICE) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=DEVICE, dtype=torch.int32)
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


#: (B, H, T, D, causal) of the flash sweep: T at the main batch, causal and
#: not; the batch at the main T; head dim 128.
SWEEP = ([(BATCH, 12, T, 64, True) for T in (64, 128, 256, 512, 1024, 2048, 4096)]
         + [(BATCH, 12, T, 64, False) for T in (128, 256, 512, 1024)]
         + [(B, 12, SEQ, 64, True) for B in (1, 2, 4, 16, 32)]
         + [(4, 16, T, 128, True) for T in (512, 2048)])


def flash_sweep(flash):
    """Device times of the three flash kernels and of SDPA's forward and
    backward alone over SWEEP; the forward's rate in TFLOP/s, and dQ + dK/dV
    against SDPA's backward alone."""
    rows = []
    for B, H, T, D, causal in SWEEP:
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
        row = {"B": B, "H": H, "T": T, "D": D, "causal": causal,
               "tile_steps": B * H * (n * (n + 1) // 2 if causal else n * n),
               **{name: device_ms(fn, windows=1) for name, fn in timings.items()}}
        row["fwd_tflops"] = work(B, H, H, T, D, causal)["flash_fwd"][0] / row["fwd_ms"] / 1e9
        row["bwd_vs_sdpa"] = (row["dq_ms"] + row["dkv_ms"]) / row["sdpa_bwd_ms"]
        rows.append(row)
        log(f"  B{B} H{H} T{T} D{D} causal={causal}: {row['tile_steps']} tile steps; "
            f"fwd {row['fwd_ms']:.4f} ms ({row['fwd_tflops']:.0f} TFLOP/s), SDPA fwd "
            f"{row['sdpa_fwd_ms']:.4f}; dq {row['dq_ms']:.4f} + dkv {row['dkv_ms']:.4f} "
            f"against SDPA bwd alone {row['sdpa_bwd_ms']:.4f} ({row['bwd_vs_sdpa']:.2f}x)")
        del out4
    return rows


# ------------------------------------------------------------------ phase 3
def lm_task(sat, name, lr, batch_count, save_dir, model=GPT2, loss_fn=None, **kwargs):
    """A GPT-2 (``pretraining_loss``) or BERT (``mlm_loss``, [MASK] id kept
    out of the data) task at the main path's shapes, synthetic tokens."""
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.bert import build_bert, mlm_loss
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss

    bert = model == BERT
    build = build_bert if bert else build_gpt2
    return sat.Task(
        get_model=lambda **kw: build(model, **kw),
        get_dataloader=lambda: make_lm_dataset(context_length=SEQ, batch_size=BATCH,
                                               vocab_size=VOCAB, seed=0,
                                               reserved_ids=1 if bert else 0),
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
    from saturn_tpu_torch.solver import milp
    from saturn_tpu_torch.utils import checkpoint as ckpt

    names = sat.library.register_default_library()
    tasks = [lm_task(sat, f"gpt2s-lr{i}", lr, 20, CKPTS) for i, lr in enumerate((6e-4, 1e-3))]
    tasks.append(lm_task(sat, "bert-base", 1e-3, 20, CKPTS, model=BERT))
    loss0 = {t.name: initial_loss(t) for t in tasks}
    topo = topology()
    reset_counts(flash, ce)
    t0 = time.perf_counter()
    stats = sat.search(tasks, technique_names=["dp"], topology=topo)
    t_search = time.perf_counter() - t0
    tech = tasks[0].strategies[1].executor
    log(f"  library {names}; search profiled {stats['trials_run']} (task, size) points, "
        f"{len(tech.trials)} configs, in {t_search:.1f}s:")
    for task_name, size, config, spb, outcome in tech.trials:
        log(f"    trial {task_name} g={size} {config}: "
            + (f"{spb:.6f} s/batch" if spb is not None else f"infeasible ({outcome})")
            + f"  [{card}]")
    if any(spb is None for *_, spb, _ in tech.trials):
        raise AssertionError("a trial did not fit in device memory: see the lines above")
    won = {t.name: t.strategies[1].params for t in tasks}
    log(f"  chosen configs: {won}")
    interval = 2.0
    plan = milp.resolve(tasks, topo, None, interval)
    for n, a in plan.assignments.items():
        log(f"  plan: {n} on block [{a.block.offset}:{a.block.end}] start {a.start:.3f}s "
            f"runtime {a.runtime:.3f}s (makespan {plan.makespan:.3f}s)")
    t0 = time.perf_counter()
    out = sat.orchestrate(tasks, interval=interval, topology=topo)
    t_orch = time.perf_counter() - t0
    launches = counts(flash, ce)
    log(f"  orchestrate: completed {out['completed']} in {t_orch:.1f}s; "
        f"kernel launches over search + orchestrate {launches}")
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
    trials = [{"task": n, "config": c, "s_per_batch": s} for n, _, c, s, _ in tech.trials]
    return launches, {"tasks": results, "trials": trials, "search_s": t_search,
                      "orchestrate_s": t_orch}


# ------------------------------------------------------------------ phase 4
def untagged_loss(logits, tokens):
    """pretraining_loss without the fused-head tag: the step runs it over
    the logits."""
    from saturn_tpu_torch.models.loss import pretraining_loss

    return pretraining_loss(logits, tokens)


#: (label, attention, loss) of the pinned GPT-2-small runs.
PINNED = (("flash", "flash", None), ("dense", "dense", None),
          ("flash-logits", "flash", untagged_loss))


def pinned_task(sat, label, attention, loss_fn):
    task = lm_task(sat, f"pinned-{label}", 6e-4, STEPS_PINNED, os.path.join(CKPTS, label),
                   loss_fn=loss_fn)
    config = {"attention": attention, "remat": False}
    return task, config


def pinned_runs(sat, flash, ce, card):
    from saturn_tpu_torch.parallel.dp import DataParallel

    runs = {}
    for label, attention, loss_fn in PINNED:
        task, config = pinned_task(sat, label, attention, loss_fn)
        tech = DataParallel()
        task.strategies[1] = sat.Strategy(tech, 1, config, 0.0)
        task.select_strategy(1)
        reset_counts(flash, ce)
        tech.execute(task, [torch.device(DEVICE, 0)], 0, override_batch_count=STEPS_PINNED)
        runs[label] = (task, counts(flash, ce))
        log(f"  pinned {label}: {task.last_per_batch_s * 1e3:.2f} ms/step, "
            f"{BATCH * SEQ / task.last_per_batch_s:.0f} tokens/s, launches {runs[label][1]}, "
            f"losses {np.round(task.last_losses, 4).tolist()}  [{card}]")
    for label, attention, loss_fn in PINNED:
        # one launch of each flash kernel per layer per step, one of each CE
        # kernel per step on the fused path
        want = {n: (LAYERS * STEPS_PINNED if attention == "flash" else 0) for n in FLASH_NAMES}
        want.update({n: (0 if loss_fn else STEPS_PINNED) for n in CE_NAMES})
        if runs[label][1] != want:
            raise AssertionError(f"{label} run launched {runs[label][1]}, want {want}")
    ref = np.asarray(runs["flash"][0].last_losses)
    for label in ("dense", "flash-logits"):
        other = np.asarray(runs[label][0].last_losses)
        if not np.allclose(other, ref, rtol=BF16_BAND, atol=BF16_BAND):
            raise AssertionError(f"{label} losses {other} vs flash {ref} outside the bf16 band")
        log(f"  flash vs {label} loss trajectories: max |diff| "
            f"{np.abs(other - ref).max():.4e} (band 2e-2)")
    return {x: {"ms_per_step": runs[x][0].last_per_batch_s * 1e3,
                "tokens_per_s": BATCH * SEQ / runs[x][0].last_per_batch_s,
                "losses": runs[x][0].last_losses, "launches": runs[x][1]}
            for x in runs}


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
        prof, events = profiled(lambda: bundle.step(state, batch), n_prof)
        busy = busy_ms(events) / n_prof
        kernels = step_kernels(events, n_prof)
        want = {n: (LAYERS if attention == "flash" else 0) for n in FLASH_NAMES}
        want.update({n: (0 if loss_fn else 1) for n in CE_NAMES})
        seen = {n: k["launches_per_step"] for n, k in kernels.items()}
        if seen != want:
            raise AssertionError(f"{label}: the profiler saw {seen} launches per step, "
                                 f"want {want}")
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
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
        check_sass(cuda_build, src)
    if "--flash-sweep" in argv:
        log("flash sweep")
        rows = flash_sweep(flash)
        with open(os.path.join(OUT, "flash_sweep.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "rows": rows}, f, indent=1)
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
    check_ce(ce, 4000, D, 50257, True, 5, 64, timed=False)
    check_ce(ce, 4000, D, 50257, False, 8, 64, timed=False)
    # the other widths of the stash-mode dx and dW kernels: D tiles of 256 and of 64
    check_ce(ce, N, 1024, VOCAB, True, 6, 0, timed=False)
    check_ce(ce, 4000, 64, 50257, True, 7, 64, timed=False)
    torch.cuda.empty_cache()

    log("phase 3: search -> orchestrate, two GPT-2-small tasks and one BERT-base task b8x512")
    launches, main_results = main_path(sat, flash, ce, card)

    log("phase 4: the kernels on the training path (dp execute, pinned)")
    pinned = pinned_runs(sat, flash, ce, card)

    log("phase 5: where a step's time goes (pinned configs)")
    step_profile = profile_steps(sat, card)
    shutil.rmtree(CKPTS, ignore_errors=True)

    kernels = [
        {"name": n, "route": "cuda",
         "source": "saturn_tpu_torch/csrc/" + ("flash_attn.cu" if n in FLASH_NAMES
                                              else "linear_ce.cu"),
         "replaces": SOURCES[n], "launches": launches[n],
         "max_abs_err": rows[n]["max_abs_err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"], "bound_ms": rows[n]["bound_ms"],
         "bound_by": rows[n]["bound_by"], "library_ms": rows[n]["library_ms"]}
        for n in KERNEL_NAMES
    ]
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "kernels": kernels, "kernel_rows": rows,
                   "ce_recompute_rows": recompute, "main_path": main_results,
                   "pinned": pinned, "step_profile": step_profile,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
