#!/usr/bin/env python3
"""Drive the PyTorch port (``saturn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure is an exception and a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, and the build of the CUDA kernels from
   ``saturn_tpu_torch/csrc/flash_attn.cu``.
2. Kernels against their plain PyTorch versions: flash forward, dQ and
   dK/dV at the GPT-2-small training shape (B 8, H 12, T 512, D 64, bf16,
   causal), a grouped-query shape (B 2, H 32, KV 4, T 1024, D 64) and a
   non-causal one; each kernel's device time, the plain version's and
   SDPA's (the library yardstick), all read from torch.profiler, and the
   kernel's bound on the card.
3. The port's main path at full width: two GPT-2-small tasks (b8 x 512,
   synthetic data, differing only in lr) through
   ``register_default_library`` -> ``search(["dp"])`` -> ``orchestrate``;
   every checkpoint must reach its ``batch_count`` with finite, falling
   losses. The kernel launch counts of this phase go into the kernels line.
4. The kernels on the training path: dp ``execute`` for 10 steps pinned to
   flash attention, from the same init and batches as a run pinned to
   dense; exactly 12 launches of each kernel per step, and the two loss
   trajectories agree within the bf16 band.
5. Where a step's time goes, for both pinned configs: synchronized per-step
   times and a torch.profiler window (device busy share, each flash
   kernel's launches and device time inside the step, top operators).

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")
CKPTS = os.path.join(REPO, "saturn_ckpts", "chip_smoke")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BF16_BAND = 2e-2           # the bf16 tolerance of tests/test_flash.py
STEPS_PINNED = 10
KERNEL_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
SOURCES = {
    "flash_fwd": "saturn_tpu/ops/flash.py:132",
    "flash_dq": "saturn_tpu/ops/flash.py:250",
    "flash_dkv": "saturn_tpu/ops/flash.py:276",
}
#: How each kernel's name begins in a profile (``csrc/flash_attn.cu``).
KERNEL_SYMBOLS = {
    "flash_fwd": "(anonymous namespace)::fwd_kernel<",
    "flash_dq": "(anonymous namespace)::dq_kernel<",
    "flash_dkv": "(anonymous namespace)::dkv_kernel<",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def busy_ms(events) -> float:
    """Milliseconds of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, a, b in events:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profiled(fn, n: int):
    """Run ``fn`` ``n`` times under torch.profiler, synchronized at the end;
    returns the device events. Raises if the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return prof, events


def device_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the union of its kernels',
    copies' and memsets' intervals over ``n`` profiled calls, divided by
    ``n``. Host work between launches (argument checks, allocation, the
    ctypes call, autograd's bookkeeping) is left out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return busy_ms(profiled(fn, n)[1]) / n


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
    ``timed``, also the times. Returns {name: row}."""
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
    rows = {}
    for name, pairs in (("flash_fwd", ((o, o_ref), (lse, lse_ref))),
                        ("flash_dq", ((dq, dq_ref),)),
                        ("flash_dkv", ((dk, dk_ref), (dv, dv_ref)))):
        err = 0.0
        for got, want in pairs:
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {shape} causal={causal}: non-finite output")
            torch.testing.assert_close(got.float(), want.float(), rtol=BF16_BAND,
                                       atol=BF16_BAND, msg=lambda m: f"{name} {shape}: {m}")
            err = max(err, (got.float() - want.float()).abs().max().item())
        rows[name] = {"max_abs_err": err}
    log(f"  kernels vs plain at (B,H,KV,T,D)={shape} causal={causal}: " + ", ".join(
        f"{n} max|err| {r['max_abs_err']:.3e}" for n, r in rows.items()) + " (band 2e-2)")
    if not timed:
        return rows

    q4, k4, v4 = (t.view(B, -1, T, D) for t in (q, k, v))
    sdpa_kw = {"is_causal": causal, **({"enable_gqa": True} if KV != H else {})}
    q4g = q4.detach().clone().requires_grad_(True)
    k4g = k4.detach().clone().requires_grad_(True)
    v4g = v4.detach().clone().requires_grad_(True)
    do4 = do.view(B, H, T, D)

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(q4g, k4g, v4g, **sdpa_kw)
        torch.autograd.grad(out, (q4g, k4g, v4g), do4)

    sdpa_fwd_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, **sdpa_kw))
    sdpa_fb_ms = device_ms(sdpa_fwd_bwd)
    timings = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, causal, H, KV),
                      lambda: flash.flash_fwd_reference(q, k, v, causal, H, KV), sdpa_fwd_ms),
        "flash_dq": (lambda: flash.flash_dq(q, k, v, do, lse, delta, causal, H, KV),
                     lambda: flash.flash_dq_reference(q, k, v, do, lse, delta, causal, H, KV),
                     sdpa_fb_ms),
        "flash_dkv": (lambda: flash.flash_dkv(q, k, v, do, lse, delta, causal, H, KV),
                      lambda: flash.flash_dkv_reference(q, k, v, do, lse, delta, causal, H, KV),
                      sdpa_fb_ms),
    }
    for name, (fn, plain, lib_ms) in timings.items():
        flops, nbytes = work(B, H, KV, T, D, causal)[name]
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name].update(
            ms=device_ms(fn), events_ms=events_ms(fn), plain_ms=device_ms(plain, n=5),
            library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
        r = rows[name]
        log(f"  {name}: device {r['ms']:.4f} ms (between CUDA events, host dispatch "
            f"included: {r['events_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; SDPA "
            f"{'fwd' if name == 'flash_fwd' else 'fwd+bwd'} {lib_ms:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rows


# ------------------------------------------------------------------ phase 3
def gpt2_task(sat, name, lr, batch_count, save_dir, **kwargs):
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.gpt2 import build_gpt2
    from saturn_tpu_torch.models.loss import pretraining_loss

    return sat.Task(
        get_model=lambda **kw: build_gpt2("gpt2-small", **kw),
        get_dataloader=lambda: make_lm_dataset(context_length=512, batch_size=8,
                                               vocab_size=50304, seed=0),
        loss_fn=pretraining_loss,
        hparams=sat.HParams(lr=lr, batch_count=batch_count, kwargs=kwargs),
        name=name,
        save_dir=save_dir,
    )


def initial_loss(task) -> float:
    """Loss of the seed-0 init on batch 0 (where every run starts)."""
    spec = task.get_model(attention="dense")
    model = spec.init_fn(torch.Generator().manual_seed(0), torch.device("cuda"))
    tokens = torch.from_numpy(task.batch_at(0)).to("cuda", torch.long)
    with torch.no_grad():
        loss = task.loss_fn(spec.apply_fn(model, tokens), tokens).item()
    del model
    torch.cuda.empty_cache()
    return loss


def main_path(sat, flash, card):
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.solver import milp
    from saturn_tpu_torch.utils import checkpoint as ckpt

    names = sat.library.register_default_library()
    tasks = [gpt2_task(sat, f"gpt2s-lr{i}", lr, 20, CKPTS)
             for i, lr in enumerate((6e-4, 1e-3))]
    loss0 = initial_loss(tasks[0])
    topo = SliceTopology()
    flash.reset_launch_counts()
    t0 = time.perf_counter()
    stats = sat.search(tasks, technique_names=["dp"])
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
    log(f"  chosen configs: {won}; flash won: "
        f"{ {n: p.get('attention') == 'flash' for n, p in won.items()} }")
    interval = 2.0
    plan = milp.resolve(tasks, topo, None, interval)
    for n, a in plan.assignments.items():
        log(f"  plan: {n} on block [{a.block.offset}:{a.block.end}] start {a.start:.3f}s "
            f"runtime {a.runtime:.3f}s (makespan {plan.makespan:.3f}s)")
    t0 = time.perf_counter()
    out = sat.orchestrate(tasks, interval=interval, topology=topo)
    t_orch = time.perf_counter() - t0
    launches = dict(flash.LAUNCHES)
    log(f"  orchestrate: completed {out['completed']} in {t_orch:.1f}s; "
        f"kernel launches over search + orchestrate {launches}")
    results = {}
    for t in tasks:
        saved = ckpt.load(t.ckpt_path)
        if saved["step"] != t.hparams.batch_count:
            raise AssertionError(f"{t.name}: checkpoint step {saved['step']} != "
                                 f"batch_count {t.hparams.batch_count}")
        losses = np.asarray(t.last_losses)
        if not np.isfinite(losses).all() or not losses[-1] < loss0:
            raise AssertionError(f"{t.name}: losses {losses} not finite or not below "
                                 f"the initial {loss0:.4f}")
        tok_s = 8 * 512 / t.last_per_batch_s
        log(f"  {t.name}: step {saved['step']}/{t.hparams.batch_count}, loss {loss0:.4f} -> "
            f"{losses[-1]:.4f}, last interval {t.last_per_batch_s * 1e3:.2f} ms/step, "
            f"{tok_s:.0f} tokens/s  [{card}]")
        results[t.name] = {"config": won[t.name], "final_loss": float(losses[-1]),
                           "ms_per_step": t.last_per_batch_s * 1e3, "tokens_per_s": tok_s}
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    trials = [{"task": n, "config": c, "s_per_batch": s} for n, _, c, s, _ in tech.trials]
    return launches, {"initial_loss": loss0, "tasks": results, "trials": trials,
                      "search_s": t_search, "orchestrate_s": t_orch}


# ------------------------------------------------------------------ phase 4
def pinned_runs(sat, flash, card):
    from saturn_tpu_torch.parallel.dp import DataParallel

    runs = {}
    for attention in ("flash", "dense"):
        task = gpt2_task(sat, f"pinned-{attention}", 6e-4, STEPS_PINNED,
                         os.path.join(CKPTS, attention))
        tech = DataParallel()
        task.strategies[1] = sat.Strategy(tech, 1, {"attention": attention, "remat": False}, 0.0)
        task.select_strategy(1)
        flash.reset_launch_counts()
        tech.execute(task, [torch.device("cuda", 0)], 0, override_batch_count=STEPS_PINNED)
        runs[attention] = (task, dict(flash.LAUNCHES))
        log(f"  pinned {attention}: {task.last_per_batch_s * 1e3:.2f} ms/step, "
            f"{8 * 512 / task.last_per_batch_s:.0f} tokens/s, launches {runs[attention][1]}, "
            f"losses {np.round(task.last_losses, 4).tolist()}  [{card}]")
    want = 12 * STEPS_PINNED  # 12 layers, one launch of each kernel per layer per step
    if runs["flash"][1] != {n: want for n in KERNEL_NAMES}:
        raise AssertionError(f"flash run launched {runs['flash'][1]}, want {want} of each")
    if any(runs["dense"][1].values()):
        raise AssertionError(f"dense run launched flash kernels {runs['dense'][1]}")
    a, b = (np.asarray(runs[x][0].last_losses) for x in ("flash", "dense"))
    if not np.allclose(a, b, rtol=BF16_BAND, atol=BF16_BAND):
        raise AssertionError(f"flash losses {a} vs dense {b} outside the bf16 band")
    log(f"  flash vs dense loss trajectories: max |diff| {np.abs(a - b).max():.4e} (band 2e-2)")
    return {x: {"ms_per_step": runs[x][0].last_per_batch_s * 1e3,
                "tokens_per_s": 8 * 512 / runs[x][0].last_per_batch_s,
                "losses": runs[x][0].last_losses, "launches": runs[x][1]}
            for x in runs}


# ------------------------------------------------------------------ phase 5
def profile_steps(sat, card, n_sync=8, n_prof=4):
    """Where a training step's time goes, for each pinned config: per-step
    times with a synchronize after every step, then ``n_prof`` steps under
    torch.profiler. From the profile: the device's busy time per step and
    its idle share of the median synchronized step, each flash kernel's
    launches and device time per step (phase 2's kernel times, read inside
    the real step), and the top operators (``chiprun_out/profile_*.txt``)."""
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.utils import checkpoint as ckpt

    out = {}
    dev = torch.device("cuda", 0)
    for attention in ("flash", "dense"):
        config = {"attention": attention, "remat": False}
        task = gpt2_task(sat, f"pinned-{attention}", 6e-4, STEPS_PINNED,
                         os.path.join(CKPTS, attention))
        bundle = DataParallel().build(task, [dev], config)
        state = ckpt.restore(task.ckpt_path, bundle.empty())
        batch = bundle.stage(task.batch_at(0))
        for _ in range(2):
            state, _ = bundle.step(state, batch)
        torch.cuda.synchronize()
        synced = []
        for _ in range(n_sync):
            t0 = time.perf_counter()
            state, _ = bundle.step(state, batch)
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t0) * 1e3)
        # the step updates ``state`` in place
        prof, events = profiled(lambda: bundle.step(state, batch), n_prof)
        busy = busy_ms(events) / n_prof
        kernels = {}
        for name, symbol in KERNEL_SYMBOLS.items():
            mine = [(a, b) for n, a, b in events if symbol in n]
            kernels[name] = {"launches_per_step": len(mine) / n_prof,
                             "device_ms_per_step": sum(b - a for a, b in mine) / 1e3 / n_prof}
        want = 12 if attention == "flash" else 0
        if any(k["launches_per_step"] != want for k in kernels.values()):
            raise AssertionError(f"{attention}: the profiler saw {kernels}, want {want} "
                                 "launches of each flash kernel per step")
        try:
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
        except (KeyError, AttributeError, ValueError):
            table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
        with open(os.path.join(OUT, f"profile_{attention}.txt"), "w") as f:
            f.write(table)
        step_ms = float(np.median(synced))
        flash_ms = sum(k["device_ms_per_step"] for k in kernels.values())
        readbacks = sum("DtoH" in n for n, _, _ in events) / n_prof
        out[attention] = {"synced_ms": synced, "device_busy_ms": busy,
                          "idle_share": 1 - busy / step_ms, "kernels": kernels,
                          "readbacks_per_step": readbacks}
        log(f"  {attention}: synced steps {np.round(synced, 2).tolist()} ms (median "
            f"{step_ms:.2f}); {readbacks:g} device-to-host copies per step; "
            f"device busy {busy:.2f} ms/step, idle share "
            f"{1 - busy / step_ms:.3f} of the median synced step; flash kernels "
            f"{flash_ms:.3f} ms/step on the device "
            + ", ".join(f"{n} {k['device_ms_per_step'] / max(want, 1):.4f} ms/launch"
                        for n, k in kernels.items()) + f"  [{card}]")
        del state, bundle
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import saturn_tpu_torch as sat
    from saturn_tpu_torch.ops import flash
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
    cuda_build.load("flash_attn")
    log(f"  built and loaded the CUDA kernels in {time.perf_counter() - t0:.1f}s")
    report = cuda_build.build_log("flash_attn")
    with open(os.path.join(OUT, "ptxas_flash_attn.log"), "w") as f:
        f.write(report)
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas flash_attn: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    main_shape = (8, 12, 12, 512, 64)
    rows = check_kernels(flash, main_shape, True, 0, timed=True)
    check_kernels(flash, (2, 32, 4, 1024, 64), True, 1, timed=False)
    check_kernels(flash, main_shape, False, 2, timed=False)

    log("phase 3: search -> orchestrate, two GPT-2-small tasks b8x512")
    launches, main_results = main_path(sat, flash, card)

    log("phase 4: the kernels on the training path (dp execute, pinned)")
    pinned = pinned_runs(sat, flash, card)

    log("phase 5: where a step's time goes (pinned configs)")
    step_profile = profile_steps(sat, card)
    shutil.rmtree(CKPTS, ignore_errors=True)

    kernels = [
        {"name": n, "route": "cuda", "source": "saturn_tpu_torch/csrc/flash_attn.cu",
         "replaces": SOURCES[n], "launches": launches[n],
         "max_abs_err": rows[n]["max_abs_err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"], "bound_ms": rows[n]["bound_ms"],
         "bound_by": rows[n]["bound_by"], "library_ms": rows[n]["library_ms"]}
        for n in KERNEL_NAMES
    ]
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "kernels": kernels, "kernel_rows": rows,
                   "main_path": main_results, "pinned": pinned,
                   "step_profile": step_profile,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
