"""Step timing and device memory, measured on the device.

Counterpart of ``saturn_tpu/utils/timing.py``: warm up, then time n
steady-state steps (or K-step windows) between ``torch.cuda.synchronize``
calls (PyTorch returns before the card finishes, so an unsynchronised host
clock would time the enqueue). The JAX package's compile-time memory
analysis has no counterpart in eager PyTorch: a configuration's memory is
the trial's measured peak against the device's total memory. The peak is
what the caching allocator reserved (``max_memory_reserved`` after
``reset_peak_memory_stats``), which holds a CUDA graph's private memory
pool as well as the eager steps' blocks.
"""

from __future__ import annotations

import timeit
from typing import Callable

import torch


def synchronize(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_train_step(
    step: Callable, state, batch, n_timed: int = 3, n_warmup: int = 2
) -> float:
    """Mean seconds per step of ``step(state, batch) -> (state, loss)``,
    warm-up excluded."""
    for _ in range(n_warmup):
        state, loss = step(state, batch)
    synchronize(batch.device)
    t0 = timeit.default_timer()
    for _ in range(n_timed):
        state, loss = step(state, batch)
    synchronize(batch.device)
    return (timeit.default_timer() - t0) / n_timed


def time_fused_window(
    fused: Callable, state, stage: Callable[[int], object], k: int,
    n_timed: int = 2, n_warmup: int = 1,
) -> float:
    """Mean seconds per BATCH of a K-step window program
    ``fused(state, window) -> (state, losses)``.

    ``stage(j)`` returns the device-staged (K, ...) window stack of call
    ``j``; every stack is staged before the timed region, which holds only
    the windows (in ``execute`` a unit's staging overlaps the device's work
    on the previous unit). Synchronized on the device at both ends. ``n_warmup >= 1``:
    the warm-up call is where a window is captured."""
    if n_warmup < 1:
        raise ValueError("time_fused_window needs n_warmup >= 1")
    windows = [stage(j) for j in range(n_warmup + n_timed)]
    device = windows[0].device
    for j in range(n_warmup):
        state, _ = fused(state, windows[j])
    synchronize(device)
    t0 = timeit.default_timer()
    for j in range(n_warmup, n_warmup + n_timed):
        state, _ = fused(state, windows[j])
    synchronize(device)
    return (timeit.default_timer() - t0) / (n_timed * k)


def reset_peak_memory(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_bytes(device) -> int:
    """Peak bytes the caching allocator reserved since the last reset, CUDA
    graph pools included; 0 off the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_reserved(device))
    return 0


def device_memory_bytes(device) -> int:
    """Total device memory; 0 where the platform reports none (CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 0
