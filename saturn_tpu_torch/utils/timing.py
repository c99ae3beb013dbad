"""Step timing and device memory, measured on the device.

Counterpart of ``saturn_tpu/utils/timing.py``: warm up, then time n
steady-state steps between ``torch.cuda.synchronize`` calls (PyTorch returns
before the card finishes, so an unsynchronised host clock would time the
enqueue). The JAX package's compile-time memory analysis has no counterpart
in eager PyTorch: a configuration's memory is the trial's measured peak,
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
against the device's total memory.
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


def reset_peak_memory(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_bytes(device) -> int:
    """Peak allocated bytes since the last reset; 0 off the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_memory_bytes(device) -> int:
    """Total device memory; 0 where the platform reports none (CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 0
