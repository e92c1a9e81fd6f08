"""Micro-benchmarks and A/B sweeps of the port (counterparts of the JAX
package's ``benchmarks/`` scripts).  Each module has a ``run(...)`` that
returns its results as a dict and a ``main(argv)`` that prints them as JSON
lines; they run on the card unless ``device="cpu"`` is passed, and time with
CUDA events there (on the CPU with the host clock, for the tests)."""

from __future__ import annotations

import time

import torch

WARMUP = 3  # untimed calls before every timed window


def timed_ms(fn, iters: int, device: torch.device, warmup: int = WARMUP) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after ``warmup``
    untimed ones: between CUDA events on the card, on the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def device_label(device: torch.device) -> str:
    """Where a result was taken: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())
