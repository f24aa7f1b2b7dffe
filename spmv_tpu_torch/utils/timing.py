"""Timing on the card: CUDA events and synchronisation.

Counterpart of `spmv_tpu/utils/timing.py`, rebuilt for PyTorch's eager
CUDA model: launches return before the card finishes, so a kernel's
time is taken between CUDA events recorded on the current stream
around each run, after warm-up runs. It refuses to run without a
card: a time taken on the CPU is not a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs CUDA; none is available")


def cuda_time_ms(fn: Callable[[], object], iters: int = 20,
                 warmup: int = 3) -> dict:
    """Run `fn` `warmup` times, then `iters` times between CUDA events.
    Returns {"median_ms", "min_ms", "max_ms", "iters"}."""
    _need_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "iters": iters}
