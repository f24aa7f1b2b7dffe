"""Timing on the card: CUDA events and synchronisation.

Counterpart of `spmv_tpu/utils/timing.py`, rebuilt for PyTorch's eager
CUDA model: launches return before the card finishes, so a kernel's
time is taken between CUDA events recorded on the current stream
around each run, after warm-up runs. It refuses to run without a
card: a time taken on the CPU is not a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional

import torch


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs CUDA; none is available")


def cuda_time_ms(fn: Callable[[], object], iters: int = 20,
                 warmup: int = 3, batch: int = 1,
                 flush: Optional[torch.Tensor] = None,
                 before: Optional[Callable[[], object]] = None) -> dict:
    """Run `fn` `warmup` times, then `iters` times `batch` runs back to
    back between a pair of CUDA events, each time divided by `batch`.
    With batch 1 a time includes what the host spends on one run;
    batched, the device runs one after another and the host's cost
    hides behind them where it is the smaller.

    `flush`, a card tensor larger than the 50 MB L2, is written and then
    read before each event pair, outside it, so that the runs find a
    cold L2 that holds no dirty lines (a write alone would leave the L2
    full of them, and their write-back would share the run's memory
    rate). The flush keeps the card busy while the host enqueues the
    run, so a short run's time is then its device time. `before`, where
    given, runs after the flush and before each event pair, outside it
    (to bring some of the run's inputs back into L2, say).
    Returns {"median_ms", "min_ms", "max_ms", "iters"}."""
    _need_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        if flush is not None:
            flush.fill_(i)
            flush.sum()
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "iters": iters}
