"""Timing on the card: CUDA events and synchronisation.

Counterpart of `spmv_tpu/utils/timing.py`, rebuilt for PyTorch's eager
CUDA model: launches return before the card finishes, so a kernel's
time is taken between CUDA events recorded on the current stream
around each run, after warm-up runs. `cuda_time_ms` refuses to run
without a card: a time taken on the CPU is not a device time.
`benchmark_fn` and `benchmark_spmv` (the bench harness's) also run on a
CPU tensor, timed by the host clock, and say so.

The reference chains its timed iterations inside one jitted
`fori_loop` with a data dependency, and takes the slope between a
short and a long chain, because XLA may hoist or fuse a repeated call
and its remote runtime adds a large fixed cost per dispatch. Eager CUDA
launches do neither: each call enqueues its kernels in order on one
stream, so back-to-back calls between two CUDA events time the device
work directly, with no chain and no slope.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

# PERF.md's correctness gate: plus-times within rtol 2e-4, atol 1e-5 of
# the float64 oracle, every value finite
GATE_RTOL, GATE_ATOL = 2e-4, 1e-5
_REPEATS = 5  # event pairs (or host-clock windows) behind each median


@dataclasses.dataclass
class BenchResult:
    kind: str
    total_s: float  # single full call (host-observed)
    kernel_s: float  # per-iteration device time (host time on a CPU)
    iters: int
    nnz: int
    n_rows: int
    gnnz_per_s: float
    gflops: float
    gbytes_per_s: float
    sol_fraction: Optional[float] = None
    delta: Optional[dict] = None

    def row(self) -> str:
        sol = f"{100*self.sol_fraction:6.1f}%" if self.sol_fraction is not None else "   n/a"
        d = f" Δmean={self.delta['mean_abs']:.3e}" if self.delta else ""
        return (
            f"{self.kind:18s} kernel {self.kernel_s*1e3:9.4f} ms  "
            f"total {self.total_s*1e3:9.3f} ms  "
            f"{self.gnnz_per_s:8.2f} Gnnz/s  {self.gflops:8.2f} GFLOP/s  "
            f"SoL {sol}{d}"
        )


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


def benchmark_fn(fn: Callable, x0: torch.Tensor, iters: int = 50,
                 warmup: bool = True):
    """Time `fn(x0)`. Returns (total_s, kernel_s).

    On a CUDA tensor: `total_s` is one call, host-observed, closed by
    `torch.cuda.synchronize()`; `kernel_s` is the median over
    `_REPEATS` event pairs, each around `iters` calls back to back,
    divided by `iters` (`cuda_time_ms`'s batch mode): the card runs the
    calls one after another, so where the host enqueues faster than the
    card works this is device time, and where it does not, the host's
    cost per call. On a CPU tensor both are the host clock (the median
    of `_REPEATS` windows of `iters` calls): no device time."""
    cuda = x0.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if warmup:
        fn(x0)
        sync()
    t0 = time.perf_counter()
    fn(x0)
    sync()
    total_s = time.perf_counter() - t0
    if cuda:
        ms = cuda_time_ms(lambda: fn(x0), iters=_REPEATS, warmup=0,
                          batch=iters)["median_ms"]
        return total_s, ms / 1e3
    times = []
    for _ in range(_REPEATS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x0)
        times.append((time.perf_counter() - t0) / iters)
    return total_s, statistics.median(times)


def benchmark_spmv(
    kind: str,
    A,
    x: torch.Tensor,
    iters: int = 50,
    semiring=None,
    check: bool = True,
) -> BenchResult:
    """One kind on (A, x), on x's device: the float64 oracle's delta
    (plus-times only), with `within_gate` added (PERF.md's gate), the
    times of `benchmark_fn` and the roofline columns."""
    from spmv_tpu_torch.ops.reference import correctness_delta, spmv_ref
    from spmv_tpu_torch.ops.registry import spmv
    from spmv_tpu_torch.utils.roofline import speed_of_light

    def fn(xv):
        return spmv(kind, A, xv, semiring=semiring)

    delta = None
    if check and semiring is None:
        y = fn(x).cpu().numpy()
        y_ref = spmv_ref(A, x.cpu().numpy(), y_dtype=np.float64)
        delta = correctness_delta(y_ref, y)
        delta["within_gate"] = bool(np.isfinite(y).all() and np.allclose(
            y, y_ref, rtol=GATE_RTOL, atol=GATE_ATOL))

    total_s, kernel_s = benchmark_fn(fn, x, iters=iters)
    nnz, n_rows = A.nnz, A.n_rows
    gnnz = nnz / kernel_s / 1e9
    model = speed_of_light(nnz, n_rows, device=x.device)
    sol = model.sol_nnz_per_s(A.mean_nnz_per_row)
    bytes_moved = nnz * model.bytes_per_nnz + n_rows * model.bytes_per_row
    return BenchResult(
        kind=kind,
        total_s=total_s,
        kernel_s=kernel_s,
        iters=iters,
        nnz=nnz,
        n_rows=n_rows,
        gnnz_per_s=gnnz,
        gflops=2 * nnz / kernel_s / 1e9,
        gbytes_per_s=bytes_moved / kernel_s / 1e9,
        sol_fraction=gnnz * 1e9 / sol,
        delta=delta,
    )
