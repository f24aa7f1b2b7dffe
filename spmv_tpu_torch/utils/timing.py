"""Timing on the card: CUDA events, CUDA graphs and synchronisation.

Counterpart of `spmv_tpu/utils/timing.py`. Launches return before the
card finishes, so a time is taken between CUDA events recorded on the
current stream, after warm-up runs. `cuda_time_ms` refuses to run
without a card: a time taken on the CPU is not a device time.

Back-to-back eager calls do not time the device work: each call's host
side (the dispatch, a wrapper's checks and its ctypes launch, 30-40 us a
kernel) is longer than many calls' device work, so the card waits on the
host between them, and such a time is the host's enqueue rate. So
`benchmark_fn` times a CUDA tensor as the reference does: `_device_loop`
chains the calls with a data dependency, here captured as one CUDA graph
that replays them with no host in between, and the time per call is the
slope between a short chain and a long one. A host kind
(ops/registry.py:HOST_KINDS), which a graph cannot capture, and a CPU
tensor are timed by back-to-back calls (CUDA events, or the host clock
on the CPU), and `timing_of` says which a result used.
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


def capture_graph(body: Callable[[], object], what: str, device) -> "torch.cuda.CUDAGraph":
    """body() captured as one CUDA graph on `device` and instantiated; the
    graph's nodes are kept, so that `graph_kernels` can read what a replay
    launches. The caller runs body (or the calls in it) eagerly once
    before, so that plans, casts and libraries are made outside the
    capture. A capture that fails raises RuntimeError naming `what`."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.device(device), torch.cuda.graph(g):
            body()
    except Exception as e:
        raise RuntimeError(f"{what}: CUDA graph capture failed: "
                           f"{type(e).__name__}: {e}") from e
    g.instantiate()
    return g


def graph_kernels(graph: "torch.cuda.CUDAGraph", stems=()) -> dict:
    """{kernel name: launches} of one replay of `graph` (made by
    `capture_graph`), read from its kernel nodes through libcuda
    (cuGraphGetNodes, cuGraphKernelNodeGetParams, and cuKernelGetName or
    cuFuncGetName); the names are the compiler's mangled ones. With
    `stems`, {stem: launches} of the kernels whose names hold each stem
    instead, stems with none left out. A replay launches its nodes
    without the wrappers, whose host counters see only the capture; this
    is what the device runs."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"graph_kernels: {fn} returned CUresult {rc}")

    g = ptr(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ptr * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ptr(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at word 0, kern at word 7
        params = (ctypes.c_uint64 * 16)()
        call("cuGraphKernelNodeGetParams_v2", ptr(node), params)
        name = ctypes.c_char_p()
        if params[7]:
            call("cuKernelGetName", ctypes.byref(name), ptr(params[7]))
        else:
            call("cuFuncGetName", ctypes.byref(name), ptr(params[0]))
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    if stems:
        out = {s: sum(n for k, n in out.items() if s in k) for s in stems}
        out = {s: n for s, n in out.items() if n}
    return out


def _device_loop(fn: Callable, x0: torch.Tensor, iters: int):
    """`iters` chained fn calls -> run(), which makes them and returns
    the chain's checksum, a 0-d float32 tensor.

    The reference's chain (spmv_tpu/utils/timing.py:67-90): each call's
    y feeds a checksum of y[0] as float32, counted as 1 where it is not
    finite (a ring's identity may be +-inf), and through a runtime-false
    taint the next x: where the checksum is NaN, y[0] is added to x[0],
    so no call can start before the one before it ends, and x stays as it
    is, bit for bit. On a CUDA tensor the chain is captured as one CUDA
    graph on a copy of x0 (fn must have run once on x0 before), which
    run() replays; the graph and its memory go with run. On a CPU tensor
    run() makes the calls eagerly."""
    x = x0.clone()
    acc = torch.zeros((), dtype=torch.float32, device=x0.device)

    def chain():
        acc.zero_()
        for _ in range(iters):
            y = fn(x)
            y = y[0] if isinstance(y, (tuple, list)) else y
            v = y.reshape(-1)[0].float()
            v = torch.where(torch.isfinite(v), v, torch.ones_like(v))
            acc.add_(v)
            x[:1] = torch.where(torch.isnan(acc), x[:1] + v.to(x.dtype), x[:1])
        return acc + x.reshape(-1)[0].float()

    if x0.device.type != "cuda":
        return chain
    out = []
    g = capture_graph(lambda: out.append(chain()), f"a chain of {iters} calls", x0.device)

    def run():
        g.replay()
        return out[0]

    return run


def _back_to_back_s(fn: Callable, x0: torch.Tensor, iters: int) -> float:
    """Seconds per call of `iters` calls back to back, the median of
    `_REPEATS` windows: CUDA events on a CUDA tensor (`cuda_time_ms`'s
    batch mode), the host clock on a CPU one."""
    if x0.device.type == "cuda":
        return cuda_time_ms(lambda: fn(x0), iters=_REPEATS, warmup=0,
                            batch=iters)["median_ms"] / 1e3
    times = []
    for _ in range(_REPEATS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x0)
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)


def _chain_s(fn: Callable, x0: torch.Tensor, iters: int) -> float:
    """Device seconds per call by the reference's rules
    (spmv_tpu/utils/timing.py:122-159): chains of lo = max(1, iters // 4)
    and `iters` calls (`_device_loop`), each replayed once to warm up and
    then twice between a CUDA event pair, the faster kept; while the two
    times differ by no more than 5% of the long one, the long chain grows
    4x (at most 4 times). Each chain's graph is freed once it is timed."""

    def best(n: int) -> float:
        run = _device_loop(fn, x0, n)
        run()
        times = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s = run()
            end.record()
            end.synchronize()
            if not torch.isfinite(s):
                raise RuntimeError("benchmark checksum is not finite")
            times.append(start.elapsed_time(end) / 1e3)
        return min(times)

    lo = max(1, iters // 4)
    t_lo, t_hi = best(lo), best(iters)
    tries = 0
    while t_hi - t_lo <= 0.05 * t_hi and tries < 4:
        lo, t_lo = iters, t_hi
        iters *= 4
        t_hi = best(iters)
        tries += 1
    return (t_hi - t_lo) / (iters - lo)


def benchmark_fn(fn: Callable, x0: torch.Tensor, iters: int = 50,
                 warmup: bool = True, *, chained: Optional[bool] = None):
    """Time `fn(x0)`. Returns (total_s, kernel_s).

    `total_s` is one call, host-observed, closed by
    `torch.cuda.synchronize()` on the card. `kernel_s`, where `chained`
    (by default: on a CUDA tensor), is device time per call, the slope
    between two chained runs captured as CUDA graphs (`_chain_s`), so fn
    must be capturable (a device kind); else it is back-to-back calls
    (`_back_to_back_s`: CUDA events on the card, the host clock on the
    CPU, where no time is device time)."""
    if chained is None:
        chained = x0.device.type == "cuda"
    sync = torch.cuda.synchronize if x0.device.type == "cuda" else (lambda: None)
    if warmup:
        fn(x0)
        sync()
    t0 = time.perf_counter()
    fn(x0)
    sync()
    total_s = time.perf_counter() - t0
    return total_s, (_chain_s if chained else _back_to_back_s)(fn, x0, iters)


def graph_timed(kind: str, device) -> bool:
    """True iff `benchmark_spmv` times `kind` on `device` by graph chain:
    a device kind on the card."""
    from spmv_tpu_torch.ops.registry import is_host_kind

    return torch.device(device).type == "cuda" and not is_host_kind(kind)


def timing_of(kind: str, device) -> str:
    """The label of how `benchmark_spmv` times `kind` on `device`: "graph
    chain" (device time per call, CUDA graphs), "calls, CUDA events" (a
    host kind on the card, back to back) or "calls, host clock" (the
    CPU)."""
    if graph_timed(kind, device):
        return "graph chain"
    return "calls, CUDA events" if torch.device(device).type == "cuda" else "calls, host clock"


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
    times of `benchmark_fn`, by graph chain where `graph_timed`, else by
    back-to-back calls (`timing_of` names which), and the roofline
    columns."""
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

    total_s, kernel_s = benchmark_fn(fn, x, iters, chained=graph_timed(kind, x.device))
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
