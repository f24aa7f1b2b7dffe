"""Where the time of one `spmv(kind, A, x)` call goes on the card.

Run on a machine with an NVIDIA GPU, from the root of the repository:

    python -m spmv_tpu_torch.utils.profile_stream [--matrix NAME ...]
        [--ring plus_times|min_plus|max_times|or_and] [--kind stream] [--cg]
        [--spmm B] [--dist N [--dist-impl csr|stream]]

Matrices: `bench` (power_law_csr(1<<20, 1<<20, 3.3M, seed 42)),
`wide_row` (the same at 16.8M nnz), `sssp` (the shortest-paths graph,
random_graph(1<<20, 4, seed 0), 4.2M edges), `random`
(random_csr(1<<20, 1<<20, 4.2M, seed 42)), `poisson` (poisson2d(1024)
of the Poisson example, 5.2M nnz) and `arxiv` (power_law_csr(169343,
169343, 1166243, seed 0), the size of ogbn-arxiv); bench and wide_row by
default (arxiv with --spmm). For
each it prints the call's time between CUDA events, the host's time to
enqueue one call, and a torch.profiler table of device time per call by
kernel, whose sum is the device's busy time (its idle share is
1 - busy / call time).

With --cg it profiles conjugate-gradient iterations instead (`cg` with
rtol 0, so it runs exactly two chunks of `solvers.CHUNK` iterations,
replayed as a CUDA graph; matvecs by --kind): host time per iteration,
which includes the host's one read of the stopping test a chunk, and
device time per iteration by kernel.

With --spmm B it profiles `spmm(A, X)` calls by the window method (K13
and its glue) instead, X a dense (n_cols, B) block on the card.

With --dist N it profiles the multi-device layer instead: `matvec`
calls of `distribute_csr` (--dist-impl csr, K11' twice per call, halo
mode) or `distribute_stream` (--dist-impl stream) over a local mesh of N
shards on the one card, the shards run one after another; under
`torchrun --nproc_per_node N` over a process group of N ranks, one
shard and one card each (NCCL), reported by rank 0.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import spmv_tpu_torch as st
from spmv_tpu_torch.examples.shortest_paths import random_graph
from spmv_tpu_torch.examples.solve_poisson import poisson2d
from spmv_tpu_torch.io.generate import power_law_csr, random_csr
from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
from spmv_tpu_torch.utils.timing import cuda_time_ms

MATRICES = {
    "bench": lambda: power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42),
    "wide_row": lambda: power_law_csr(1 << 20, 1 << 20, 16_777_216, alpha=1.5,
                                      seed=42),
    "sssp": lambda: random_graph(1 << 20, 4, seed=0),
    "random": lambda: random_csr(1 << 20, 1 << 20, 4_194_304, seed=42),
    "poisson": lambda: poisson2d(1024),
    "arxiv": lambda: power_law_csr(169_343, 169_343, 1_166_243, alpha=1.5, seed=0),
}
CALLS = 20


def profile_matrix(label: str, kind: str, ring: str, card: str,
                   spmm_B: int = 0, dist_n: int = 0, dist_impl: str = "csr") -> None:
    """Profile `spmv(kind, A, x)` calls, or with spmm_B > 0
    `spmm(A, X, method="window")` calls, or with dist_n > 0 the
    distributed SpMV's `matvec` over a local mesh of dist_n shards."""
    A = MATRICES[label]()
    sr = BUILTIN_SEMIRINGS[ring]
    shape = (A.n_cols, spmm_B) if spmm_B else (A.n_cols,)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).cuda()
    if dist_n:
        from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh

        build = distribute_csr if dist_impl == "csr" else distribute_stream
        mesh = (make_mesh("shards", n_shards=dist_n) if dist.is_initialized() else
                make_mesh("shards", n_shards=dist_n, device=x.device, distributed=False))
        D = build(A, mesh)
        xs = D.shard_x(x)

    def call():
        if spmm_B:
            return st.spmm(A, x, semiring=sr, method="window")
        if dist_n:
            return D.matvec(xs, semiring=sr)
        return st.spmv(kind, A, x, semiring=sr)

    call()  # plan build + upload
    call_ms = cuda_time_ms(call, iters=30)["median_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    enqueue_ms = (time.perf_counter() - t0) / CALLS * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
    if dist.is_initialized() and dist.get_rank():
        return  # rank 0 reports
    what = (f"spmm window, B {spmm_B}" if spmm_B else
            f"distribute_{dist_impl}, {dist_n} shards, rank 0 of a process group"
            if dist.is_initialized() else
            f"distribute_{dist_impl}, {dist_n} local shards" if dist_n else kind)
    report(f"{label}, {what}, {ring}: nnz {A.nnz}; call {call_ms:.4f} ms (CUDA "
           f"events, median of 30); host enqueue {enqueue_ms:.4f} ms/call", prof,
           call_ms, "call", card)


def kernel_times(prof, units: int = CALLS) -> tuple:
    """(rows, nccl): the device time per unit by kernel (`units` of them in
    `prof`), each (µs, name, launches per unit), NCCL's kernels apart:
    they run on their own stream, concurrently with the rest, and spin
    until every rank has arrived, so they are no part of busy."""
    rows, nccl = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0) / units
        # device kernels and copies only (their aten:: callers and the
        # process group's nccl:/record_param_comms annotations repeat them)
        if us > 0 and not e.key.startswith(("aten::", "cuda", "nccl:",
                                            "record_param_comms")):
            (nccl if e.key.startswith("ncclDevKernel") else rows).append(
                (us, e.key, e.count // units))
    rows.sort(reverse=True)
    return rows, nccl


def report(head: str, prof, span_ms: float, unit: str, card: str,
           units: int = CALLS) -> None:
    """Print the device time per `unit` by kernel (`kernel_times`), its sum
    (busy), NCCL's kernels apart, and the idle share of `span_ms`."""
    rows, nccl = kernel_times(prof, units)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"== {head}; device busy {busy_ms:.4f} ms/{unit} (profiler), idle share "
          f"{1 - busy_ms / span_ms:.4f}; {card}")
    for us, key, count in rows:
        print(f"   {us:10.2f} us/{unit}  x{count:<3d} {key[:100]}")
    for us, key, count in nccl:
        print(f"   {us:10.2f} us/{unit}  x{count:<3d} {key[:60]} (NCCL stream, "
              f"includes waiting for the other ranks; not in busy)")
    if busy_ms > span_ms:
        raise SystemExit(f"profile_stream: device busy {busy_ms:.4f} ms exceeds "
                         f"the {unit}'s {span_ms:.4f} ms; one of the two is wrong")


def profile_cg(label: str, kind: str, card: str) -> None:
    """Two chunks of conjugate-gradient iterations (rtol 0: none stops
    early), so that no iteration of a chunk is past the stop."""
    from spmv_tpu_torch.solvers import CHUNK

    A = MATRICES[label]()
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.n_rows).astype(np.float32)).cuda()
    iters = 2 * CHUNK

    def run():
        _, info = st.cg(A, b, rtol=0.0, maxiter=iters, kind=kind)
        if info["iters"] != iters:
            raise SystemExit(f"profile_stream: cg ran {info['iters']} iterations")

    run()  # plan build + upload, the chunk's capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    report(f"{label}, cg by {kind}: nnz {A.nnz}; {iter_ms:.4f} ms per iteration (host "
           f"clock over {iters} iterations and the first residual's matvec)", prof,
           iter_ms, "iteration", card, units=iters)


def main() -> None:
    # keep CUPTI up between traces: torn down and set up again, later
    # traces lose device events once CUDA graphs exist (--cg captures
    # one); torch.profiler sets the same for its own graph backend
    os.environ["TEARDOWN_CUPTI"] = "0"
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", action="append", choices=sorted(MATRICES))
    ap.add_argument("--ring", default="plus_times", choices=sorted(BUILTIN_SEMIRINGS))
    ap.add_argument("--kind", default="stream")
    ap.add_argument("--cg", action="store_true",
                    help="profile CG iterations, matvecs by --kind")
    ap.add_argument("--spmm", type=int, default=0, metavar="B",
                    help="profile spmm (window) with a dense block of B columns")
    ap.add_argument("--dist", type=int, default=0, metavar="N",
                    help="profile the distributed SpMV over a local mesh of N shards")
    ap.add_argument("--dist-impl", default="csr", choices=("csr", "stream"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA device")
    if args.dist:
        from spmv_tpu_torch.parallel import init_distributed

        init_distributed()  # under torchrun: one shard per rank (NCCL)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    default = ("arxiv",) if args.spmm else ("bench", "wide_row")
    for label in args.matrix or default:
        if args.cg:
            profile_cg(label, args.kind, card)
        else:
            profile_matrix(label, args.kind, args.ring, card, spmm_B=args.spmm,
                           dist_n=args.dist, dist_impl=args.dist_impl)


if __name__ == "__main__":
    main()
