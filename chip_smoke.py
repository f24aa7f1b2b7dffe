#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (spmv_tpu_torch) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It drives the port's paths with x on the card and checks them:

- the plus-times stream path on the bench matrix (power_law_csr(1<<20,
  1<<20, 3.3M, alpha 1.5, seed 42), the size class of SuiteSparse's
  webbase-1M) and on the 16.8M-nnz wide-row matrix: K1 -> K2 -> K5 -> K6;
- single-source shortest paths by min-plus SpMV through `merge_genl`
  on a 1M-vertex, 4.2M-edge random graph of out-degree 4
  (spmv_tpu_torch.examples.shortest_paths.random_graph(1<<20, 4, seed 0),
  the size class of SuiteSparse's roadNet-PA), to its fixed point:
  K3 -> K5 -> K8 per relaxation;
- min-plus and max-times on the bench matrix (K1 -> K7 -> K5 -> K8),
  plus-times on the graph and on random_csr(1<<20, 1<<20, 4.2M, seed 42)
  (K3 -> K5 -> K6), or-and on both matrices;
- the direct ELL kinds (paged gather K9 -> group reduce K11 per bin) on
  bench, random 4.2M and random_csr(217918, 217918, 11524432, seed 3),
  the size class of SuiteSparse's pwtk; the csr-vector and Light kinds
  on bench (the stream pipeline); `dia` and the csr-vector kinds on the
  2-D Poisson matrix (K12);
- conjugate gradients on poisson2d(1024) through csr_vector -> dia ->
  K12, to rtol 1e-6;
- `merge_tiled` (K9 -> K10 -> K9) on bench and wide-row in four rings
  and through shortest paths on the graph, and the merge kinds'
  fallback to it past the stream planner's reach;
- `spmm` on a graph of ogbn-arxiv's size (power_law_csr(169343, 169343,
  1166243, alpha 1.5, seed 0)) at B = 128 (its feature width), 256 (the
  hidden width of OGB's GCN baseline) and 40 (its class count): the
  window method (K13 per 128-column block) and the gather method;
- the multi-device layer (spmv_tpu_torch.parallel) on local meshes of
  1, 2 and 4 shards on the one card, the shards run one after another:
  `distribute_csr` (K11' twice per call) on bench and the graph,
  `distribute_stream` (K2/K7 -> K5 -> K6/K8 per shard) on bench, a
  process-group mesh of one rank through NCCL, and the weak-scaling
  bench at its defaults;
- the bench harness (`python -m spmv_tpu_torch.bench.harness`) on a
  power-law matrix of bench's size and on a .mtx file read back by the
  native parser;
- the rest of the public surface on the stream kinds: `spgemm` (one
  APSP relaxation G (min.+) G on the graph, R (x) R on random 4.2M),
  `SparseOperator` and `spmv_values` on the arxiv-size graph, ILU(0)
  and its apply on poisson2d(1024), CG with M="ilu0", and the PageRank
  and BFS examples at 1M nodes and 4.2M edges;
- the device loops: every device kind captured in a CUDA graph, the
  harness's graph-chained timing, the triangular solve in one launch
  (K14), and CG and BiCGSTAB replaying a graph per chunk of iterations.

Phases:

1. the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
2. builds the fifteen CUDA kernels from csrc/ (one nvcc per source, in
   parallel, into the git-ignored spmv_tpu_torch/_build/) and prints
   ptxas's registers, shared memory and spills for every instantiation
   of the fifteen (each value type, ring and W; a spill fails the run);
3. each kernel against its plain PyTorch version on the card, on its
   plans' own arrays, each fed the kernel outputs of the stage before:
   K1, K5, K3, K4 bit for bit; K7 bit for bit in min-plus, max-times
   and or-and, K8 in the min and max rings; K2 and K6 bit for bit on
   integer-valued data and within rtol 2e-4 / atol 1e-5 on normal data;
   K3 == K4 + one K5 pass bit for bit;
   each kernel's median time over 30 launches, each alone between CUDA
   events (the wrapper's host cost included), the median over 10
   event pairs of 20 launches back to back, divided by 20, and its
   device time per launch (torch.profiler over 20); beside them its
   plain version's time, its bound (bytes read and written once at 3.35
   TB/s, or its operations at 67 TFLOP/s, the larger) and, where one
   PyTorch call computes its function, that call's time all three ways (K1's
   and K5's are torch.take by the kernel's route, or K5's passes,
   composed into one flat index, which must equal the kernel's output
   bit for bit); K5 timed on bench's two passes and on the graph plan's
   pass 2, K8 on the graph plan (min-plus) and bench's (max-times), K6
   also on the wide-row plan's final tiles (more than the SMs, phase 4)
   and K2 and K7 (min-plus) on shard 0 of bench's 4-shard
   distribute_stream (fewer gather tiles than SMs, phase 18); K4 (the
   graph, min-plus) and K7 (bench and the shard, min-plus) also timed
   alone with the L2 flushed before each launch (a 256 MB buffer written
   and read outside the timed window), the state a caller whose other
   work evicts the L2 leaves them in; K7's bound counts what it reads
   (K2's bytes and the run-start flags);
4. plus-times end to end on the bench and wide-row matrices against the
   float64 oracle (rtol 2e-4, atol 1e-5), with launch counts, ms per
   call, Gnnz/s, and cuSPARSE (`torch.sparse_csr_tensor @ x`) for
   comparison;
5. the shortest paths: every relaxation equal to the semiring oracle
   bit for bit, the final distances within 1e-4 of SciPy's Dijkstra in
   float64, launch counts, ms per relaxation and Gnnz/s;
6. the other rings and matrices against their oracles, with launch
   counts;
7. K12 against its plain version bit for bit in plus-times, min-plus
   and max-times on poisson2d(1024) and on a 7-point 3-D Laplacian on
   an 88x88x128 grid (offsets up to +-7744), each timed, poisson2d also
   with the L2 flushed before each launch (a 256 MB buffer written and
   read outside the timed window), as CG's vector updates leave it, x
   too; and on random plans
   of 30001 rows (not a multiple of 4: the scalar loads) with 1 and 64
   diagonals;
8. K9 and K11 against their plain versions bit for bit (K11's leaders
   against the plain version's leader lanes) on bench's csr_vector_ell
   plan (W 4, all three strategies), on each light_vec_ell bin of bench
   (tree) and on the pwtk-size plan at W 32 (tree, broadcast), K9 also
   on a plan of R_MAX = 4 rounds from a stream bucketed on purpose onto
   42 of the 128 sublanes, each timed beside `x[idx]` (K9) and
   `prod.view(-1, W).sum(1)` (K11);
9. every ELL kind and csr_scalar on bench, random 4.2M and the
   pwtk-size matrix, the csr-vector and Light stream kinds on bench,
   and `dia` and the csr-vector kinds on poisson2d(1024), each in
   plus-times (rtol 2e-4 / atol 1e-5 of the float64 oracle) and in
   min-plus, max-times and or-and (bit for bit against the semiring
   oracle), with one call's launches checked, ms per call and Gnnz/s,
   and cuSPARSE beside plus-times; then two plus-times calls of
   csr_vector_ell and of xla on bench must agree to within one float32
   ulp per row (the row fold sums in float64 and rounds once) and pass
   the oracle;
10. CG on poisson2d(1024), b from seed 0, its chunks of CHUNK iterations
    replayed as one CUDA graph: it must converge in 2200-2700 iterations
    with a true relative residual <= 1e-3 (float64, host), launching K12
    once per matvec and nothing else: 1 + CHUNK x the chunks run, counted
    on the solve checked as its one eager launch (the wrappers' counts,
    set to 0 just before it) plus the chunk graph's kernel nodes (CHUNK
    K12s, read from the graph: its replays bypass the wrappers) times the
    replays, the host reading the stopping test once per chunk and once
    before; then one more replay on the stopped state, timed, must leave
    x and k as they are (the cost of a masked iteration past the stop);
11. K10 against its plain version on bench's tuned plan (the route's
    spare-row branch) and its stock plan (the masked reduction), fed the
    same phase-A products: min-plus, max-times (non-negative data) and
    or-and bit for bit, plus-times bit for bit on integer-valued data
    and within rtol 2e-4 / atol 1e-5 on normal data (whether it was
    also bit for bit is printed); K9 on both plans' gathers, the x read
    of phase A and the y assembly of phase C, bit for bit;
12. `merge_tiled` on bench and wide-row in four rings against the
    oracles (plus-times within rtol 2e-4 / atol 1e-5 of float64, the
    others bit for bit), K9 twice and K10 once per call, ms per call,
    Gnnz/s and cuSPARSE beside plus-times;
13. shortest paths through `merge_tiled` on the graph to the fixed
    point, each relaxation equal to the semiring oracle, the distances
    within 1e-4 of SciPy's Dijkstra;
14. the fallback: the stream planner is made to refuse bench (the real
    reach, 16384 gather tiles or about 240M nnz, is not run: a matrix
    that large takes minutes to plan on the host); `merge`,
    `merge_stock` and `merge_genl` must warn with FallbackWarning, run
    K10 (the stock policy for `merge_stock`) and pass the oracle;
15. K13 against its plain version bit for bit on the arxiv-size graph at
    B = 128, plus-times and min-plus; `spmm` there at B = 128, 256 and
    40 by `window` (K13 once per 128-column block) and `xla`, plus-times
    within rtol 2e-4 / atol 1e-4 of SciPy in float64 and min-plus bit
    for bit against the semiring oracle, with torch.sparse.mm beside;
    K13 also timed with the L2 flushed before each launch (plus-times);
    `spmm(method="stream")` on random_csr(16384, 16384, 20000, seed 5)
    at B = 128, a size cut because the Kronecker expansion's plan grows
    128x with nnz;
16. K11' against its plain version bit for bit on the stacked self and
    halo blocks of bench over a 4-shard local mesh, in plus-times,
    min-plus, max-times (non-negative values) and or-and, each timed
    (median of 30) beside its plain version and its bound (the valid
    slots' aj and ax, the valid mask and each distinct x entry read
    once, the leaders written; beside it what the kernel reads: aj and ax
    of every slot, padding included), and in plus-times also with the
    L2 flushed before each launch, as a matvec meets it, and, to show
    where that time goes, flushed with no slot valid (the plan stream
    alone) and flushed with x read back into L2 first;
17. `distribute_csr` on local meshes of 1, 2 and 4 shards, modes `halo`
    and `allgather`, on bench (its hub rows split across shards, so the
    boundary fixup runs) and the graph: plus-times within rtol 2e-4 /
    atol 1e-5 of the float64 oracle, min-plus, max-times and or-and bit
    for bit against the semiring oracle, K11' launched exactly twice per
    call and nothing else; ms per call, Gnnz/s and the exchange's bytes
    per shard against an all-gather's;
18. `distribute_stream` on local meshes of 2 and 4 shards on bench in
    plus-times (K2 -> K5 -> K6 per shard) and min-plus (K7 -> K5 -> K8),
    the launches counted per shard, K2 and K7 (min-plus) held against
    their plain versions on shard 0 of 4 and timed; a shard the planner
    refuses fails the phase;
19. a process-group mesh of one rank through NCCL (a file rendezvous in
    the script's output directory): `distribute_csr` (both modes) and
    `distribute_stream` on bench against the oracles and, in min-plus,
    equal to the 1-shard local mesh bit for bit;
20. `python -m spmv_tpu_torch.bench.weak_scaling --devices 1 2 4` at its
    defaults (65536 rows and 524288 nnz per shard), `--impl stream` and
    `--impl ell`, on local meshes, each launching only its own kernels
    (no stream shard falls back to K11'); its JSON is printed. On one
    card the shards run one after another, so its efficiency checks the
    mechanism and is not a scaling figure;
21. the bench harness, `spmv_tpu_torch.bench.harness.main`, on the card:
    `--synthetic powerlaw --rows 1048576 --nnz 3300000 --iters 20` for
    stream, merge, csr_vector and xla, then poisson2d(256) written to a
    .mtx file in the output directory, read back by the native parser (equal
    to the Python parser's arrays), for stream, csr_vector, dia and xla:
    every kind must be in the results and within rtol 2e-4 / atol 1e-5 of
    the float64 oracle (`delta["within_gate"]`); each result's row is
    printed;
22. `spgemm(G, G, MIN_PLUS)` on the sssp graph (one APSP relaxation,
    two-hop distances): the symbolic phase timed native and NumPy (equal
    arrays), the virtual CSR's stream plan built and timed, then
    `method="stream"` (its launches by kernel; it must run the stream
    kernels), `"auto"` (the same launches: it rides the plan) and
    `"xla"` (none of the hand-written kernels); C's pattern equal to
    SciPy's, stream == auto == xla bit for bit and equal to a NumPy
    semiring oracle on SPGEMM_SAMPLE sampled rows; the numeric phase and
    the whole call timed by CUDA events;
23. the same for plus-times `spgemm(R, R)` on random 4.2M, within rtol
    2e-4 / atol 1e-4 of SciPy's A @ A in float64;
24. `SparseOperator(A, kind="stream")` on the arxiv-size graph: the
    gradient of sum(op(x)**2) against float64 NumPy (rtol 2e-4, atol 1e-4
    of its largest entry), the launches of the forward and of the
    backward (A^T's plan) by kernel, both timed;
25. `spmv_values` on the same graph: the gradients w.r.t. Ax and x
    against float64 NumPy (the same gate), forward plus backward timed;
26. ILU(0) on poisson2d(1024): factorization and both solve plans timed
    on the host, the levels per triangle, `ilu0_apply` against SciPy's
    `spsolve_triangular` in float64 (rtol 2e-3, atol 2e-3,
    tests/test_trisolve.py's), exactly two K14 launches (the wrappers'
    count, and the kernel nodes of the same apply captured as a CUDA
    graph, whose replay equals it bit for bit), ms per apply;
27. CG with M="ilu0" on poisson2d(256) through csr_vector -> dia -> K12,
    its chunks as CUDA graphs: converged to rtol 1e-6 with a true
    relative residual <= 1e-3, K12 once per matvec and K14 twice per
    preconditioner apply (1 + CHUNK x chunks and 2 + 2 x CHUNK x chunks:
    the eager launches by the wrappers, set to 0 just before the solve,
    plus the chunk graph's kernel nodes times its replays), the same
    iters and x bit for bit as eager chunks (a callable M), ms per
    iteration both ways, and a masked iteration's time past the stop
    (one more replay on the stopped state, x and k unchanged);
28. `spmv_tpu_torch.examples.pagerank` (stream) and `.bfs` (merge_genl,
    or-and) at 1,048,576 nodes and 4,194,304 edges: the ranks against a
    float64 power iteration (rtol 1e-3, atol 1e-9) summing to 1, the BFS
    levels equal to the example's host BFS, launches over the run and of
    one matvec, ms per matvec;
29. bfloat16 and float16 values through the stream kernels (K1, K7, K5,
    K8 on bench; K3, K5, K8, K4 on the graph), each kernel held and timed;
30. user-defined rings, each built into its own library, through every
    ring-templated kernel and end to end;
31. bfloat16 and float16 values off the stream path, on bench's plans with
    their values mapped (no plan built again): K9 -> K11 (csr_vector_ell),
    K9 -> K10 -> K9 (merge_tiled), K11' (distribute_csr, 4 local shards;
    also a bf16 A with a float32 x, float32 y) and K7 -> K5 -> K8 per shard
    (distribute_stream, 4 local shards; a float32 x with bf16 values raises
    ValueError before any launch), in bf16 and f16 plus-times (f16 on
    multiples of 1/2 in [-1, 1]) and bf16 min-plus; K12 (dia, csr_vector)
    on poisson2d(1024) and K13 (spmm window, B 128) on the arxiv-size
    graph in bf16 and f16 plus-times. Each kernel against its plain
    version (bit for bit; K10's and K7's sums within rtol 2e-4 / atol
    1e-5, K7's within one ulp of the value dtype) and timed alone, back to
    back, by the profiler and, for K11', K12 and K13, with the L2 flushed,
    beside its bound at 2 B a value; each call against the float64 oracle
    (bf16 within 0.08 of max(1, max|y|), f16 within rtol 2e-4 / atol
    1e-5 or, past 512 where f16 holds no quarters, equal to it rounded to
    f16) or, in min-plus, the float32 scatter oracle rounded once, bit
    for bit; an f16 call on the mesh also equal bit for bit to the same
    call on the CPU (plain versions), which is what holds its rows cut
    across shards: each shard's partial of such a row rounds to f16 where
    it is written, and bench's hub row has partials past 512, where f16
    holds no quarters;
32. the device loops: every device kind captured in a CUDA graph after one
    eager call and replayed, equal to the eager call bit for bit (within
    one float32 ulp for the plus-times row folds by float64 atomics,
    ops/registry.py:ATOMIC_FOLD_KINDS): the harness's fourteen default kinds on bench in
    plus-times, min-plus, max-times and or-and, `dia` and `csr_vector`
    (its dia branch) on poisson2d(1024) in the four rings, `dense` on
    poisson2d(64); the harness's kernel time of each default kind on
    bench by graph chain (utils/timing.py) beside 20 calls back to back
    and the profiler's device busy time, a 50-call chain on the wide-row
    matrix peaking at most twice one call's memory and holding less than
    one call's after, and cpu_naive timed by calls;
    K14 against its plain version bit for bit on ILU(0)'s L and U of
    poisson2d(1024) and on a random lower triangle of 100,000 rows (6
    earlier rows each), each timed alone, back to back, by the profiler,
    with the L2 flushed, beside its bound (the triangle's own bytes: each
    off-diagonal entry's column and value, the diagonal where it is not
    unit, the row order, b and x; the padded plan envelope's bound
    printed beside it) and torch.triangular_solve on a
    sparse CSR matrix (cuSPARSE) where this PyTorch has it, and beside a
    chain of as many one-slot levels (the level floor); K14 in bf16 and
    f16 on L, and with +-inf and NaN in b on the random triangle (NaN as
    NaN); cg on poisson2d(1024) and bicgstab on poisson2d(256) (float32
    BiCGSTAB breaks down on larger ones) by replayed graph against
    the same chunks run eagerly (a callable M): the same iters and x bit
    for bit, the host's reads per solve (1 + one a chunk) and ms per
    iteration both ways.

Every failure exits non-zero. The line before the last is the JSON list
of kernels; the last is {"ok": true, "device": {...}}. Timings stand
beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

RTOL, ATOL = 2e-4, 1e-5
ULP16 = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}  # one ulp, as an rtol
ITERS = 30
B2B, B2B_REPEATS = 20, 10  # launches per event pair, and such pairs
L2_FLUSH_BYTES = 256 << 20  # written between launches timed with a cold L2
ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA's data sheet for the H100 SXM at its 700 W limit: the memory
# rate, and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def k2_reads(args, Qp: int):
    """What K2 on (x2d, Ax, q, xb, c1, c2, c3) must read: all of x2d, Ax,
    q, xb and c1, but of each tile's c2 only its first Qp columns and of
    its c3 only its first Qp rows, since only the first Qp routed rows
    are written."""
    x2d, ax, q, xb, c1, c2, c3 = args
    tiles = lambda c: c.reshape(-1, 128, 128)
    return (x2d, ax, q, xb, c1, tiles(c2)[:, :, :Qp], tiles(c3)[:, :Qp])


def k7_reads(args, Qp: int):
    """What K7 on (x2d, Ax, q, xb, c1, c2, c3, rs) must read: what K2
    reads, and the run-start flags rs whole."""
    return k2_reads(args[:7], Qp) + (args[7],)


def bound_of(moved_bytes: float, ops: float):
    """The least time the card could take, ms, and what sets it: the
    bytes at the memory rate or the operations at the float32 rate."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one fn() call, ms: torch.profiler's kernel and copy
    time over `calls` calls, summed over every kernel a call launches.
    A trace with no device time is taken again, up to 3 times; after
    that the profiler's event names are printed and 0 is returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(e.self_device_time_total for e in events
                 if not e.key.startswith(("aten::", "cuda")))
        if us > 0:
            return us / calls / 1e3
    print(f"device_ms: the profiler recorded no device time in 3 traces; events: "
          f"{[(e.key[:60], e.count, e.self_device_time_total) for e in events][:8]}")
    return 0.0


def ptxas_report(log: str, names) -> None:
    """Print ptxas's registers, shared memory and spills for each entry
    function whose name holds one of `names`; fail on a spill or on an
    entry not found."""
    lines = log.splitlines()
    found = 0
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or not any(n in line for n in names):
            continue
        entry = line.split("'")[1]
        props = " ".join(l.strip() for l in lines[i + 1:i + 4]
                         if "spill" in l or "registers" in l)
        print(f"ptxas {entry}: {props}")
        check(" 0 bytes spill stores, 0 bytes spill loads" in props,
              f"ptxas: {entry} spills registers")
        found += 1
    check(found >= len(names), f"ptxas report: found {found} entries of {names}")


def flushed_ms(fn, dev, before=None) -> float:
    """fn's median time alone over ITERS launches, ms, with the L2 flushed
    before each launch (a 256 MB buffer written and read outside the
    timed window), as a caller whose other work evicts the L2 meets it;
    `before` runs after the flush, outside the window."""
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    try:
        return cuda_time_ms(fn, iters=ITERS, flush=flush, before=before)["median_ms"]
    finally:
        del flush


# The kernels that the device loops launch inside CUDA graphs, by their
# functions' names: a graph's replays launch them without their wrappers,
# so such launches are counted from the graph's kernel nodes
GRAPH_STEMS = {"K12 dia": "dia_kernel", "K14 sptrsv": "sptrsv_kernel"}


def graph_launches(graph) -> dict:
    """{kernel: launches} of GRAPH_STEMS in one replay of `graph`, read
    from its kernel nodes (utils/timing.py:graph_kernels); kernels with
    no node are left out."""
    from spmv_tpu_torch.utils.timing import graph_kernels

    nodes = graph_kernels(graph, tuple(GRAPH_STEMS.values()))
    return {k: nodes[s] for k, s in GRAPH_STEMS.items() if s in nodes}


def graphed_solve(A, name, M, solve, reset, counts):
    """A solve whose chunk graph is cached on A (a solve ran before) run
    once more with the launches counted: the wrappers' counts of its
    eager launches, set to 0 just before it, plus the graph's kernel nodes
    times the chunks the host replayed. Then the graph replayed once more
    on the stopped state, timed by CUDA events: CHUNK masked iterations,
    which must leave x and k as they are, bit for bit. -> (x, info,
    {"launches", "eager", "per_chunk", "chunks", "ms", "masked_ms"}), ms
    the solve's on the host clock, masked_ms one masked iteration's."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.ops.registry import plan_cache, plan_cached

    key = solvers.graph_key(name, "csr_vector", M, torch.float32, torch.device("cuda", 0))
    check(plan_cached(A, key), f"{name}: no chunk graph cached for {key}")
    graph, static = plan_cache(A, key, None)
    per_chunk = graph_launches(graph)
    torch.cuda.synchronize()
    reset()
    reads = solvers.host_reads
    t = time.perf_counter()
    x, info = solve()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t) * 1e3
    eager = counts()
    chunks = solvers.host_reads - reads - 1
    check(plan_cache(A, key, None)[0] is graph, f"{name}: the solve captured a new graph")
    c = {k: eager.get(k, 0) + per_chunk.get(k, 0) * chunks
         for k in sorted(set(eager) | set(per_chunk))}
    x_s, k_s = static["x"].clone(), static["k"].clone()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    check(torch.equal(static["x"], x_s) and torch.equal(static["k"], k_s),
          f"{name}: masked iterations changed x or k")
    return x, info, {"launches": c, "eager": eager, "per_chunk": per_chunk,
                     "chunks": chunks, "ms": solve_ms,
                     "masked_ms": start.elapsed_time(end) / solvers.CHUNK}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    # torch.profiler tears CUPTI down after every trace and sets it up again
    # for the next; once CUDA graphs exist, later traces then lose device
    # events. Keep it up, as torch/profiler/profiler.py does for its own
    # graph backend (TEARDOWN_CUPTI=0, read by the profiler's Kineto)
    os.environ["TEARDOWN_CUPTI"] = "0"
    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr, random_csr
    from spmv_tpu_torch.kernels import _cuda
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import shuffle as tsh
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    # 2. build
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'} s)")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
        f.write(_cuda.build_log)
    ptxas_report(_cuda.build_log, ("13reduce_kernel", "16scan_diff_kernel",  # K2, K6
                                   "18reduce_roll_kernel", "19gather_split_kernel",  # K7, K3
                                   "16local_ell_kernel",  # K11', one per ring and W
                                   # K1, K4, K5 and K8: every value type (and ring)
                                   "12xprep_kernel", "13gather_kernel",
                                   "12split_kernel", "16scan_roll_kernel",
                                   # K9-K13: every value type (and ring)
                                   "14pgather_kernel", "19group_reduce_kernel",
                                   "18merge_group_kernel", "18merge_carry_kernel",
                                   "10dia_kernel", "18spmm_window_kernel",
                                   "13sptrsv_kernel"))  # K14

    from spmv_tpu_torch.kernels import dia as tdia
    from spmv_tpu_torch.kernels import ell as tell
    from spmv_tpu_torch.kernels import pgather as tpg
    from spmv_tpu_torch.kernels import spmm as tspmm
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.parallel import dist_spmv as tds

    counters = {"K1 xprep": ts._xprep_pass, "K2 reduce": ts._reduce_diff_pass,
                "K3 gather_split": ts._gather_split_pass,
                "K4 gather": ts._gather_pass, "K5 split": tsh._run_split,
                "K6 scan": ts._scan_diff_pass, "K7 reduce_roll": ts._reduce_roll_pass,
                "K8 scan_roll": ts._scan_roll_pass, "K9 pgather": tpg._pgather_pass,
                "K10 merge_group": tm._merge_group_pass,
                "K11 group_reduce": tell._group_reduce_pass, "K12 dia": tdia._dia_pass,
                "K13 spmm_window": tspmm._spmm_window_pass,
                "K11' local_ell": tds._local_ell_pass, "K14 sptrsv": ttri._sptrsv_pass}

    def reset():
        for k in counters.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in counters.items() if k.launches}

    def build_plan(A, label):
        pol = tm._stream_policy_for(14336, dev)  # = the stream kind's on the card
        t = time.perf_counter()
        plan = ts.build_stream_plan(A, pol)
        secs = time.perf_counter() - t
        plan_cache(A, ts.plan_cache_key(pol), lambda: plan)
        p = plan.shuffle.passes
        print(f"{label} plan: {plan.n_gather_tiles} gather tiles, "
              f"{plan.n_final_tiles} final tiles, reduce "
              f"{plan.reduce is not None}, passes "
              f"{[(q.sbt, q.n_steps, q.K, q.Q) for q in p]}, built in "
              f"{secs:.3f} s on the host")
        return plan, plan.to(dev), secs

    results = {}

    def hold(name, kern, plain, exact, ints=None, note="", time_it=True,
             reads=(), extra_bytes=0, ops=None, lib=None, cold=False, tol=None,
             variant=None):
        """Hold kern against plain on normal data (and, for sums,
        bit for bit on integer data via `ints`), and time both: each
        launch alone between CUDA events (the wrapper's host cost
        included) and, for the kernel, 20 launches back to back between
        one event pair, divided by 20, and its device time (profiler).
        Each timed run prints its bound (the tensors in `reads` read
        once, `extra_bytes` of intermediates, the output written once;
        `ops` ring operations, one per output element by default) and
        the time of `lib`, one PyTorch call computing the same function,
        where there is one, timed all three ways too; the first timed run
        of a kernel is the one recorded. With `cold`, the kernel alone is
        also timed with the L2 flushed before each launch (`flushed_ms`),
        recorded as `l2_flushed_ms` where the kernel has none yet. `tol`
        (rtol, atol) replaces rtol 2e-4 / atol 1e-5 for sums that are not
        exact (2-byte values: one ulp of the value dtype); with `variant`
        (a value dtype or ring other than the main path's) the numbers go
        under the kernel's "variants"."""
        out = kern()
        a, b = out, plain()
        torch.cuda.synchronize()
        a, b = a.float(), b.float()
        rtol, atol = tol or (RTOL, ATOL)
        err = float((a - b).abs().max())
        check(torch.isfinite(a).any() or a.numel() == 0,
              f"{name}: no finite kernel output")
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
              f"{name}: infinities differ from its plain version")
        if exact:
            check(torch.equal(a, b), f"{name}{note}: not bitwise equal to its "
                                     f"plain version (max |diff| {err})")
        else:
            check(torch.allclose(a, b, rtol=rtol, atol=atol),
                  f"{name}{note}: outside rtol {rtol} atol {atol} of its plain "
                  f"version (max |diff| {err})")
        if ints is not None:
            ai, bi = ints[0](), ints[1]()
            check(torch.equal(ai, bi), f"{name}{note}: differs from its plain "
                                       f"version on integer-valued data")
        fin = torch.isfinite(b)
        err = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
        how = "bitwise" if exact else (f"rtol {rtol} atol {atol} (bit for bit: "
                                       f"{torch.equal(a, b)})")
        if ints is not None:
            how += " (bitwise on integer data)"
        msg = f"{name}{note}: matches plain version, {how}, max |diff| {err:.3e}"
        if time_it:
            tk = cuda_time_ms(kern, iters=ITERS)["median_ms"]
            tb = cuda_time_ms(kern, iters=B2B_REPEATS, batch=B2B)["median_ms"]
            tp = cuda_time_ms(plain, iters=ITERS)["median_ms"]
            moved = tensor_bytes(*reads, out) + extra_bytes
            n_ops = out.numel() if ops is None else ops
            bound_ms, bound_by = bound_of(moved, n_ops)
            td = device_ms(kern)
            lib_ms = lib_b2b = lib_dev = None
            if lib:
                lib_ms = cuda_time_ms(lib, iters=ITERS)["median_ms"]
                lib_b2b = cuda_time_ms(lib, iters=B2B_REPEATS, batch=B2B)["median_ms"]
                lib_dev = device_ms(lib)
            row = {"max_abs_err": err, "ms": tk, "plain_ms": tp,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms, "b2b_ms": tb,
                   "library_b2b_ms": lib_b2b, "device_ms": td,
                   "library_device_ms": lib_dev}
            if variant:
                results.setdefault(name, {}).setdefault("variants", {}).setdefault(variant, row)
            else:
                results.setdefault(name, row)
            msg += (f"; kernel {tk:.4f} ms alone, {tb:.4f} ms back to back ({B2B} "
                    f"launches per event pair), {td:.4f} ms of device time (profiler), "
                    f"plain {tp:.4f} ms (medians of {ITERS} and "
                    f"{B2B_REPEATS}; {card}); bound {bound_ms:.4f} ms ({moved / 1e6:.1f} "
                    f"MB, {n_ops} ops; {bound_by}); library call "
                    f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms alone, {lib_b2b:.4f} ms back to back, {lib_dev:.4f} ms of device time'}")
            if cold:
                tc = flushed_ms(kern, dev)
                (results[name]["variants"][variant] if variant
                 else results[name]).setdefault("l2_flushed_ms", tc)
                msg += (f"; kernel {tc:.4f} ms alone with the L2 flushed before each "
                        f"launch ({tc / bound_ms:.2f}x its bound)")
        print(msg)
        return out

    # 3a. K1, K2, K5, K6 (plus-times) and K7, K8 (min / max) on the bench plan
    A = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x_np = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    plan, dplan, plan_s = build_plan(A, "bench")
    check(plan.reduce is not None and "xr1" in plan.gather,
          "bench plan is not on the reduction branch with the lane remap")
    g, rd, sc = dplan.gather, dplan.reduce, dplan.scan
    n_w = plan.x_rows_pad // 128
    F_pad = int(sc["counts"].shape[0])
    gen = torch.Generator(device=dev).manual_seed(1)
    Ax_int = torch.randint(-4, 5, tuple(g["Ax"].shape), generator=gen, device=dev).float()
    x_int = torch.randint(-4, 5, (A.n_cols,), generator=gen, device=dev).float()
    x = torch.from_numpy(x_np).to(dev)
    print(f"audit_plan bytes per call (bench): "
          f"{ts.audit_plan(plan, A.nnz)['per_pass_bytes']}")

    def pad_fin(prod, F, fill):
        return torch.nn.functional.pad(prod, (0, 0, 0, F * 128 - prod.shape[0]),
                                       value=fill)[:F * 128].contiguous()

    def stages(plan_m, dplan_m, A_m, Ax, xv):
        """The kernel and plain calls of K1, K2, K5 and K6 on one plan
        (plus-times), each fed the kernels' outputs of the stage before;
        with each, the tensors it reads and its intermediate bytes."""
        gm, rdm, scm = dplan_m.gather, dplan_m.reduce, dplan_m.scan
        n_wm, Fm = plan_m.x_rows_pad // 128, int(scm["counts"].shape[0])
        xnat = torch.nn.functional.pad(
            xv, (0, gm["x_nat_rows"] * 128 - A_m.n_cols)).reshape(-1, 128)
        win = (xnat, gm["g0"], gm["xr1"], gm["xr2"], gm["xr3"])
        k1 = (lambda: ts._xprep_pass(*win, n_w=n_wm),
              lambda: ts._xprep_plain(*win, n_w=n_wm), win, 0)
        x2d = ts._x_table(dplan_m, xv, A_m.n_cols)
        kw = dict(sr=PLUS_TIMES, n_tiles=plan_m.n_gather_tiles, Qp=rdm["Qp"],
                  out_rows=rdm["out_rows"])
        args2 = (x2d, Ax, gm["q"], gm["xb"], rdm["c1"], rdm["c2"], rdm["c3"])
        k2 = (lambda: ts._reduce_diff_pass(*args2, **kw),
              lambda: ts._reduce_diff_plain(*args2, **kw), k2_reads(args2, rdm["Qp"]), 0)
        part = k2[0]()
        passes, sdev = plan_m.shuffle.passes, dplan_m.shuffle_dev
        # every pass reads its stages and input and writes its output
        k5 = (lambda: tsh.apply_shuffle(part, passes, sdev),
              lambda: shuffle_plain(part, passes, sdev),
              [part] + [v for d in sdev for v in d.values()],
              sum(p.out_rows * 128 * 4 for p in passes[:-1]) * 2)
        prod = pad_fin(k5[0](), Fm, 0.0)
        args6 = (prod, *[scm[k] for k in ("pm1", "pm2", "pm3", "r2s1", "r2s2",
                                           "r2s3", "q2s1", "q2s2", "q2s3",
                                           "valid2", "counts")])
        k6 = (lambda: ts._scan_diff_pass(*args6, F_pad=Fm),
              lambda: ts._scan_diff_plain(*args6, F_pad=Fm), args6, 0)
        return {"K1 xprep": k1, "K2 reduce": k2, "K5 split": k5, "K6 scan": k6}

    def split_take(passes, sdev, data, fill, kern):
        """K5's library call: the passes composed into one flat int64
        index, built once on the card by the plain split of an iota whose
        fill points at one element of `fill` appended to the data (the
        padded copy is made once, outside the timed call), then one
        torch.take. It must equal the kernels' output bit for bit."""
        n = data.numel()
        iota = torch.arange(n, dtype=torch.int64, device=dev).reshape(-1, 128)
        idx = shuffle_plain(iota, passes, sdev, fill=n)
        padded = torch.cat([data.reshape(-1), torch.full((1,), fill, device=dev)])
        take = lambda: torch.take(padded, idx)
        check(torch.equal(take(), kern()), "K5: torch.take of the composed index "
                                           "differs from the kernel's output")
        print(f"K5 split: torch.take by the composed index ({idx.numel()} int64) "
              f"equals the kernel's output bit for bit")
        return take

    def xprep_take(xnat, kern):
        """K1's library call: its route composed into one flat int64 index,
        built once on the card by the plain x prep of an iota shaped like
        xnat (outside the timed call), then one torch.take. It must equal
        the kernel's output bit for bit."""
        iota = torch.arange(xnat.numel(), dtype=torch.int64, device=dev).reshape(xnat.shape)
        idx = ts._xprep_plain(iota, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w)
        flat = xnat.reshape(-1)
        take = lambda: torch.take(flat, idx)
        check(torch.equal(take(), kern()), "K1: torch.take of the composed index "
                                           "differs from the kernel's output")
        print(f"K1 xprep: torch.take by the composed index ({idx.numel()} int64) "
              f"equals the kernel's output bit for bit")
        return take

    normal = stages(plan, dplan, A, g["Ax"], x)
    ints = stages(plan, dplan, A, Ax_int, x_int)
    for name in ("K1 xprep", "K2 reduce", "K5 split", "K6 scan"):
        exact = name in ("K1 xprep", "K5 split")
        kern, plain, reads, extra = normal[name]
        lib = (split_take(plan.shuffle.passes, dplan.shuffle_dev, reads[0], 0.0, kern)
               if name == "K5 split" else xprep_take(reads[0], kern)
               if name == "K1 xprep" else None)
        hold(name, kern, plain, exact, ints=None if exact else ints[name][:2],
             note=" (bench plan, 2 passes)" if name == "K5 split" else "",
             reads=reads, extra_bytes=extra, lib=lib)

    def roll_chain(sr, x2d):
        """K7 -> K5 -> K8 on the bench plan for ring sr: the kernel and
        plain calls of K7 and of K8 (fed the kernels' own outputs)."""
        ident = float(sr.identity_for(np.float32))
        kw = dict(sr=sr, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
                  out_rows=rd["out_rows"])
        args7 = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
        k7 = (lambda: ts._reduce_roll_pass(*args7, **kw),
              lambda: ts._reduce_roll_plain(*args7, **kw), args7)
        prod = pad_fin(tsh.apply_shuffle(k7[0](), plan.shuffle.passes,
                                         dplan.shuffle_dev, fill=ident), F_pad, ident)
        args8 = (prod, *[sc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1",
                                          "r2s2", "r2s3", "valid2")])
        k8 = (lambda: ts._scan_roll_pass(*args8, sr=sr, F_pad=F_pad),
              lambda: ts._scan_roll_plain(*args8, sr=sr, F_pad=F_pad), args8)
        return k7, k8

    x2d_bench = ts._x_table(dplan, x, A.n_cols)
    k7_min, _ = roll_chain(MIN_PLUS, x2d_bench)
    hold("K7 reduce_roll", *k7_min[:2], True, note=" (bench plan, min_plus)",
         reads=k7_reads(k7_min[2], rd["Qp"]), cold=True)
    k7_max, k8_max = roll_chain(MAX_TIMES, x2d_bench)
    hold("K7 reduce_roll", *k7_max[:2], True, note=" (bench plan, max_times)",
         time_it=False)
    x_or = torch.where(torch.rand(A.n_cols, generator=gen, device=dev) < 0.7, 0.0, x)
    k7_or, _ = roll_chain(OR_AND, ts._x_table(dplan, x_or, A.n_cols))
    hold("K7 reduce_roll", *k7_or[:2], True, note=" (bench plan, or_and)", time_it=False)

    # 3b. K4, K3, K5 and K8 on the shortest-paths graph's plan
    from spmv_tpu_torch.examples.shortest_paths import random_graph, sssp

    G = random_graph(1 << 20, 4, seed=0)
    gplan, gdplan, gplan_s = build_plan(G, "sssp graph")
    gp0 = gplan.shuffle.passes[0]
    check(gplan.reduce is None and gp0.sbt == 8
          and gp0.n_steps * 8 == gplan.n_gather_tiles,
          "sssp graph plan is not on the fused no-reduction branch (K3)")
    gg, gsc, gd0 = gdplan.gather, gdplan.scan, gdplan.shuffle_dev[0]
    gF = int(gsc["counts"].shape[0])
    gt = gplan.n_gather_tiles
    d_np = np.random.default_rng(5).uniform(0.0, 30.0, G.n_cols).astype(np.float32)
    d_np[np.random.default_rng(6).random(G.n_cols) < 0.3] = np.inf
    x2d_g = ts._x_table(gdplan, torch.from_numpy(d_np).to(dev), G.n_cols)
    kw3 = dict(sbt=8, n_tiles=gt, K=gp0.K, Q=gp0.Q, rows_per_g=gp0.out_rows // gp0.K)
    args3 = (x2d_g, gg["Ax"], gg["q"], gg["xb"], gd0["s1"], gd0["s2"], gd0["s3"],
             gd0["starts"], gd0["pos"])
    for sr in (MIN_PLUS, PLUS_TIMES):
        note = f" (sssp graph plan, {sr.name})"
        timed = sr is MIN_PLUS
        ident = float(sr.identity_for(np.float32))
        prod4 = hold("K4 gather", lambda: ts._gather_pass(*args3[:4], sr=sr, n_tiles=gt),
                     lambda: ts._gather_plain(*args3[:4], sr=sr, n_tiles=gt), True,
                     note=note, time_it=timed, reads=args3[:4], cold=timed)
        fused = hold("K3 gather_split",
                     lambda: ts._gather_split_pass(*args3, sr=sr, gaps=gd0["gaps"], **kw3),
                     lambda: ts._gather_split_plain(*args3, sr=sr, **kw3), True,
                     note=note, time_it=timed, reads=args3 + (gd0["gaps"],))
        split = tsh._run_split(prod4, gd0["s1"], gd0["s2"], gd0["s3"], gd0["starts"],
                               gd0["pos"], n_steps=gp0.n_steps, sbt=8, K=gp0.K,
                               Q=gp0.Q, rows_per_g=gp0.out_rows // gp0.K,
                               gaps=gd0["gaps"], fill=ident)
        torch.cuda.synchronize()
        check(torch.equal(fused, split), f"K3 != K4 + K5 pass 1{note}")
        print(f"K3 == K4 + one K5 pass, bit for bit{note}")
    fused = ts._gather_split_pass(*args3, sr=MIN_PLUS, gaps=gd0["gaps"], **kw3)
    rest = (gplan.shuffle.passes[1:], gdplan.shuffle_dev[1:])
    k5g = lambda: tsh.apply_shuffle(fused.reshape(-1, 128), *rest, fill=np.inf)
    hold("K5 split", k5g, lambda: shuffle_plain(fused.reshape(-1, 128), *rest, fill=np.inf),
         True, note=f" (sssp graph plan, passes 2..{len(gplan.shuffle.passes)})",
         reads=[fused] + [v for d in rest[1] for v in d.values()],
         extra_bytes=sum(p.out_rows * 128 * 4 for p in rest[0][:-1]) * 2,
         lib=split_take(*rest, fused, np.inf, k5g))
    gprod = pad_fin(tsh.apply_shuffle(fused.reshape(-1, 128), *rest, fill=np.inf),
                    gF, np.inf)
    args8 = (gprod, *[gsc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1",
                                        "r2s2", "r2s3", "valid2")])
    hold("K8 scan_roll", lambda: ts._scan_roll_pass(*args8, sr=MIN_PLUS, F_pad=gF),
         lambda: ts._scan_roll_plain(*args8, sr=MIN_PLUS, F_pad=gF), True,
         note=" (sssp graph plan, min_plus)", reads=args8)
    # after the graph's, which the kernels line records: bench's 80 tiles
    hold("K8 scan_roll", *k8_max[:2], True, note=" (bench plan, max_times)",
         reads=k8_max[2])
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    def end_to_end(label, A_m, x_m_np, plan_s, want):
        """Plus-times `spmv("stream", A_m, x)` on the card against the
        float64 oracle and cuSPARSE; checks the launch counts of one call."""
        x_m = torch.from_numpy(x_m_np).to(dev)
        st.spmv("stream", A_m, x_m)  # uploads the plan, warms the path
        torch.cuda.synchronize()
        reset()
        y = st.spmv("stream", A_m, x_m)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{label}: launches {c}, want {want}")
        y_np = y.cpu().numpy()
        check(y.shape == (A_m.n_rows,) and np.isfinite(y_np).all(),
              f"{label}: y not finite or of the wrong shape")
        y_ref = st.spmv_ref(A_m, x_m_np, y_dtype=np.float64)
        delta = correctness_delta(y_ref, y_np)
        check(np.allclose(y_np, y_ref, rtol=RTOL, atol=ATOL),
              f"{label}: y outside rtol {RTOL} atol {ATOL} of the oracle "
              f"(max_rel {delta['max_rel']:.3e})")
        t = cuda_time_ms(lambda: st.spmv("stream", A_m, x_m), iters=20)["median_ms"]
        with warnings.catch_warnings():  # beta-state notices of torch.sparse
            warnings.simplefilter("ignore", UserWarning)
            Ms = torch.sparse_csr_tensor(
                torch.from_numpy(np.asarray(A_m.Ap, np.int64)),
                torch.from_numpy(np.asarray(A_m.Aj, np.int64)),
                torch.from_numpy(np.asarray(A_m.Ax)), size=A_m.shape).to(dev)
        y_cs = Ms @ x_m
        cs_err = correctness_delta(y_ref, y_cs.cpu().numpy())["max_rel"]
        tcs = cuda_time_ms(lambda: Ms @ x_m, iters=20)["median_ms"]
        print(f"{label} plus_times: nnz {A_m.nnz}, within rtol {RTOL} atol {ATOL} of "
              f"the oracle, max_rel {delta['max_rel']:.3e}, mean_abs "
              f"{delta['mean_abs']:.3e}; launches {c}; plan build {plan_s:.3f} s "
              f"(host); stream {t:.4f} ms/call = {A_m.nnz / t / 1e6:.3f} Gnnz/s; "
              f"cuSPARSE (torch.sparse_csr_tensor @ x, comparison only) {tcs:.4f} ms "
              f"= {A_m.nnz / tcs / 1e6:.3f} Gnnz/s, max_rel {cs_err:.3e} ({card})")
        return c

    launches = {}

    # 4. plus-times end to end on the bench and wide-row matrices
    W = power_law_csr(1 << 20, 1 << 20, 16_777_216, alpha=1.5, seed=42)
    xw = np.random.default_rng(0).standard_normal(W.n_cols).astype(np.float32)
    wplan, wdplan, wplan_s = build_plan(W, "wide-row")
    # K6's second row: the wide-row plan's final tiles, more than the SMs
    wF = int(wdplan.scan["counts"].shape[0])
    wk6 = stages(wplan, wdplan, W, wdplan.gather["Ax"], torch.from_numpy(xw).to(dev))
    wk6_int = stages(wplan, wdplan, W,
                     torch.randint(-4, 5, tuple(wdplan.gather["Ax"].shape), generator=gen,
                                   device=dev).float(),
                     torch.randint(-4, 5, (W.n_cols,), generator=gen, device=dev).float())
    hold("K6 scan", *wk6["K6 scan"][:2], False, ints=wk6_int["K6 scan"][:2],
         note=f" (wide-row plan, {wF} final tiles)", reads=wk6["K6 scan"][2])
    del wk6, wk6_int, wdplan
    for label, A_m, x_m_np, plan_m, plan_m_s in (
            ("bench", A, x_np, plan, plan_s), ("wide_row", W, xw, wplan, wplan_s)):
        want = {"K1 xprep": 1, "K2 reduce": 1,
                "K5 split": len(plan_m.shuffle.passes), "K6 scan": 1}
        c = end_to_end(label, A_m, x_m_np, plan_m_s, want)
        if label == "bench":
            launches.update({k: c[k] for k in ("K1 xprep", "K2 reduce", "K6 scan")})
    del wplan

    # 5. the shortest paths through merge_genl, to the fixed point
    n_checked = [0]

    def exact_relaxation(d, relaxed):
        want = st.spmv_ref_semiring(G, d.cpu().numpy(), MIN_PLUS)
        check(np.array_equal(relaxed.cpu().numpy(), want),
              f"sssp relaxation {n_checked[0] + 1} differs from the semiring oracle")
        n_checked[0] += 1

    reset()
    d, iters = sssp(G, 0, kind="merge_genl", device=dev, on_relax=exact_relaxation)
    torch.cuda.synchronize()
    run_counts = counts()
    passes = len(gplan.shuffle.passes)
    check(run_counts == {"K3 gather_split": iters, "K5 split": iters * (passes - 1),
                         "K8 scan_roll": iters},
          f"sssp: launches {run_counts} over {iters} relaxations")
    launches.update({k: run_counts[k] for k in ("K3 gather_split", "K8 scan_roll")})
    launches["K5 split"] = run_counts["K5 split"]
    reset()
    st.spmv("merge_genl", G, d, semiring=MIN_PLUS)
    torch.cuda.synchronize()
    one = counts()
    check(one == {"K3 gather_split": 1, "K5 split": passes - 1, "K8 scan_roll": 1},
          f"sssp: launches of one relaxation {one}")
    dist_ref = dijkstra_scipy(G, 0)
    d_np = d.cpu().numpy()
    reach = np.isfinite(dist_ref)
    check(np.array_equal(np.isfinite(d_np), reach), "sssp: reachable sets differ")
    err = float(np.abs(d_np[reach].astype(np.float64) - dist_ref[reach]).max())
    check(err <= 1e-4, f"sssp: max |d - dijkstra| {err:.3e} > 1e-4")
    t_rel = cuda_time_ms(lambda: st.spmv("merge_genl", G, d, semiring=MIN_PLUS),
                         iters=20)["median_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, iters2 = sssp(G, 0, kind="merge_genl", device=dev)
    torch.cuda.synchronize()
    t_loop = (time.perf_counter() - t0) * 1e3
    print(f"sssp on random_graph(1<<20, 4, seed 0): nnz {G.nnz}, {iters} "
          f"relaxations to the fixed point (the allclose test), each equal to the "
          f"semiring oracle bit for bit; {int(reach.sum())} of {G.n_rows} vertices "
          f"reachable; max |d - scipy dijkstra (float64)| {err:.3e}; launches over "
          f"the run {run_counts}, of one relaxation {one}; one relaxation "
          f"{t_rel:.4f} ms = {G.nnz / t_rel / 1e6:.3f} Gnnz/s (CUDA events, median "
          f"of 20); whole loop {t_loop:.1f} ms for {iters2} relaxations = "
          f"{t_loop / iters2:.4f} ms each, host clock ({card})")

    # 6. the other rings and matrices against their oracles
    xg = np.random.default_rng(7).standard_normal(G.n_cols).astype(np.float32)
    R = random_csr(1 << 20, 1 << 20, 4_194_304, seed=42)
    xr = np.random.default_rng(8).standard_normal(R.n_cols).astype(np.float32)
    rplan, _, rplan_s = build_plan(R, "random 4.2M")
    for label, A_m, x_m_np, plan_m, plan_m_s in (
            ("sssp graph", G, xg, gplan, gplan_s), ("random 4.2M", R, xr, rplan, rplan_s)):
        want = {"K3 gather_split": 1, "K5 split": len(plan_m.shuffle.passes) - 1,
                "K6 scan": 1}
        end_to_end(label, A_m, x_m_np, plan_m_s, want)
    rng = np.random.default_rng(9)
    cases = [("bench", A, x_np, MIN_PLUS, {"K1 xprep": 1, "K7 reduce_roll": 1,
                                           "K5 split": len(plan.shuffle.passes),
                                           "K8 scan_roll": 1}),
             ("bench", A, x_np, MAX_TIMES, {"K1 xprep": 1, "K7 reduce_roll": 1,
                                            "K5 split": len(plan.shuffle.passes),
                                            "K8 scan_roll": 1}),
             ("bench", A, np.where(rng.random(A.n_cols) < 0.9, 0.0, x_np).astype(
                 np.float32), OR_AND, {"K1 xprep": 1, "K2 reduce": 1,
                                       "K5 split": len(plan.shuffle.passes),
                                       "K6 scan": 1}),
             ("sssp graph", G, np.where(rng.random(G.n_cols) < 0.7, 0.0, xg).astype(
                 np.float32), OR_AND, {"K3 gather_split": 1,
                                       "K5 split": len(gplan.shuffle.passes) - 1,
                                       "K6 scan": 1})]
    for label, A_m, x_m_np, sr, want in cases:
        xt = torch.from_numpy(x_m_np).to(dev)
        st.spmv("stream", A_m, xt, semiring=sr)
        torch.cuda.synchronize()
        reset()
        y = st.spmv("stream", A_m, xt, semiring=sr)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{label} {sr.name}: launches {c}, want {want}")
        if label == "bench" and sr is MIN_PLUS:
            launches["K7 reduce_roll"] = c["K7 reduce_roll"]
        y_np = y.cpu().numpy()
        check(np.array_equal(y_np, st.spmv_ref_semiring(A_m, x_m_np, sr)),
              f"{label} {sr.name}: differs from the semiring oracle")
        t = cuda_time_ms(lambda: st.spmv("stream", A_m, xt, semiring=sr),
                         iters=10)["median_ms"]
        print(f"{label} {sr.name}: equals the semiring oracle bit for bit "
              f"({int(np.isfinite(y_np).sum())} finite of {A_m.n_rows}); launches "
              f"{c}; {t:.4f} ms/call = {A_m.nnz / t / 1e6:.3f} Gnnz/s ({card})")

    launches["K4 gather"] = 0  # no plan the planner builds takes K4
    print(f"stream phases done in {time.perf_counter() - t_start:.1f} s; K4 is not on "
          f"any path the planner builds (pass 0 is always fused): it is held "
          f"against its plain version and checks K3 above")

    direct_phases(dev, card, hold, results, launches, reset, counts,
                  [("bench", A, x_np), ("random 4.2M", R, xr)])
    merge_spmm_phases(dev, card, hold, launches, reset, counts, ("bench", A, x_np),
                      ("wide_row", W, xw), ("sssp graph", G, dist_ref))
    dist_phases(dev, card, hold, launches, reset, counts, ("bench", A, x_np),
                ("sssp graph", G, xg), out_dir)
    harness_phases(card, out_dir)
    ilu_factors = surface_phases(dev, card, reset, counts, launches, G, R)
    print(f"surface phases done in {time.perf_counter() - t_start:.1f} s")
    value_ring_phases(dev, card, hold, results, reset, counts,
                      ("bench", A, x_np, plan), ("sssp graph", G, gplan))
    print(f"value and ring phases done in {time.perf_counter() - t_start:.1f} s")
    half_direct_phases(dev, card, hold, results, reset, counts, ("bench", A, x_np))
    print(f"16-bit direct phases done in {time.perf_counter() - t_start:.1f} s")
    device_loop_phases(dev, card, hold, results, ("bench", A, x_np), ("wide_row", W, xw),
                       ilu_factors)
    print(f"device loop phases done in {time.perf_counter() - t_start:.1f} s")

    check("jax" not in sys.modules, "jax was imported")
    sources = {
        "K1 xprep": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1348"),
        "K2 reduce": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1309"),
        "K3 gather_split": ("gather_kernels.cu", "spmv_tpu/kernels/stream.py:1195"),
        "K4 gather": ("gather_kernels.cu", "spmv_tpu/kernels/stream.py:1572"),
        "K5 split": ("shuffle_kernels.cu", "spmv_tpu/kernels/shuffle.py:607"),
        "K6 scan": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1598"),
        "K7 reduce_roll": ("roll_kernels.cu", "spmv_tpu/kernels/stream.py:1260"),
        "K8 scan_roll": ("roll_kernels.cu", "spmv_tpu/kernels/stream.py:1503"),
        "K9 pgather": ("direct_kernels.cu", "spmv_tpu/kernels/pgather.py:258"),
        "K10 merge_group": ("merge_kernels.cu", "spmv_tpu/kernels/merge.py:478"),
        "K11 group_reduce": ("direct_kernels.cu", "spmv_tpu/kernels/ell.py:205"),
        "K12 dia": ("dia_kernels.cu", "spmv_tpu/kernels/dia.py:174"),
        "K13 spmm_window": ("spmm_kernels.cu", "spmv_tpu/kernels/spmm.py:210"),
        "K11' local_ell": ("dist_kernels.cu", "spmv_tpu/parallel/dist_spmv.py:194"),
        "K14 sptrsv": ("trisolve_kernels.cu", "spmv_tpu/kernels/trisolve.py:151"),
    }
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"spmv_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name], **results[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def random_dia_plan(rng, n: int, D: int):
    """A DIA plan (vals (D, n), valid (D, n) int8, offsets (D,) int32) of
    D random distinct offsets in (-n, n), with 70% of the slots valid,
    none where row + offset falls outside [0, n), as in every plan."""
    offs = np.sort(rng.choice(np.arange(-n + 1, n), D, replace=False)).astype(np.int32)
    cols = np.arange(n)[None, :] + offs[:, None]
    valid = ((rng.random((D, n)) < 0.7) & (cols >= 0) & (cols < n)).astype(np.int8)
    return rng.standard_normal((D, n)).astype(np.float32), valid, offs


def stencil3d(nx: int, ny: int, nz: int):
    """The 7-point Laplacian on an nx x ny x nz grid, x fastest: 6 on the
    diagonal, -1 to each grid neighbour; offsets +-1, +-nx, +-nx*ny."""
    from spmv_tpu_torch import COO, coo_to_csr

    n = nx * ny * nz
    k = np.arange(n, dtype=np.int64)
    i, j, l = k % nx, (k // nx) % ny, k // (nx * ny)
    rows, cols, vals = [k], [k], [np.full(n, 6.0, np.float32)]
    for ok, d in ((i > 0, -1), (i < nx - 1, 1), (j > 0, -nx), (j < ny - 1, nx),
                  (l > 0, -nx * ny), (l < nz - 1, nx * ny)):
        rows.append(k[ok])
        cols.append(k[ok] + d)
        vals.append(np.full(int(ok.sum()), -1.0, np.float32))
    return coo_to_csr(COO(n, n, np.concatenate(rows), np.concatenate(cols),
                          np.concatenate(vals)))


def direct_phases(dev, card, hold, results, launches, reset, counts, mats):
    """Phases 7-10: K12 on two stencil plans; K9 and K11 on the bench and
    pwtk-size ELL plans; the direct, csr-vector, Light and DIA kinds end
    to end against the oracles; CG on poisson2d(POISSON_M) through
    csr_vector -> dia -> K12. `mats` holds (label, A, x) of the matrices
    the stream phases built, to which the pwtk-size matrix is added."""
    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d, true_relative_residual
    from spmv_tpu_torch.io.generate import random_csr
    from spmv_tpu_torch.kernels import csr_vector as tcv
    from spmv_tpu_torch.kernels import dia as tdia
    from spmv_tpu_torch.kernels import ell as tell
    from spmv_tpu_torch.kernels import light as tlight
    from spmv_tpu_torch.kernels import pgather as tpg
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.kernels.ell import STRATEGIES
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    rings = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)

    # 7. K12 on the 2-D and 3-D stencils, three rings
    t = time.perf_counter()
    P, S = poisson2d(POISSON_M), stencil3d(*STENCIL)
    print(f"poisson2d({POISSON_M}): {P.n_rows} rows, {P.nnz} nnz; stencil3d "
          f"{'x'.join(map(str, STENCIL))}: {S.n_rows} rows, {S.nnz} nnz; generated "
          f"in {time.perf_counter() - t:.3f} s")
    for label, M in (("poisson2d", P), ("stencil3d", S)):
        t = time.perf_counter()
        plan = tdia.device_dia_plan(M, dev)
        check(plan is not None, f"{label}: not diagonal-sparse")
        vals, valid, offs = plan
        print(f"{label} DIA plan: offsets {offs.tolist()}, "
              f"{vals.numel() * 4 + valid.numel()} B of vals and valid, built and "
              f"uploaded in {time.perf_counter() - t:.3f} s")
        xm = torch.from_numpy(np.random.default_rng(11).standard_normal(
            M.n_cols).astype(np.float32)).to(dev)
        for sr in (PLUS_TIMES, MIN_PLUS, MAX_TIMES):
            hold("K12 dia", lambda: tdia._dia_pass(vals, valid, xm, offs, sr=sr),
                 lambda: tdia._dia_plain(vals, valid, xm, offs, sr=sr), True,
                 note=f" ({label}, {sr.name})", reads=(vals, valid, xm))
        if label == "poisson2d":
            # as CG meets K12: its vector updates evict the plan from L2
            cold = flushed_ms(lambda: tdia._dia_pass(vals, valid, xm, offs, sr=PLUS_TIMES), dev)
            results["K12 dia"]["l2_flushed_ms"] = cold
            print(f"K12 dia (poisson2d, plus_times): {cold:.4f} ms alone with the L2 "
                  f"flushed before each launch ({L2_FLUSH_BYTES >> 20} MB written and "
                  f"read outside the timed window; median of {ITERS}; {card})")
    # edge shapes: n not a multiple of 4 (scalar plan loads), 1 and 64
    # diagonals, offsets reaching past either end
    rng = np.random.default_rng(18)
    n_e = 30001
    for D in (1, tdia.MAX_DIAGS):
        vals, valid, offs = random_dia_plan(rng, n_e, D)
        vals, valid, offs = (torch.from_numpy(a).to(dev) for a in (vals, valid, offs))
        xm = torch.from_numpy(rng.standard_normal(n_e).astype(np.float32)).to(dev)
        for sr in (PLUS_TIMES, MIN_PLUS, MAX_TIMES):
            hold("K12 dia", lambda: tdia._dia_pass(vals, valid, xm, offs, sr=sr),
                 lambda: tdia._dia_plain(vals, valid, xm, offs, sr=sr), True,
                 note=f" (random plan, n {n_e}, D {D}, {sr.name})", time_it=False)

    # 8. K9 and K11 on ELL plans: bench (csr_vector_ell, light_vec_ell's
    # bins) and the pwtk-size matrix at W 32
    t = time.perf_counter()
    Pw = random_csr(PWTK[0], PWTK[0], PWTK[1], seed=PWTK[2])
    xpw = np.random.default_rng(12).standard_normal(Pw.n_cols).astype(np.float32)
    print(f"pwtk-size random_csr({PWTK[0]}, {PWTK[0]}, {PWTK[1]}, seed={PWTK[2]}): "
          f"mean {Pw.mean_nnz_per_row:.1f} nnz per row, generated in "
          f"{time.perf_counter() - t:.3f} s")
    mats = list(mats) + [("pwtk-size", Pw, xpw)]

    def ell_plans(label, M):
        """The csr-vector ELL plan and the two Light bin sets of M, built
        on the host and uploaded; each must have a paged-gather plan."""
        t = time.perf_counter()
        out = {"csr": [tcv.csr_ell_plan(M, dev)],
               "light_vec": tlight.light_plans(M, tlight.FINE_BINS, "light_vec", dev),
               "light_warp": tlight.light_plans(M, tlight.COARSE_BINS, "light_warp", dev)}
        for key, plans in out.items():
            for p in plans:
                check(p.pgather is not None,
                      f"{label} {key} W {p.width}: no paged-gather plan")
        desc = {k: [(p.width, p.n_tiles, p.pgather.n_chunks, p.pgather.rounds)
                    for p in v] for k, v in out.items()}
        print(f"{label} ELL plans (W, tiles, gather chunks, rounds): {desc}; built and "
              f"uploaded in {time.perf_counter() - t:.3f} s (host)")
        return out

    plans = {label: ell_plans(label, M) for label, M, _ in mats}

    def hold_k9(label, xm, pg, idx):
        """K9 on plan pg against its plain version, `x[idx]` beside it."""
        args = (xm, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
        kw = dict(C=pg.n_chunks, R=pg.rounds)
        hold("K9 pgather", lambda: tpg._pgather_pass(*args, **kw),
             lambda: tpg._pgather_plain(*args, **kw), True,
             note=f" ({label}, {pg.n_chunks} chunks x {pg.rounds} rounds)",
             reads=args, lib=lambda: xm[idx])

    def hold_direct(label, M, xm, plan, strategies):
        hold_k9(label, xm, plan.pgather, plan.aj.reshape(-1).long())
        prod = tell.ell_products(M, xm, PLUS_TIMES, plan)
        W = plan.width
        for s in strategies:
            hold("K11 group_reduce",
                 lambda: tell._group_reduce_pass(prod, W=W, strategy=s, sr=PLUS_TIMES),
                 lambda: tell._group_reduce_plain(prod, W=W, strategy=s,
                                                  sr=PLUS_TIMES)[:, ::W],
                 True, note=f" ({label}, W {W}, {s}, leaders)", reads=(prod,),
                 lib=lambda: prod.view(-1, W).sum(1), time_it=s == strategies[0])

    (_, A, x_np), pw = mats[0], plans["pwtk-size"]["csr"][0]
    x = torch.from_numpy(x_np).to(dev)
    hold_direct("bench csr_vector_ell", A, x, plans["bench"]["csr"][0], STRATEGIES)
    for p in plans["bench"]["light_vec"]:
        hold_direct(f"bench light_vec_ell bin W {p.width}", A, x, p, ("tree",))
    check(pw.width == 32, f"pwtk-size: ELL width {pw.width}, expected 32")
    hold_direct("pwtk-size csr_vector_ell", Pw, torch.from_numpy(xpw).to(dev), pw,
                ("tree", "broadcast"))
    # a stream bucketed on purpose (42 of the 128 sublanes): R_MAX rounds
    rng = np.random.default_rng(17)
    subs = rng.choice(128, 42, replace=False)
    n4 = 1 << 20
    idx4 = rng.integers(0, n4 // 128, n4) * 128 + subs[rng.integers(0, 42, n4)]
    idx4[rng.random(n4) < 0.02] = -1
    pg4 = tpg.build_paged_gather_plan(idx4, n4)
    check(pg4 is not None and pg4.rounds == tpg.R_MAX,
          f"bucketed stream: plan {None if pg4 is None else pg4.rounds} rounds, "
          f"want {tpg.R_MAX}")
    x4 = torch.from_numpy(rng.standard_normal(n4).astype(np.float32)).to(dev)
    hold_k9("bucketed stream, 42 sublanes", x4, pg4.to(dev),
            torch.from_numpy(np.maximum(idx4, 0)).to(dev))
    print(f"direct kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # 9. the kinds end to end against the oracles, with one call's launches
    oracles, cusparse = {}, {}

    def ring_x(x_np, sr):
        if sr is not OR_AND:
            return x_np
        keep = np.random.default_rng(13).random(x_np.size) >= 0.7
        return np.where(keep, x_np, 0.0).astype(np.float32)

    def oracle(label, M, x_np, sr):
        if (label, sr.name) not in oracles:
            oracles[label, sr.name] = (
                st.spmv_ref(M, x_np, y_dtype=np.float64) if sr is PLUS_TIMES
                else st.spmv_ref_semiring(M, x_np, sr))
        return oracles[label, sr.name]

    def cusparse_ms(label, M, xt):
        if label not in cusparse:
            with warnings.catch_warnings():  # beta-state notices of torch.sparse
                warnings.simplefilter("ignore", UserWarning)
                Ms = torch.sparse_csr_tensor(
                    torch.from_numpy(np.asarray(M.Ap, np.int64)),
                    torch.from_numpy(np.asarray(M.Aj, np.int64)),
                    torch.from_numpy(np.asarray(M.Ax)), size=M.shape).to(dev)
            cusparse[label] = cuda_time_ms(lambda: Ms @ xt, iters=20)["median_ms"]
        return cusparse[label]

    def e2e(kind, label, M, x_np, sr, want):
        """One spmv(kind) call after a warm one: launches == want, y
        against the oracle; then ms per call."""
        xv = ring_x(x_np, sr)
        xt = torch.from_numpy(xv).to(dev)
        st.spmv(kind, M, xt, semiring=sr)  # plans built and uploaded
        torch.cuda.synchronize()
        reset()
        y = st.spmv(kind, M, xt, semiring=sr)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{kind} on {label}, {sr.name}: launches {c}, want {want}")
        check(y.shape == (M.n_rows,) and y.dtype == torch.float32,
              f"{kind} on {label}: y {tuple(y.shape)} {y.dtype}")
        y_np, want_y = y.cpu().numpy(), oracle(label, M, xv, sr)
        if sr is PLUS_TIMES:
            delta = correctness_delta(want_y, y_np)
            check(np.isfinite(y_np).all() and np.allclose(y_np, want_y, rtol=RTOL,
                                                          atol=ATOL),
                  f"{kind} on {label}: y outside rtol {RTOL} atol {ATOL} of the "
                  f"oracle (max_rel {delta['max_rel']:.3e})")
            how = f"within rtol {RTOL} atol {ATOL} of the oracle, max_rel " \
                  f"{delta['max_rel']:.3e}"
        else:
            check(np.array_equal(y_np, want_y),
                  f"{kind} on {label}, {sr.name}: differs from the semiring oracle")
            how = "equals the semiring oracle bit for bit"
        ms = cuda_time_ms(lambda: st.spmv(kind, M, xt, semiring=sr),
                          iters=10)["median_ms"]
        line = (f"{kind} on {label}, {sr.name}: {how}; launches {c}; {ms:.4f} ms/call "
                f"= {M.nnz / ms / 1e6:.3f} Gnnz/s")
        if sr is PLUS_TIMES:
            cs = cusparse_ms(label, M, xt)
            line += (f"; cuSPARSE (comparison only) {cs:.4f} ms = "
                     f"{M.nnz / cs / 1e6:.3f} Gnnz/s")
        print(f"{line} ({card})")
        return c

    ell_kinds = {"csr_vector_ell": "csr", "csr_vector_shfl_ell": "csr",
                 "csr_vector_shfl2_ell": "csr", "csr_scalar": "csr",
                 "light_vec_ell": "light_vec", "light_warp_ell": "light_warp"}
    direct = {"K9 pgather": 0, "K11 group_reduce": 0}
    for label, M, xm in mats:
        for sr in rings:
            for kind, key in ell_kinds.items():
                nb = len(plans[label][key])
                c = e2e(kind, label, M, xm, sr, {"K9 pgather": nb, "K11 group_reduce": nb})
                for k in direct:
                    direct[k] += c[k]
    launches.update(direct)

    # the plus-times row fold sums in float64 and rounds once: two calls
    # agree to within one float32 ulp per row (the float64 sum's order
    # still varies) and pass the oracle
    want_y = oracle("bench", A, x_np, PLUS_TIMES)
    for kind in ("csr_vector_ell", "xla"):
        y1, y2 = (st.spmv(kind, A, x).cpu().numpy() for _ in range(2))
        ulp = np.spacing(np.maximum(np.abs(y1), np.abs(y2)))
        n_diff = int((y1 != y2).sum())
        check(np.all(np.abs(y1 - y2) <= ulp),
              f"{kind} on bench: two calls differ by more than one ulp")
        delta = correctness_delta(want_y, y1)
        check(np.isfinite(y1).all() and np.allclose(y1, want_y, rtol=RTOL, atol=ATOL),
              f"{kind} on bench: outside rtol {RTOL} atol {ATOL} of the oracle "
              f"(max_rel {delta['max_rel']:.3e})")
        ms = cuda_time_ms(lambda: st.spmv(kind, A, x), iters=10)["median_ms"]
        print(f"{kind} on bench, plus_times, two calls: equal within one float32 ulp "
              f"per row ({n_diff} of {A.n_rows} rows differ at all); within rtol {RTOL} "
              f"atol {ATOL} of the oracle, max_rel {delta['max_rel']:.3e}; {ms:.4f} "
              f"ms/call ({card})")

    stream_kinds = {"csr_vector": (12288, "roll"), "csr_vector_shfl": (12288, "auto"),
                    "csr_vector_shfl2": (12288, "auto"), "light_vec": (None, "auto"),
                    "light_warp": (None, "auto")}
    A_kappa = {"light_vec": tlight._kappa_for(A, tlight.FINE_KAPPA),
               "light_warp": tlight._kappa_for(A, tlight.COARSE_KAPPA)}
    for kind, (kappa, strategy) in stream_kinds.items():
        kappa = kappa or A_kappa[kind]
        for sr in rings:
            st.spmv(kind, A, x, semiring=sr)  # builds the plan of this kappa
            plan = plan_cache(A, ts.plan_cache_key(ts.StreamPolicy(kappa=kappa)), None)
            check(plan.reduce is not None and "xr1" in plan.gather,
                  f"{kind} on bench: plan not on the reduction branch with the remap")
            diff = sr is PLUS_TIMES or sr is OR_AND  # or-and counts on K2/K6
            want = {"K1 xprep": 1, ("K2 reduce" if diff else "K7 reduce_roll"): 1,
                    "K5 split": len(plan.shuffle.passes),
                    ("K6 scan" if diff and strategy == "auto" else "K8 scan_roll"): 1}
            e2e(kind, "bench", A, x_np, sr, want)

    xp_np = np.random.default_rng(14).standard_normal(P.n_cols).astype(np.float32)
    for kind in ("dia", "csr_vector", "csr_vector_shfl", "csr_vector_shfl2"):
        for sr in rings:
            e2e(kind, "poisson2d", P, xp_np, sr, {"K12 dia": 1})
    print(f"end-to-end phases done at {time.perf_counter() - t_start:.1f} s")

    # 10. the slice's path: CG on poisson2d through csr_vector -> dia -> K12,
    # its chunks of CHUNK iterations replayed as one CUDA graph
    from spmv_tpu_torch import solvers

    b_np = np.random.default_rng(0).standard_normal(P.n_rows).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    cg = lambda: st.cg(P, b, rtol=1e-6, maxiter=10000, kind="csr_vector")
    t = time.perf_counter()
    cg()  # captures the chunk's graph, cached on P
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    xs, info, g = graphed_solve(P, "cg", None, cg, reset, counts)
    it, chunks, c = info["iters"], g["chunks"], g["launches"]
    check(info["converged"], f"cg did not converge: {info}")
    check(chunks == -(-it // solvers.CHUNK), f"cg: {chunks} chunks for {it} iterations")
    want = {"K12 dia": 1 + solvers.CHUNK * chunks}
    check(g["eager"] == {"K12 dia": 1} and g["per_chunk"] == {"K12 dia": solvers.CHUNK}
          and c == want, f"cg: launches {c} (eager {g['eager']}, per chunk's graph "
                         f"{g['per_chunk']}) over {it} iterations in {chunks} chunks, "
                         f"want {want} (K12 only)")
    xs_np = xs.cpu().numpy()
    check(xs_np.shape == (P.n_rows,) and np.isfinite(xs_np).all(), "cg: x not finite")
    rel = true_relative_residual(P, b_np, xs_np)
    check(rel <= 1e-3, f"cg: true relative residual {rel:.3e} > 1e-3")
    check(CG_ITERS[0] <= it <= CG_ITERS[1],
          f"cg: {it} iterations, outside {CG_ITERS[0]}-{CG_ITERS[1]}")
    k12 = results["K12 dia"]["device_ms"]
    solve_ms = g["ms"]
    print(f"cg on poisson2d({POISSON_M}) through csr_vector -> dia -> K12: converged in "
          f"{it} iterations, recursive resnorm {info['resnorm']:.3e}, true ||b - Ax|| / "
          f"||b|| {rel:.3e} (float64, host); {chunks} chunks of {solvers.CHUNK} replayed "
          f"as one CUDA graph, {chunks + 1} host reads; launches {c} = 1 eager (wrapper) "
          f"+ {g['per_chunk']['K12 dia']} kernel nodes of the chunk's graph x {chunks} "
          f"replays; solve {solve_ms:.1f} ms on the host clock = "
          f"{solve_ms / it:.4f} ms per iteration (the first solve, which captures the "
          f"graph, {first_ms:.1f} ms); K12 {k12:.4f} ms of device time per launch x "
          f"{it + 1} = {k12 * (it + 1) / solve_ms:.4f} of the solve; a masked iteration "
          f"past the stop {g['masked_ms']:.4f} ms (CUDA events over a replay on the "
          f"stopped state, x and k unchanged), {chunks * solvers.CHUNK - it} masked in "
          f"this solve, at most {solvers.CHUNK - 1} ({card})")
    launches["K12 dia"] = c["K12 dia"]
    print(f"direct phases done in {time.perf_counter() - t_start:.1f} s")


def merge_spmm_phases(dev, card, hold, launches, reset, counts, bench, wide, graph):
    """Phases 11-15: K10 against its plain version on bench's tuned
    (spare-row) and stock (masked-reduction) merge plans; `merge_tiled`
    end to end on bench and wide-row in four rings and through shortest
    paths on the graph; the merge kinds' fallback past the stream
    planner's reach; K13 and `spmm` on the arxiv-size graph; and
    `spmm(method="stream")` on a cut matrix. `bench` and `wide` are
    (label, A, x) of the stream phases' matrices, `graph` (label, G,
    SciPy's distances from vertex 0)."""
    import dataclasses

    import spmv_tpu_torch as st
    from scipy.sparse import csr_matrix

    from spmv_tpu_torch.examples.shortest_paths import sssp
    from spmv_tpu_torch.io.generate import power_law_csr, random_csr
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import pgather as tpg
    from spmv_tpu_torch.kernels import spmm as tspmm
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import PlanCapacityError, plan_cache
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    (_, A, x_np), (_, W, xw_np), (_, G, dijkstra_ref) = bench, wide, graph
    x = torch.from_numpy(x_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)

    def ring_x(x_np, sr):
        if sr is OR_AND:
            keep = np.random.default_rng(13).random(x_np.size) >= 0.7
            return np.where(keep, x_np, 0.0).astype(np.float32)
        if sr is MAX_TIMES:  # the ring of non-negative values
            return np.abs(x_np)
        return x_np

    def oracle(M, xv, sr):
        if sr is PLUS_TIMES:
            return st.spmv_ref(M, xv, y_dtype=np.float64)
        return st.spmv_ref_semiring(M, xv, sr)

    def cusparse(M):
        with warnings.catch_warnings():  # beta-state notices of torch.sparse
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.from_numpy(np.asarray(M.Ap, np.int64)),
                torch.from_numpy(np.asarray(M.Aj, np.int64)),
                torch.from_numpy(np.asarray(M.Ax)), size=M.shape).to(dev)

    # 11. the merge plans and K10 against its plain version on bench
    def merge_plan(M, label, pol):
        t = time.perf_counter()
        host = tm.build_merge_plan(M, pol)
        secs = time.perf_counter() - t
        plan_cache(M, ("merge", pol), lambda: host)
        S, P = pol.nnz_per_tile // 128, pol.rows_per_tile // 128
        sbt = 128 // S
        one_row = int(((host.r_start == host.lrow) & (host.cnt > 0)).sum())
        pgs = [None if g is None else (g.n_chunks, g.rounds)
               for g in (host.pgather, host.pgather_y)]
        print(f"{label} merge plan (EN {pol.nnz_per_tile}, RW {pol.rows_per_tile}): "
              f"{host.n_tiles} tiles in {host.n_tiles // sbt} groups of {sbt}, spare-row "
              f"branch {sbt * P + sbt <= 128}, {one_row} tiles inside one row; paged "
              f"gathers (chunks, rounds) phase A {pgs[0]}, phase C {pgs[1]}; built in "
              f"{secs:.3f} s (host)")
        return host, tm.device_merge_plan(M, pol, dev)

    lengths = torch.from_numpy(np.diff(np.asarray(A.Ap, np.int64))).to(dev)
    prod_csr = (torch.from_numpy(np.asarray(A.Ax)).to(dev)
                * x[torch.from_numpy(np.asarray(A.Aj, np.int64)).to(dev)])
    hosts = {}
    for pol, label in ((tm.TUNED_POLICY, "tuned"), (tm.STOCK_POLICY, "stock")):
        host, d = merge_plan(A, f"bench {label}", pol)
        hosts[pol] = host
        S, P = pol.nnz_per_tile // 128, pol.rows_per_tile // 128
        check(((128 // S) * P + 128 // S <= 128) == (label == "tuned"),
              f"bench {label} plan: not on the expected route branch")
        rest = (d.rel_tiles.view(-1, 128), d.pr1, d.pr2, d.pr3, d.r_start, d.lrow, d.cnt)

        def k10(prod, sr):
            return (lambda: tm._merge_group_pass(prod, *rest, sr=sr, S=S, P=P),
                    lambda: tm._merge_group_plain(prod, *rest, sr=sr, S=S, P=P))

        d_int = dataclasses.replace(d, ax_tiles=torch.randint(
            -4, 5, tuple(d.ax_tiles.shape), generator=gen, device=dev).float())
        x_int = torch.randint(-4, 5, (A.n_cols,), generator=gen, device=dev).float()
        prod = tm.merge_products(A, x, PLUS_TIMES, d)
        hold("K10 merge_group", *k10(prod, PLUS_TIMES), False,
             ints=k10(tm.merge_products(A, x_int, PLUS_TIMES, d_int), PLUS_TIMES),
             note=f" (bench {label} plan, plus_times)", reads=(prod,) + rest,
             # the scan's ring operations: per 4 products a lane, 3 in
             # the lane, 5 warp shuffle steps and 4 to apply its prefix
             ops=3 * prod.numel(),
             lib=lambda: torch.segment_reduce(prod_csr, "sum", lengths=lengths))
        for sr in (MIN_PLUS, MAX_TIMES, OR_AND):
            p = tm.merge_products(A, torch.from_numpy(ring_x(x_np, sr)).to(dev), sr, d)
            hold("K10 merge_group", *k10(p, sr), True,
                 note=f" (bench {label} plan, {sr.name})", time_it=sr is MIN_PLUS)
        # K9 on both of the plan's gathers: phase A's x read and phase C's
        # y assembly from K10's tile values
        y_tiles = tm._merge_group_pass(prod, *rest, sr=PLUS_TIMES, S=S, P=P).reshape(-1)
        for what, src, pg in (("x read", x, d.pgather),
                              ("y assembly", y_tiles, d.pgather_y)):
            check(pg is not None, f"bench {label} merge plan: no paged gather for {what}")
            args9 = (src, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
            kw9 = dict(C=pg.n_chunks, R=pg.rounds)
            hold("K9 pgather", lambda: tpg._pgather_pass(*args9, **kw9),
                 lambda: tpg._pgather_plain(*args9, **kw9), True,
                 note=f" (bench {label} merge plan, {what}, {pg.n_chunks} chunks x "
                      f"{pg.rounds} rounds)", time_it=False)
    print(f"K10 phases done at {time.perf_counter() - t_start:.1f} s")

    # 12. merge_tiled end to end on bench and wide-row, four rings
    def k9_per_call(host):
        return (host.pgather is not None) + (host.pgather_y is not None)

    hosts_w = merge_plan(W, "wide_row tuned", tm.TUNED_POLICY)[0]
    for label, M, xm_np, host in (("bench", A, x_np, hosts[tm.TUNED_POLICY]),
                                  ("wide_row", W, xw_np, hosts_w)):
        want = {"K10 merge_group": 1}
        if k9_per_call(host):
            want["K9 pgather"] = k9_per_call(host)
        Ms = cusparse(M)
        for sr in (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND):
            xv = ring_x(xm_np, sr)
            xt = torch.from_numpy(xv).to(dev)
            st.spmv("merge_tiled", M, xt, semiring=sr)
            torch.cuda.synchronize()
            reset()
            y = st.spmv("merge_tiled", M, xt, semiring=sr)
            torch.cuda.synchronize()
            c = counts()
            check(c == want, f"merge_tiled on {label}, {sr.name}: launches {c}, want {want}")
            y_np, ref = y.cpu().numpy(), oracle(M, xv, sr)
            if sr is PLUS_TIMES:
                delta = correctness_delta(ref, y_np)
                check(np.isfinite(y_np).all() and np.allclose(y_np, ref, rtol=RTOL, atol=ATOL),
                      f"merge_tiled on {label}: outside rtol {RTOL} atol {ATOL} of the "
                      f"oracle (max_rel {delta['max_rel']:.3e})")
                how = f"within rtol {RTOL} atol {ATOL} of the oracle, max_rel {delta['max_rel']:.3e}"
            else:
                check(np.array_equal(y_np, ref),
                      f"merge_tiled on {label}, {sr.name}: differs from the semiring oracle")
                how = "equals the semiring oracle bit for bit"
            ms = cuda_time_ms(lambda: st.spmv("merge_tiled", M, xt, semiring=sr),
                              iters=10)["median_ms"]
            line = (f"merge_tiled on {label}, {sr.name}: {how}; launches {c}; {ms:.4f} "
                    f"ms/call = {M.nnz / ms / 1e6:.3f} Gnnz/s")
            if sr is PLUS_TIMES:
                cs = cuda_time_ms(lambda: Ms @ xt, iters=10)["median_ms"]
                line += (f"; cuSPARSE (comparison only) {cs:.4f} ms = "
                         f"{M.nnz / cs / 1e6:.3f} Gnnz/s")
            print(f"{line} ({card})")
        del Ms
    print(f"merge_tiled end to end done at {time.perf_counter() - t_start:.1f} s")

    # 13. shortest paths through merge_tiled, to the fixed point
    host_g = merge_plan(G, "sssp graph tuned", tm.TUNED_POLICY)[0]
    n_checked = [0]

    def exact_relaxation(d, relaxed):
        want = st.spmv_ref_semiring(G, d.cpu().numpy(), MIN_PLUS)
        check(np.array_equal(relaxed.cpu().numpy(), want),
              f"merge_tiled sssp relaxation {n_checked[0] + 1} differs from the oracle")
        n_checked[0] += 1

    reset()
    d, iters = sssp(G, 0, kind="merge_tiled", device=dev, on_relax=exact_relaxation)
    torch.cuda.synchronize()
    run = counts()
    want = {"K10 merge_group": iters}
    if k9_per_call(host_g):
        want["K9 pgather"] = k9_per_call(host_g) * iters
    check(run == want, f"merge_tiled sssp: launches {run} over {iters} relaxations")
    launches["K10 merge_group"] = run["K10 merge_group"]
    d_np = d.cpu().numpy()
    reach = np.isfinite(dijkstra_ref)
    check(np.array_equal(np.isfinite(d_np), reach), "merge_tiled sssp: reachable sets differ")
    err = float(np.abs(d_np[reach].astype(np.float64) - dijkstra_ref[reach]).max())
    check(err <= 1e-4, f"merge_tiled sssp: max |d - dijkstra| {err:.3e} > 1e-4")
    t_rel = cuda_time_ms(lambda: st.spmv("merge_tiled", G, d, semiring=MIN_PLUS),
                         iters=10)["median_ms"]
    print(f"sssp through merge_tiled on the graph: {iters} relaxations to the fixed point, "
          f"each equal to the semiring oracle; max |d - scipy dijkstra (float64)| "
          f"{err:.3e}; launches over the run {run}; one relaxation {t_rel:.4f} ms = "
          f"{G.nnz / t_rel / 1e6:.3f} Gnnz/s ({card})")

    # 14. the merge kinds' fallback past the stream planner's reach: the
    # planner is made to refuse bench (a fresh CSR of the same arrays, so
    # no stream plan is cached); the merge plans are bench's
    A2 = st.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, A.Ax)
    for pol, host in hosts.items():
        plan_cache(A2, ("merge", pol), lambda host=host: host)
    ref = st.spmv_ref(A, x_np, y_dtype=np.float64)
    build = ts.build_stream_plan

    def refuse(M, policy):
        raise PlanCapacityError("stream planner refused for the fallback check")

    ts.build_stream_plan = refuse
    try:
        for kind, pol in (("merge", tm.TUNED_POLICY), ("merge_stock", tm.STOCK_POLICY),
                          ("merge_genl", tm.TUNED_POLICY)):
            reset()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                y = st.spmv(kind, A2, x)
                torch.cuda.synchronize()
            c = counts()
            want = {"K10 merge_group": 1, "K9 pgather": k9_per_call(hosts[pol])}
            check(any(issubclass(w.category, st.FallbackWarning) for w in caught),
                  f"{kind} fallback: no FallbackWarning")
            check(c == want, f"{kind} fallback: launches {c}, want {want}")
            direct = tm._merge_impl(A, x, PLUS_TIMES, pol)
            check(torch.equal(y, direct), f"{kind} fallback differs from the tiled path")
            check(np.allclose(y.cpu().numpy(), ref, rtol=RTOL, atol=ATOL),
                  f"{kind} fallback: outside rtol {RTOL} atol {ATOL} of the oracle")
            print(f"{kind} past the planner's reach (refused on purpose): FallbackWarning, "
                  f"launches {c} ({'stock' if pol is tm.STOCK_POLICY else 'tuned'} policy), "
                  f"equal to the tiled path and within rtol {RTOL} atol {ATOL} of the oracle")
    finally:
        ts.build_stream_plan = build
    print(f"merge phases done at {time.perf_counter() - t_start:.1f} s")

    # 15. K13 and spmm on the arxiv-size graph; spmm stream on a cut matrix
    t = time.perf_counter()
    Gx = power_law_csr(ARXIV[0], ARXIV[0], ARXIV[1], alpha=1.5, seed=0)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    wplan = tspmm._plan_spmm_window(Gx)
    plan_cache(Gx, "spmm_window", lambda: wplan)
    dw = tspmm.device_window_plan(Gx, np.dtype(np.float32), dev)
    print(f"arxiv-size power_law_csr({ARXIV[0]}, {ARXIV[0]}, {ARXIV[1]}, alpha 1.5, "
          f"seed 0): generated in {gen_s:.3f} s; window plan {wplan['n_tiles']} tiles, "
          f"P {wplan['n_tiles'] * 128 * 128 * 4 / 1e6:.1f} MB per 128-column block, "
          f"built and uploaded in {time.perf_counter() - t:.3f} s (host)")
    rng = np.random.default_rng(15)
    Xblk = torch.nn.functional.pad(torch.from_numpy(rng.standard_normal(
        (Gx.n_cols, 128)).astype(np.float32)).to(dev), (0, 0, 0, dw["rows_pad"] - Gx.n_cols))
    cols = (dw["xb"].long()[:, None] * 128 + dw["q"].long()).reshape(-1)
    args13 = (Xblk, dw["ax"], dw["q"], dw["xb"])
    for sr in (PLUS_TIMES, MIN_PLUS):
        hold("K13 spmm_window", lambda: tspmm._spmm_window_pass(*args13, sr=sr),
             lambda: tspmm._spmm_window_plain(*args13, sr=sr), True,
             note=f" (arxiv-size, B 128, {sr.name})", reads=args13,
             lib=lambda: Xblk.index_select(0, cols), cold=sr is PLUS_TIMES)
    Ms = cusparse(Gx)
    Gs = csr_matrix((np.asarray(Gx.Ax, np.float64), np.asarray(Gx.Aj),
                     np.asarray(Gx.Ap)), shape=Gx.shape)
    k13 = 0
    for B in (128, 256, 40):
        Xn = rng.standard_normal((Gx.n_cols, B)).astype(np.float32)
        Xt = torch.from_numpy(Xn).to(dev)
        refs = {PLUS_TIMES: Gs @ Xn.astype(np.float64),
                MIN_PLUS: st.spmv_ref_semiring(Gx, Xn, MIN_PLUS)}
        for method in ("window", "xla"):
            want = {"K13 spmm_window": -(-B // 128)} if method == "window" else {}
            for sr in (PLUS_TIMES, MIN_PLUS):
                st.spmm(Gx, Xt, semiring=sr, method=method)
                torch.cuda.synchronize()
                reset()
                Y = st.spmm(Gx, Xt, semiring=sr, method=method)
                torch.cuda.synchronize()
                c = counts()
                check(c == want, f"spmm {method} B {B} {sr.name}: launches {c}, want {want}")
                k13 += c.get("K13 spmm_window", 0)
                Y_np = Y.cpu().numpy()
                check(Y_np.shape == (Gx.n_rows, B), f"spmm {method} B {B}: shape {Y_np.shape}")
                if sr is PLUS_TIMES:
                    delta = correctness_delta(refs[sr], Y_np)
                    check(np.isfinite(Y_np).all() and np.allclose(Y_np, refs[sr], rtol=RTOL,
                                                                  atol=1e-4),
                          f"spmm {method} B {B}: outside rtol {RTOL} atol 1e-4 of the "
                          f"float64 oracle (max_rel {delta['max_rel']:.3e})")
                    how = f"within rtol {RTOL} atol 1e-4, max_rel {delta['max_rel']:.3e}"
                else:
                    check(np.array_equal(Y_np, refs[sr]),
                          f"spmm {method} B {B} min_plus: differs from the semiring oracle")
                    how = "equals the semiring oracle bit for bit"
                ms = cuda_time_ms(lambda: st.spmm(Gx, Xt, semiring=sr, method=method),
                                  iters=10)["median_ms"]
                print(f"spmm {method} on arxiv-size, B {B}, {sr.name}: {how}; launches {c}; "
                      f"{ms:.4f} ms/call = {Gx.nnz * B / ms / 1e6:.3f} G products/s ({card})")
        cs = cuda_time_ms(lambda: Ms @ Xt, iters=10)["median_ms"]
        print(f"torch.sparse.mm (cuSPARSE, comparison only) on arxiv-size, B {B}: {cs:.4f} "
              f"ms ({card})")
    launches["K13 spmm_window"] = k13

    R16 = random_csr(*SPMM_STREAM, seed=5)
    Xn = np.random.default_rng(16).standard_normal((R16.n_cols, 128)).astype(np.float32)
    Xt = torch.from_numpy(Xn).to(dev)
    t = time.perf_counter()
    st.spmm(R16, Xt, method="stream")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    reset()
    Y = st.spmm(R16, Xt, method="stream")
    torch.cuda.synchronize()
    c = counts()
    check(c and "K13 spmm_window" not in c, f"spmm stream: launches {c}")
    ref = R16.to_dense().astype(np.float64) @ Xn.astype(np.float64)
    check(np.allclose(Y.cpu().numpy(), ref, rtol=RTOL, atol=1e-4),
          "spmm stream: outside rtol 2e-4 atol 1e-4 of the float64 oracle")
    ms = cuda_time_ms(lambda: st.spmm(R16, Xt, method="stream"), iters=10)["median_ms"]
    print(f"spmm stream on random_csr{SPMM_STREAM} (cut: the Kronecker expansion's plan "
          f"grows 128x with nnz), B 128: within rtol {RTOL} atol 1e-4 of the float64 "
          f"oracle; launches {c}; first call {first_s:.3f} s (expansion and plan on the "
          f"host); {ms:.4f} ms/call ({card})")
    print(f"merge and spmm phases done in {time.perf_counter() - t_start:.1f} s")


def dist_phases(dev, card, hold, launches, reset, counts, bench, graph, out_dir):
    """Phases 16-20, the multi-device layer on local meshes of 1, 2 and 4
    shards on the card (and a process-group mesh of one rank): K11'
    against its plain version on bench's stacked blocks; `distribute_csr`
    on bench and the graph in four rings and both exchange modes;
    `distribute_stream` on bench; the NCCL process-group mesh against the
    local one; the weak-scaling bench. `bench` and `graph` are (label, A,
    x) of the stream phases' matrices; `out_dir` holds the NCCL
    rendezvous file."""
    import torch.distributed as tdist

    import spmv_tpu_torch as st
    from spmv_tpu_torch.bench import weak_scaling
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.parallel import (distribute_csr, distribute_stream,
                                         init_distributed, make_mesh)
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.parallel import dist_spmv as tds
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    rings = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
    (_, A, x_np), (_, G, xg_np) = bench, graph
    mats = {"bench": (A, x_np), "sssp graph": (G, xg_np)}

    def ring_x(xv, sr):
        if sr is OR_AND:
            keep = np.random.default_rng(13).random(xv.size) >= 0.7
            return np.where(keep, xv, 0.0).astype(np.float32)
        if sr is MAX_TIMES:  # the ring of non-negative values
            return np.abs(xv)
        return xv

    oracles = {}

    def judge(what, y, label, xv, sr):
        """y against the oracle of (label, ring): plus-times within rtol
        and atol of float64, the other rings bit for bit."""
        M = mats[label][0]
        key = (label, sr.name)
        if key not in oracles:
            oracles[key] = (st.spmv_ref(M, xv, y_dtype=np.float64) if sr is PLUS_TIMES
                            else st.spmv_ref_semiring(M, xv, sr))
        want, y_np = oracles[key], y.cpu().numpy()
        check(y_np.shape == (M.n_rows,) and y.dtype == torch.float32,
              f"{what}: y {y_np.shape} {y.dtype}")
        if sr is PLUS_TIMES:
            delta = correctness_delta(want, y_np)
            check(np.isfinite(y_np).all() and np.allclose(y_np, want, rtol=RTOL, atol=ATOL),
                  f"{what}: outside rtol {RTOL} atol {ATOL} of the oracle (max_rel "
                  f"{delta['max_rel']:.3e})")
            return f"within rtol {RTOL} atol {ATOL} of the oracle, max_rel {delta['max_rel']:.3e}"
        check(np.array_equal(y_np, want), f"{what}: differs from the semiring oracle")
        return "equals the semiring oracle bit for bit"

    dists = {}

    def hold_shard_k2(D, u):
        """K2's second row: shard 0's call of a 4-shard distribute_stream
        matvec (fewer gather tiles than SMs, so split_grid splits each
        tile's rows over several CTAs) on bench's x, with the inputs the
        matvec gives it; integer-valued Ax and x table of the same shapes
        for the bit-for-bit check."""
        args = D.reduce_inputs(torch.from_numpy(x_np).to(dev), 0)[:7]
        kw = dict(sr=PLUS_TIMES, n_tiles=u.pad_tiles, Qp=u.Qp, out_rows=u.out_rows)
        gen = torch.Generator(device=dev).manual_seed(3)
        iargs = tuple(torch.randint(-4, 5, tuple(a.shape), generator=gen, device=dev).float()
                      for a in args[:2]) + args[2:]
        hold("K2 reduce", lambda: ts._reduce_diff_pass(*args, **kw),
             lambda: ts._reduce_diff_plain(*args, **kw), False,
             ints=(lambda: ts._reduce_diff_pass(*iargs, **kw),
                   lambda: ts._reduce_diff_plain(*iargs, **kw)),
             note=f" (bench, shard 0 of 4 of distribute_stream, {u.pad_tiles} gather "
                  f"tiles, Qp {u.Qp})", reads=k2_reads(args, u.Qp))

    def hold_shard_k7(D, u):
        """K7's second row: the same shard's call in min-plus (80 gather
        tiles, fewer than the SMs; K7 takes one CTA per tile)."""
        args = D.reduce_inputs(torch.from_numpy(x_np).to(dev), 0)
        kw = dict(sr=MIN_PLUS, n_tiles=u.pad_tiles, Qp=u.Qp, out_rows=u.out_rows)
        hold("K7 reduce_roll", lambda: ts._reduce_roll_pass(*args, **kw),
             lambda: ts._reduce_roll_plain(*args, **kw), True,
             note=f" (bench, shard 0 of 4 of distribute_stream, {u.pad_tiles} gather "
                  f"tiles, Qp {u.Qp}, min_plus)", reads=k7_reads(args, u.Qp), cold=True)

    def csr_dist(label, n):
        if (label, n) not in dists:
            t = time.perf_counter()
            d = distribute_csr(mats[label][0], make_mesh("shards", n_shards=n, device=dev))
            torch.cuda.synchronize()
            p, s, h = d.plan, d.dev["self"], d.dev["halo"]
            print(f"{label} distribute_csr over {n} local shards: host plan and upload "
                  f"{time.perf_counter() - t:.3f} s; R {p.R}, R_out {p.R_out}, halo slots M "
                  f"{p.M}, self block W {s['W']} x {s['Tv']} tiles, halo block W {h['W']} x "
                  f"{h['Tv']} tiles per shard, {int(p.export_flag.sum())} shards export a "
                  f"split row")
            dists[label, n] = d
        return dists[label, n]

    def calls(what, label, run, want, sr, xv):
        """One call after a warm one: launches == want, y judged against
        the oracle of matrix `label`; then ms per call. Returns (verdict,
        launches, ms)."""
        run()
        torch.cuda.synchronize()
        reset()
        y = run()
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{what}: launches {c}, want {want}")
        return judge(what, y, label, xv, sr), c, cuda_time_ms(run, iters=10)["median_ms"]

    def stream_want(n, npass, sr):
        if sr is PLUS_TIMES:
            return {"K2 reduce": n, "K5 split": n * npass, "K6 scan": n}
        return {"K7 reduce_roll": n, "K5 split": n * npass, "K8 scan_roll": n}

    # 16. K11' against its plain version on bench's stacked blocks, 4 shards
    d4 = csr_dist("bench", 4)
    for blk in ("self", "halo"):
        b = d4.dev[blk]
        for sr in rings:
            xs = d4.shard_x(torch.from_numpy(ring_x(x_np, sr)).to(dev))
            xsrc = xs if blk == "self" else d4.x_table(xs)
            ax = b["ax"].abs() if sr is MAX_TIMES else b["ax"]
            args = (b["aj"], ax, b["valid"], xsrc)
            # what the kernel must move: the valid mask (1 B a slot), aj and
            # ax of the valid slots only, each distinct x entry they reference
            # once; the leaders written. Ops: one combine per valid slot, one
            # reduce per slot that is not a leader.
            v, L = b["valid"], b["valid"].shape[0]
            n_valid = int(v.sum())
            n_x = int(torch.unique((torch.arange(L, device=dev).view(L, 1, 1, 1)
                                    * xsrc.shape[1] + b["aj"].long())[v]).numel())
            n_out = L * b["Tv"] * 8 * (128 // b["W"])
            out = hold("K11' local_ell",
                       lambda: tds._local_ell_pass(*args, W=b["W"], sr=sr),
                       lambda: tds._local_ell_plain(*args, W=b["W"], sr=sr), True,
                       note=f" (bench, 4 local shards, {blk} block, W {b['W']}, {b['Tv']} "
                            f"tiles per shard, {sr.name})",
                       reads=(v,), extra_bytes=8 * n_valid + 4 * n_x,
                       ops=n_valid + v.numel() - n_out,
                       # as a matvec meets K11': the exchange and the float64
                       # row fold between its launches evict its blocks and x
                       cold=sr is PLUS_TIMES)
            if sr is PLUS_TIMES:
                # where a cold launch's time goes: the plan stream alone (no
                # slot valid, so no x read), and with x read into L2 first
                none = torch.zeros_like(v)
                t_plan = flushed_ms(lambda: tds._local_ell_pass(b["aj"], ax, none, xsrc,
                                                                W=b["W"], sr=sr), dev)
                t_xl2 = flushed_ms(lambda: tds._local_ell_pass(*args, W=b["W"], sr=sr), dev,
                                   before=lambda: xsrc.sum())
                print(f"K11' {blk} block, plus_times, L2 flushed: {t_plan:.4f} ms with no "
                      f"slot valid (the plan stream alone, no x read), {t_xl2:.4f} ms with x "
                      f"read back into L2 first; its {n_valid} x reads are random 4-byte "
                      f"reads, each of a 32-byte sector ({32 * n_valid / 1e6:.1f} MB of "
                      f"sectors) ({card})")
        moved = tensor_bytes(v, out) + 8 * n_valid + 4 * n_x
        # the kernel reads aj and ax of every slot, padding included
        read = tensor_bytes(b["aj"], b["ax"], v, out) + 4 * n_x
        print(f"K11' {blk} block: one launch covers 4 shards x {b['Tv']} tiles, "
              f"{n_valid} of {v.numel()} slots valid, {n_x} distinct x entries; bound "
              f"{bound_of(moved, n_valid + v.numel() - n_out)[0]:.4f} ms "
              f"({moved / 1e6:.1f} MB: the valid mask, aj and ax of the valid slots and "
              f"each distinct x entry read once, the leaders written once, at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s); the kernel reads aj and ax of every "
              f"slot: {read / 1e6:.1f} MB, {bound_of(read, 0)[0]:.4f} ms at that rate")
    print(f"K11' phase done at {time.perf_counter() - t_start:.1f} s")

    # 17. distribute_csr on local meshes of 1, 2 and 4 shards, both modes
    k11p = 0
    for label in ("bench", "sssp graph"):
        M, xm = mats[label]
        for n in (1, 2, 4):
            d = csr_dist(label, n)
            for mode in ("halo", "allgather"):
                for sr in rings:
                    xv = ring_x(xm, sr)
                    xt = torch.from_numpy(xv).to(dev)
                    how, c, ms = calls(f"distribute_csr on {label}, {n} shards, {mode}, "
                                       f"{sr.name}", label,
                                       lambda: d.matvec(xt, semiring=sr, mode=mode),
                                       {"K11' local_ell": 2}, sr, xv)
                    k11p += c["K11' local_ell"]
                    print(f"distribute_csr on {label}, {n} local shards, {mode}, {sr.name}: "
                          f"{how}; launches {c}; {ms:.4f} ms/call = {M.nnz / ms / 1e6:.3f} "
                          f"Gnnz/s; exchange {d.comm_bytes_per_shard} B per shard (halo) vs "
                          f"{d.allgather_bytes_per_shard} B (allgather) ({card})")
    launches["K11' local_ell"] = k11p
    print(f"K11' launches over the distribute_csr phase: {k11p} (2 per call, 48 calls)")
    print(f"distribute_csr phase done at {time.perf_counter() - t_start:.1f} s")

    # 18. distribute_stream on local meshes of 2 and 4 shards on bench
    for n in (2, 4):
        t = time.perf_counter()
        try:
            D = distribute_stream(A, make_mesh("shards", n_shards=n, device=dev))
        except PlanCapacityError as e:
            fail(f"distribute_stream: the planner refused bench at {n} shards ({e})")
        torch.cuda.synchronize()
        u, npass = D.uni, len(D.uni.split_meta)
        print(f"bench distribute_stream over {n} local shards: host plans and upload "
              f"{time.perf_counter() - t:.3f} s; per shard {u.pad_tiles} gather tiles, "
              f"{u.F_pad} final tiles, {npass} shuffle passes, {u.n_aug} hot-page rows")
        if n == 4:
            hold_shard_k2(D, u)
            hold_shard_k7(D, u)
        for sr in (PLUS_TIMES, MIN_PLUS):
            xt = torch.from_numpy(x_np).to(dev)
            how, c, ms = calls(f"distribute_stream on bench, {n} shards, {sr.name}",
                               "bench", lambda: D.matvec(xt, semiring=sr),
                               stream_want(n, npass, sr), sr, x_np)
            print(f"distribute_stream on bench, {n} local shards, {sr.name}: {how}; "
                  f"launches {c}; {ms:.4f} ms/call = {A.nnz / ms / 1e6:.3f} Gnnz/s; "
                  f"exchange {D.comm_bytes_per_shard} B per shard ({card})")
    print(f"distribute_stream phase done at {time.perf_counter() - t_start:.1f} s")

    # 19. the process-group mesh at world size 1 through NCCL
    rdv = os.path.join(out_dir, "nccl_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    check(init_distributed(init_method=f"file://{rdv}", world_size=1, rank=0,
                           backend="nccl") == 1, "init_distributed: world size not 1")
    try:
        pg = make_mesh("shards", distributed=True)
        check(pg.distributed and pg.n_shards == 1 and pg.device.type == "cuda"
              and tdist.get_backend() == "nccl", f"process-group mesh {pg}")
        local1 = make_mesh("shards", n_shards=1, device=dev)
        for name, build, modes in (("distribute_csr", distribute_csr, ("halo", "allgather")),
                                   ("distribute_stream", distribute_stream, (None,))):
            dp, dl = build(A, pg), build(A, local1)
            for mode in modes:
                kw = {} if mode is None else {"mode": mode}
                for sr in (PLUS_TIMES, MIN_PLUS):
                    xt = torch.from_numpy(x_np).to(dev)
                    yl = dl.matvec(xt, semiring=sr, **kw)
                    want = ({"K11' local_ell": 2} if build is distribute_csr
                            else stream_want(1, len(dl.uni.split_meta), sr))
                    how, c, ms = calls(f"{name} on bench, process group, {sr.name}",
                                       "bench", lambda: dp.matvec(xt, semiring=sr, **kw),
                                       want, sr, x_np)
                    yp = dp.matvec(xt, semiring=sr, **kw)
                    torch.cuda.synchronize()
                    if sr is MIN_PLUS:
                        check(torch.equal(yp, yl), f"{name} {sr.name}: process-group y "
                                                   f"differs from the local mesh's")
                    print(f"{name} on bench, NCCL process group of 1 rank"
                          f"{'' if mode is None else ', ' + mode}, {sr.name}: {how}"
                          f"{'; equal to the 1-shard local mesh bit for bit' if sr is MIN_PLUS else ''}"
                          f"; launches {c}; {ms:.4f} ms/call ({card})")
    finally:
        tdist.destroy_process_group()
    print(f"process-group phase done at {time.perf_counter() - t_start:.1f} s")

    # 20. the weak-scaling bench at its defaults, on local meshes
    # the kernels each impl must run: a stream shard the planner refused
    # would fall back to distribute_csr and launch K11'
    kinds = {"stream": ({"K2 reduce", "K6 scan"}, {"K2 reduce", "K5 split", "K6 scan"}),
             "ell": ({"K11' local_ell"}, {"K11' local_ell"})}
    for impl in ("stream", "ell"):
        t = time.perf_counter()
        reset()
        out = weak_scaling.main(["--devices", "1", "2", "4", "--impl", impl])
        c = counts()
        check([r["n_devices"] for r in out] == [1, 2, 4]
              and all(r["time_s"] > 0 and np.isfinite(r["time_s"]) for r in out),
              f"weak_scaling --impl {impl}: {out}")
        need, allowed = kinds[impl]
        check(need <= set(c) <= allowed,
              f"weak_scaling --impl {impl}: launches {c}, want {sorted(need)} and none "
              f"outside {sorted(allowed)}")
        print(f"weak_scaling --impl {impl}: launches {c}")
        print(f"weak_scaling --impl {impl} (65536 rows and 524288 nnz per shard, 1 2 4 "
              f"shards on one card, shards run one after another): "
              f"{time.perf_counter() - t:.1f} s with plan builds ({card})")
    print(f"dist phases done in {time.perf_counter() - t_start:.1f} s")


def harness_phases(card, out_dir):
    """Phase 21, the bench path: `python -m spmv_tpu_torch.bench.harness`
    (its `main`) on the card on a synthetic power-law matrix of bench's
    size, then on a poisson2d(HARNESS_MTX_M) written to a .mtx file and
    read back by the native parser; every kind asked for must be in the
    results and within the gate (rtol 2e-4, atol 1e-5 of the float64
    oracle, finite); each result's row is printed."""
    from spmv_tpu_torch import native
    from spmv_tpu_torch.bench import harness
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.io.matrix_market import read_matrix_market, write_matrix_market
    from spmv_tpu_torch.utils.timing import timing_of

    def run(argv, kinds):
        t = time.perf_counter()
        res = harness.main(argv)
        check([r.kind for r in res] == kinds,
              f"harness {argv}: results for {[r.kind for r in res]}, want {kinds}")
        for r in res:
            print(f"{r.row()}  [{timing_of(r.kind, 'cuda')}]")
            check(r.delta is not None and r.delta["within_gate"],
                  f"harness {argv}: {r.kind} outside rtol {RTOL} atol {ATOL} of the "
                  f"float64 oracle ({r.delta})")
        print(f"harness {' '.join(argv)}: every kind within rtol "
              f"{RTOL} atol {ATOL} of the float64 oracle; {time.perf_counter() - t:.1f} s "
              f"with plan builds ({card})")

    kinds = ["stream", "merge", "csr_vector", "xla"]
    run(["--synthetic", "powerlaw", "--rows", "1048576", "--nnz", "3300000",
         "--iters", "20", "--json", *kinds], kinds)
    P = poisson2d(HARNESS_MTX_M)
    path = os.path.join(out_dir, f"poisson2d_{HARNESS_MTX_M}.mtx")
    write_matrix_market(path, P)
    check(native.available(), "the native host library did not build")
    a = read_matrix_market(path, as_csr=True)
    b = read_matrix_market(path, as_csr=True, use_native=False)
    check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("Ap", "Aj", "Ax"))
          and all(np.array_equal(getattr(a, f), getattr(P, f)) for f in ("Ap", "Aj", "Ax")),
          f"{path}: the native parse differs from the Python parse or the matrix written")
    print(f"{path}: {P.nnz} nnz, written, then read by the native parser equal to the "
          f"Python parser's arrays and to the matrix written")
    kinds = ["stream", "csr_vector", "dia", "xla"]
    run([path, *kinds, "--iters", "20", "--json"], kinds)


def _minplus_rows(A, B, rows):
    """The NumPy semiring oracle of (A (min.+) B) on the given rows:
    (row position in `rows`, column, value), sorted by both, each value
    the float32 minimum of float32 sums a_ik + b_kj."""
    Ap, Aj, Ax = (np.asarray(A.Ap, np.int64), np.asarray(A.Aj, np.int64),
                  np.asarray(A.Ax, np.float32))
    Bp, Bj, Bx = (np.asarray(B.Ap, np.int64), np.asarray(B.Aj, np.int64),
                  np.asarray(B.Ax, np.float32))
    e = np.concatenate([np.arange(Ap[i], Ap[i + 1]) for i in rows])
    ri = np.repeat(np.arange(len(rows)), Ap[rows + 1] - Ap[rows])
    k = Aj[e]
    lens = Bp[k + 1] - Bp[k]
    te = np.repeat(np.arange(e.size), lens)
    p = Bp[k][te] + np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    r, j, v = ri[te], Bj[p], Ax[e][te] + Bx[p]
    order = np.lexsort((j, r))
    r, j, v = r[order], j[order], v[order]
    new = np.ones(r.size, bool)
    new[1:] = (r[1:] != r[:-1]) | (j[1:] != j[:-1])
    return r[new], j[new], np.minimum.reduceat(v, np.flatnonzero(new))


def surface_phases(dev, card, reset, counts, launches, G, R):
    """Phases 22-28, the slice of the public surface that runs on the
    stream kinds: spgemm (min-plus on the sssp graph, plus-times on random
    4.2M), SparseOperator and spmv_values on the arxiv-size graph, ILU(0)
    and its apply on poisson2d(ILU_M), CG with M="ilu0" on
    poisson2d(CG_ILU_M), PageRank and BFS at GRAPH_EX's size. Each path
    runs with the launch counts set to 0 just before it and read just
    after; each is gated by its oracle."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    import spmv_tpu_torch as st
    from spmv_tpu_torch import native
    from spmv_tpu_torch.examples import bfs as ex_bfs
    from spmv_tpu_torch.examples import pagerank as ex_pr
    from spmv_tpu_torch.examples.solve_poisson import poisson2d, true_relative_residual
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import spgemm as tsp
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.ops.autodiff import SparseOperator, spmv_values
    from spmv_tpu_torch.ops.registry import as_input, plan_cache
    from spmv_tpu_torch.ops.semiring import MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.utils.timing import capture_graph, cuda_time_ms

    stream_kernels = ("K2 reduce", "K3 gather_split", "K4 gather", "K7 reduce_roll")
    scan_kernels = ("K6 scan", "K8 scan_roll")

    def counted(fn):
        torch.cuda.synchronize()
        reset()
        out = fn()
        torch.cuda.synchronize()
        return out, counts()

    def ran_stream(c, what):
        check(any(c.get(k, 0) for k in stream_kernels) and any(c.get(k, 0) for k in scan_kernels),
              f"{what}: no stream kernels launched ({c})")

    def to_scipy(M):  # copies: SciPy sums duplicates in place, through shared arrays
        return sp.csr_matrix((np.array(M.Ax, np.float64), np.array(M.Aj),
                              np.array(M.Ap)), shape=M.shape)

    def ms(fn, iters=10):
        return cuda_time_ms(fn, iters=iters, warmup=1)["median_ms"]

    # 22-23. spgemm: min-plus G (x) G (one APSP relaxation: two-hop
    # distances), plus-times R (x) R
    check(native.available(), "the native host library did not build")
    for label, M, sr in (("sssp graph G (x) G, min_plus", G, MIN_PLUS),
                         ("random 4.2M R (x) R, plus_times", R, PLUS_TIMES)):
        t = time.perf_counter()
        sym = tsp._spgemm_symbolic(M, M)
        t_nat = time.perf_counter() - t
        saved = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            t = time.perf_counter()
            sym_np = tsp._spgemm_symbolic(M, M)
            t_np = time.perf_counter() - t
        finally:
            native._lib, native._tried = saved
        check(all(np.array_equal(sym[k], sym_np[k]) for k in
                  ("Cp", "Cj", "v_ap", "srcA", "srcB")),
              f"spgemm {label}: the native and NumPy symbolic phases differ")
        del sym, sym_np
        V = tsp._plan(M, M)["V"]
        t = time.perf_counter()
        plan = ts.build_stream_plan(V, tsp._POLICY)
        t_plan = time.perf_counter() - t
        plan_cache(V, ts.plan_cache_key(tsp._POLICY), lambda: plan)
        print(f"spgemm {label}: {V.nnz} triples, nnz(C) {V.n_rows}; symbolic "
              f"{t_nat:.3f} s native, {t_np:.3f} s NumPy (equal arrays); stream plan "
              f"of the virtual CSR: {plan.n_gather_tiles} gather tiles, "
              f"{plan.n_final_tiles} final tiles, reduce {plan.reduce is not None}, "
              f"passes {len(plan.shuffle.passes)}, built in {t_plan:.3f} s on the host")
        del plan
        run = lambda m: tsp.spgemm(M, M, semiring=sr, method=m, device=dev)
        tsp.spgemm(M, M, semiring=sr, method="stream", device=dev)  # uploads the plan
        Cs, c_s = counted(lambda: run("stream"))
        ran_stream(c_s, f"spgemm {label} stream")
        Ca, c_a = counted(lambda: run("auto"))
        check(c_a == c_s, f"spgemm {label}: auto launched {c_a}, not the stream plan's {c_s}")
        Cx, c_x = counted(lambda: run("xla"))
        check(c_x == {}, f"spgemm {label}: xla launched {c_x}")
        check(np.array_equal(Cs.Ap, Cx.Ap) and np.array_equal(Cs.Aj, Cx.Aj)
              and np.array_equal(Cs.Ax, Ca.Ax) and np.isfinite(Cs.Ax).all(),
              f"spgemm {label}: stream, auto and xla disagree in pattern or stream/auto values")
        S = to_scipy(M)
        Sp = (abs(S) @ abs(S)).sorted_indices() if sr is MIN_PLUS else (S @ S).sorted_indices()
        check(np.array_equal(Cs.Ap, Sp.indptr) and np.array_equal(Cs.Aj, Sp.indices),
              f"spgemm {label}: C's pattern differs from SciPy's A @ A")
        if sr is MIN_PLUS:
            check(np.array_equal(Cs.Ax, Cx.Ax), f"spgemm {label}: stream != xla bit for bit")
            rows = np.sort(np.random.default_rng(0).choice(M.n_rows, SPGEMM_SAMPLE,
                                                           replace=False))
            r_o, j_o, v_o = _minplus_rows(M, M, rows)
            ks = np.concatenate([np.arange(Cs.Ap[i], Cs.Ap[i + 1]) for i in rows])
            check(np.array_equal(j_o, Cs.Aj[ks]) and np.array_equal(v_o, Cs.Ax[ks]),
                  f"spgemm {label}: differs from the NumPy semiring oracle on "
                  f"{SPGEMM_SAMPLE} sampled rows")
            gate = (f"stream == auto == xla bit for bit, and == the NumPy semiring oracle "
                    f"on {SPGEMM_SAMPLE} sampled rows ({ks.size} entries)")
        else:
            err = float(np.abs(Cs.Ax - Sp.data).max())
            check(np.allclose(Cs.Ax, Sp.data, rtol=2e-4, atol=1e-4)
                  and np.allclose(Cx.Ax, Sp.data, rtol=2e-4, atol=1e-4),
                  f"spgemm {label}: outside rtol 2e-4 atol 1e-4 of SciPy (float64), "
                  f"max |diff| {err:.3e}")
            gate = (f"stream, auto and xla within rtol 2e-4 atol 1e-4 of SciPy's A @ A "
                    f"in float64 (stream max |diff| {err:.3e})")
        Bx = as_input(np.asarray(M.Ax), dev)
        t_ns = ms(lambda: tsp._numeric_stream(V, Bx, sr))
        t_nx = ms(lambda: tsp._numeric_xla(V, Bx, sr))
        t_s, t_a, t_x = (ms(lambda: run(m), iters=5) for m in ("stream", "auto", "xla"))
        print(f"spgemm {label}: {gate}; launches of a stream call {c_s}, of an auto "
              f"call {c_a}, of an xla call {c_x or 'none of the hand-written kernels'}; "
              f"numeric phase alone (B's values on the card, C's values left there): "
              f"stream {t_ns:.4f} ms, xla {t_nx:.4f} ms; whole call (B's values "
              f"uploaded, C's downloaded): stream {t_s:.4f} ms, auto {t_a:.4f} ms, "
              f"xla {t_x:.4f} ms (CUDA events, median) ({card})")
        del Cs, Ca, Cx, S, Sp, V, Bx

    # 24-25. SparseOperator("stream") and spmv_values on the arxiv-size graph
    X = power_law_csr(ARXIV[0], ARXIV[0], ARXIV[1], alpha=1.5, seed=0)
    S = to_scipy(X)
    x_np = np.random.default_rng(3).standard_normal(X.n_cols).astype(np.float32)
    op = SparseOperator(X, kind="stream")
    xt = torch.from_numpy(x_np).to(dev).requires_grad_()
    y = op(xt)
    torch.autograd.grad((y ** 2).sum(), xt)  # builds and uploads both plans
    y, c_f = counted(lambda: op(xt))
    ran_stream(c_f, "SparseOperator forward")
    loss = (y ** 2).sum()
    (g,), c_b = counted(lambda: torch.autograd.grad(loss, xt, retain_graph=True))
    ran_stream(c_b, "SparseOperator backward")
    y64 = S @ x_np.astype(np.float64)
    g64 = 2 * (S.T @ y64)
    g_np = g.cpu().numpy()
    scale = float(np.abs(g64).max())
    check(np.isfinite(g_np).all() and np.allclose(g_np, g64, rtol=2e-4, atol=1e-4 * scale),
          f"SparseOperator: grad outside rtol 2e-4 atol 1e-4*max|g| of float64 NumPy "
          f"(max |diff| {float(np.abs(g_np - g64).max()):.3e}, max |g| {scale:.3e})")
    t_f = ms(lambda: op(xt), iters=20)
    t_b = ms(lambda: torch.autograd.grad(loss, xt, retain_graph=True), iters=20)
    print(f"SparseOperator(kind='stream') on power_law_csr({ARXIV[0]}, {ARXIV[0]}, "
          f"{ARXIV[1]}, alpha 1.5, seed 0), grad of sum(op(x)**2): within rtol 2e-4 "
          f"atol 1e-4*max|g| of float64 NumPy, max |diff| "
          f"{float(np.abs(g_np - g64).max()):.3e}; launches forward {c_f}, backward "
          f"(A^T, cached) {c_b}; forward {t_f:.4f} ms, backward {t_b:.4f} ms (CUDA "
          f"events, median of 20) ({card})")
    Ax = torch.from_numpy(np.asarray(X.Ax)).to(dev).requires_grad_()
    grad_both = lambda: torch.autograd.grad((spmv_values(X, Ax, xt) ** 2).sum(), (Ax, xt))
    (ga, gx), c_v = counted(grad_both)
    rows = X.row_ids().astype(np.int64)
    ga64 = 2 * y64[rows] * x_np.astype(np.float64)[np.asarray(X.Aj)]
    for name, got, want in (("Ax", ga, ga64), ("x", gx, g64)):
        got = got.cpu().numpy()
        sc = float(np.abs(want).max())
        check(np.isfinite(got).all() and np.allclose(got, want, rtol=2e-4, atol=1e-4 * sc),
              f"spmv_values: grad w.r.t. {name} outside rtol 2e-4 atol 1e-4*max|g| of "
              f"float64 NumPy (max |diff| {float(np.abs(got - want).max()):.3e})")
    t_v = ms(grad_both, iters=20)
    print(f"spmv_values on the same graph, grads w.r.t. Ax and x of sum(y**2): within "
          f"rtol 2e-4 atol 1e-4*max|g| of float64 NumPy; launches {c_v or 'none of the hand-written kernels (plain torch: gather, multiply, float64 index_add_)'}; "
          f"forward plus backward {t_v:.4f} ms (CUDA events, median of 20) ({card})")
    del op, xt, y, g, loss, Ax, ga, gx, S

    # 26. ILU(0) and its apply on poisson2d(ILU_M)
    P = poisson2d(ILU_M)
    t = time.perf_counter()
    L, U = ttri.ilu0(P)
    t_fact = time.perf_counter() - t
    levels = []
    t = time.perf_counter()
    for T, lower, unit in ((L, True, True), (U, False, False)):
        levels.append(ttri._solve_plan(T, lower, unit)["n_levels"])
    t_plan = time.perf_counter() - t
    r_np = np.random.default_rng(4).standard_normal(P.n_rows).astype(np.float32)
    r = torch.from_numpy(r_np).to(dev)
    ttri.ilu0_apply(L, U, r)  # uploads both solve plans
    z, c_z = counted(lambda: ttri.ilu0_apply(L, U, r))
    out = []
    g = capture_graph(lambda: out.append(ttri.ilu0_apply(L, U, r)), "ilu0_apply", dev)
    c_dev = graph_launches(g)
    g.replay()
    torch.cuda.synchronize()
    check(c_z == {"K14 sptrsv": 2} and c_dev == {"K14 sptrsv": 2},
          f"ilu0_apply: launches {c_z} (wrappers), {c_dev} (the kernel nodes of the "
          f"same apply captured in a CUDA graph), want K14 twice")
    check(torch.equal(out[0], z), "ilu0_apply: the graph's replay differs from the eager apply")
    del g, out
    t = time.perf_counter()
    z1 = spsolve_triangular(to_scipy(L), r_np.astype(np.float64), lower=True,
                            unit_diagonal=True)
    z64 = spsolve_triangular(to_scipy(U), z1, lower=False)
    t_sp = time.perf_counter() - t
    z_np = z.cpu().numpy()
    err = float(np.abs(z_np - z64).max())
    check(np.isfinite(z_np).all() and np.allclose(z_np, z64, rtol=2e-3, atol=2e-3),
          f"ilu0_apply: outside rtol 2e-3 atol 2e-3 of SciPy's triangular solves "
          f"(max |diff| {err:.3e})")
    t_apply = ms(lambda: ttri.ilu0_apply(L, U, r), iters=20)
    print(f"ILU(0) on poisson2d({ILU_M}): factorization {t_fact:.3f} s, both solve plans "
          f"{t_plan:.3f} s (host); levels per triangle L {levels[0]}, U {levels[1]}; "
          f"ilu0_apply within rtol 2e-3 atol 2e-3 of SciPy's spsolve_triangular in "
          f"float64 ({t_sp:.3f} s), max |diff| {err:.3e}; launches {c_z} (wrappers; "
          f"{c_dev} kernel nodes of the apply captured as a graph, whose replay equals "
          f"it bit for bit); {t_apply:.4f} "
          f"ms per apply (CUDA events, median of 20) ({card})")
    factors = (L, U)
    del P, r, z

    # 27. CG with M="ilu0" on poisson2d(CG_ILU_M) through csr_vector -> dia ->
    # K12, the two K14 solves per iteration in the chunk's CUDA graph
    from spmv_tpu_torch import solvers

    P = poisson2d(CG_ILU_M)
    b_np = np.random.default_rng(0).standard_normal(P.n_rows).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    cg_ilu = lambda: st.cg(P, b, rtol=1e-6, M="ilu0", kind="csr_vector")
    t = time.perf_counter()
    cg_ilu()  # factors, solve plans and the chunk's graph, all cached on P
    t_build = time.perf_counter() - t
    x, info, g = graphed_solve(P, "cg", "ilu0", cg_ilu, reset, counts)
    chunks, c_cg, t_cg = g["chunks"], g["launches"], g["ms"]
    rel = true_relative_residual(P, b_np, x.cpu().numpy())
    check(info["converged"] and rel <= 1e-3,
          f"CG with ILU(0): converged {info['converged']}, true relative residual {rel:.3e}")
    C = solvers.CHUNK
    want = {"K12 dia": 1 + C * chunks, "K14 sptrsv": 2 + 2 * C * chunks}
    check(chunks == -(-info["iters"] // C) and g["eager"] == {"K12 dia": 1, "K14 sptrsv": 2}
          and g["per_chunk"] == {"K12 dia": C, "K14 sptrsv": 2 * C} and c_cg == want,
          f"CG with ILU(0): launches {c_cg} (eager {g['eager']}, per chunk's graph "
          f"{g['per_chunk']}) over {info['iters']} iterations in {chunks} chunks, want {want}")
    L, U = plan_cache(P, ("ilu0",), lambda: ttri.ilu0(P))
    M = lambda v: ttri.ilu0_apply(L, U, v)
    x_e, info_e = st.cg(P, b, rtol=1e-6, M=M, kind="csr_vector")
    torch.cuda.synchronize()
    t = time.perf_counter()
    st.cg(P, b, rtol=1e-6, M=M, kind="csr_vector")
    torch.cuda.synchronize()
    t_eager = (time.perf_counter() - t) * 1e3
    check(info_e == info and torch.equal(x_e, x),
          "CG with ILU(0): the eager chunks differ from the graph's")
    print(f"CG with M='ilu0' on poisson2d({CG_ILU_M}), kind csr_vector (dia, K12): "
          f"{info['iters']} iterations to rtol 1e-6, true relative residual {rel:.3e} "
          f"(float64, host); launches {c_cg} in {chunks} chunks (eager {g['eager']} by "
          f"the wrappers, {g['per_chunk']} kernel nodes of the chunk's graph per replay); "
          f"{t_cg / info['iters']:.4f} ms per iteration by the chunk's graph, "
          f"{t_eager / info['iters']:.4f} ms by eager chunks (M a callable; the same "
          f"iters and x bit for bit) (host clock; first solve with the factorization, "
          f"plans and capture {t_build:.1f} s); a masked iteration past the stop "
          f"{g['masked_ms']:.4f} ms (CUDA events over a replay on the stopped state, x "
          f"and k unchanged), {chunks * C - info['iters']} masked in this solve, at most "
          f"{C - 1} = {(C - 1) * g['masked_ms']:.2f} ms ({card})")
    launches["K14 sptrsv"] = c_cg["K14 sptrsv"]
    del P, b, x, x_e, L, U

    # 28. PageRank (stream) and BFS (merge_genl, or-and) at GRAPH_EX's size
    nodes, edges = GRAPH_EX
    pol = tm._stream_policy_for(14336, dev)  # = the stream and merge_genl kinds'

    def plan_shape(M):
        p = plan_cache(M, ts.plan_cache_key(pol), lambda: ts.build_stream_plan(M, pol))
        return (f"{p.n_gather_tiles} gather tiles, {p.n_final_tiles} final tiles, "
                f"{int(p.hot_cols.shape[0])} hot columns")

    reset()
    out = ex_pr.main(["--nodes", str(nodes), "--edges", str(edges), "--device", str(dev)])
    torch.cuda.synchronize()
    c_pr = counts()
    ran_stream(c_pr, "pagerank")
    A_t, out_deg, ranks, iters = out["A_t"], out["out_deg"], out["ranks"], out["iters"]
    S = to_scipy(A_t)
    rd = np.full(nodes, 1.0 / nodes)
    for _ in range(iters):
        rd = 0.85 * (S @ rd) + (0.15 / nodes + 0.85 * rd[out_deg == 0].sum() / nodes)
    err = float(np.abs(ranks - rd).max())
    check(np.isfinite(ranks).all() and abs(float(ranks.sum()) - 1.0) < 1e-3
          and np.allclose(ranks, rd, rtol=1e-3, atol=1e-9),
          f"pagerank: ranks outside rtol 1e-3 atol 1e-9 of the float64 power iteration "
          f"(max |diff| {err:.3e}, sum {float(ranks.sum()):.6f})")
    rt = torch.from_numpy(ranks).to(dev)
    _, c_one = counted(lambda: st.spmv("stream", A_t, rt))
    t_mv = ms(lambda: st.spmv("stream", A_t, rt), iters=20)
    print(f"PageRank --nodes {nodes} --edges {edges} (stream): {iters} iterations, "
          f"{out['seconds']:.3f} s with the plan build; ranks within rtol 1e-3 atol 1e-9 "
          f"of a float64 power iteration (max |diff| {err:.3e}), sum "
          f"{float(ranks.sum()):.6f}; launches over the run {c_pr}, of one matvec "
          f"{c_one}; {t_mv:.4f} ms per matvec (CUDA events, median of 20); its plan "
          f"{plan_shape(A_t)}, random 4.2M's {plan_shape(R)} ({card})")
    del A_t, S, rt, out
    reset()
    out = ex_bfs.main(["--nodes", str(nodes), "--edges", str(edges),  # asserts its oracle
                       "--device", str(dev)])
    torch.cuda.synchronize()
    c_bfs = counts()
    ran_stream(c_bfs, "bfs")
    f = torch.zeros(nodes, device=dev)
    f[out["source"]] = 1.0
    _, c_one = counted(lambda: st.spmv("merge_genl", out["A_t"], f, semiring=OR_AND))
    t_mv = ms(lambda: st.spmv("merge_genl", out["A_t"], f, semiring=OR_AND), iters=20)
    print(f"BFS --nodes {nodes} --edges {edges} (merge_genl, or_and): depth "
          f"{out['depth']}, {int((out['level'] >= 0).sum())} reachable, equal to the "
          f"host BFS; {out['seconds']:.3f} s with the plan build; launches over the run "
          f"{c_bfs}, of one matvec {c_one}; {t_mv:.4f} ms per matvec (CUDA events, "
          f"median of 20); its plan {plan_shape(out['A_t'])} ({card})")
    return factors


def value_ring_phases(dev, card, hold, results, reset, counts, bench, graph):
    """Phases 29-30: bfloat16 and float16 values through the stream
    kernels, and user-defined rings through every ring-templated kernel.
    `bench` is (label, A, x, host plan) and `graph` (label, G, host plan)
    of the stream phases; the 2-byte matrices reuse those plans, their Ax
    mapped elementwise (a map that keeps 0, so it commutes with the
    planner's gather), so no plan is built again."""
    import dataclasses

    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.formats import as_values, host_values, value_dtype
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.kernels import _cuda
    from spmv_tpu_torch.kernels import csr_vector as tcv
    from spmv_tpu_torch.kernels import dia as tdia
    from spmv_tpu_torch.kernels import ell as tell
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import shuffle as tsh
    from spmv_tpu_torch.kernels import spmm as tspmm
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.ops.semiring import MIN_PLUS, PLUS_TIMES, Semiring
    from spmv_tpu_torch.parallel import dist_spmv as tds
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh

    t_start = time.perf_counter()
    _, A, x_np, plan = bench
    _, G, gplan = graph
    pol = tm._stream_policy_for(14336, dev)  # the key the stream phases' plans sit under
    ulp = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float16: (2.0 ** -10, 1e-5)}
    name16 = {torch.bfloat16: "bfloat16", torch.float16: "float16"}

    def typed(M, host, f):
        """M with Ax -> f(Ax) (a torch tensor) and M's plan, its gathered
        Ax mapped by f, in the plan cache under the stream kind's key."""
        M2 = st.CSR(M.n_rows, M.n_cols, M.Ap, M.Aj, f(torch.from_numpy(np.asarray(M.Ax))))
        g2 = dict(host.gather)
        g2["Ax"] = host_values(f(torch.from_numpy(np.asarray(host.gather["Ax"]))))
        p2 = dataclasses.replace(host, gather=g2)
        plan_cache(M2, ts.plan_cache_key(pol), lambda: p2)
        dp = p2.to(dev)
        dp.gather["Ax"] = as_values(dp.gather["Ax"], value_dtype(M2.Ax))  # bf16's bits
        return M2, dp

    def halves(t):
        """Multiples of 1/2 in [-1, 1]: products are quarters in [-1, 1],
        and bench's row sums stay below 512, so every partial sum is exact
        in float16 too."""
        return (t * 2).round().clamp(-2, 2) / 2

    def oracle64(M, xv):
        return st.spmv_ref(st.CSR(M.n_rows, M.n_cols, M.Ap, M.Aj, np.asarray(
            torch.as_tensor(M.Ax).float().numpy(), np.float64)), xv, y_dtype=np.float64)

    def scatter_oracle(M, xv, combine, red, ident):
        """y on the card by torch's own scatter reduction of the combined
        terms, in float32: an oracle independent of the port's kernels."""
        rows = torch.from_numpy(M.row_ids().astype(np.int64)).to(dev)
        aj = torch.from_numpy(np.asarray(M.Aj, np.int64)).to(dev)
        ax = torch.as_tensor(M.Ax).float().to(dev)
        terms = combine(ax, xv.float()[aj])
        y = torch.full((M.n_rows,), ident, device=dev)
        return y.scatter_reduce_(0, rows, terms, red, include_self=True)

    def e2e(what, kind, M, xv, sr, want):
        st.spmv(kind, M, xv, semiring=sr)
        torch.cuda.synchronize()
        reset()
        y = st.spmv(kind, M, xv, semiring=sr)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{what}: launches {c}, want {want}")
        t = cuda_time_ms(lambda: st.spmv(kind, M, xv, semiring=sr), iters=10)["median_ms"]
        return y, c, t

    def note_launches(c, variant):
        for k, n in c.items():
            v = results.get(k, {}).get("variants", {}).get(variant)
            if v is not None:
                v["launches"] = n

    from spmv_tpu_torch.utils.timing import cuda_time_ms

    # 29. bfloat16 and float16 on bench (K1 -> K7 -> K5 x2 -> K8) and the
    # sssp graph (K3 -> K5 -> K8)
    n_w = plan.x_rows_pad // 128
    F = int(plan.scan["counts"].shape[0])
    passes = plan.shuffle.passes
    x32 = torch.from_numpy(x_np)
    for dt, sr, fa in ((torch.bfloat16, PLUS_TIMES, lambda t: t.bfloat16()),
                       (torch.bfloat16, MIN_PLUS, lambda t: t.abs().bfloat16()),
                       (torch.float16, PLUS_TIMES, lambda t: halves(t).half())):
        variant = f"{name16[dt]} {sr.name}"
        M, dp = typed(A, plan, fa)
        g, rd, sc = dp.gather, dp.reduce, dp.scan
        xv = fa(x32).to(dev)
        ident = float(sr.identity_for(dt))
        exact = sr is not PLUS_TIMES
        tol = None if exact else ulp[dt]
        xnat = torch.nn.functional.pad(xv, (0, g["x_nat_rows"] * 128 - M.n_cols)).reshape(-1, 128)
        win = (xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"])
        if sr is PLUS_TIMES:
            hold("K1 xprep", lambda: ts._xprep_pass(*win, n_w=n_w),
                 lambda: ts._xprep_plain(*win, n_w=n_w), True, note=f" (bench, {variant})",
                 reads=win, variant=variant)
        x2d = ts._x_table(dp, xv, M.n_cols)
        kw = dict(sr=sr, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"], out_rows=rd["out_rows"])
        args7 = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
        part = hold("K7 reduce_roll", lambda: ts._reduce_pass(*args7, **kw),
                    lambda: ts._reduce_roll_plain(*args7, **kw), exact, tol=tol,
                    note=f" (bench, {variant})", reads=k7_reads(args7, rd["Qp"]),
                    variant=variant)
        if sr is PLUS_TIMES:
            k5 = lambda: tsh.apply_shuffle(part, passes, dp.shuffle_dev, fill=ident)
            hold("K5 split", k5, lambda: shuffle_plain(part, passes, dp.shuffle_dev, ident),
                 True, note=f" (bench, 2 passes, {variant})",
                 reads=[part] + [v for d in dp.shuffle_dev for v in d.values()],
                 extra_bytes=sum(p.out_rows * 128 * part.element_size()
                                 for p in passes[:-1]) * 2, variant=variant)
        prod = tsh.apply_shuffle(part, passes, dp.shuffle_dev, fill=ident)
        prod = torch.nn.functional.pad(prod, (0, 0, 0, max(0, F * 128 - prod.shape[0])),
                                       value=ident)[:F * 128].contiguous()
        args8 = (prod, *[sc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2",
                                         "r2s3", "valid2")])
        hold("K8 scan_roll", lambda: ts._scan_pass(*args8[:8], sc["q2s1"], sc["q2s2"],
                                                   sc["q2s3"], sc["valid2"], sc["counts"],
                                                   sr=sr, F_pad=F),
             lambda: ts._scan_roll_plain(*args8, sr=sr, F_pad=F), exact, tol=tol,
             note=f" (bench, {variant})", reads=args8, variant=variant)
        want = {"K1 xprep": 1, "K7 reduce_roll": 1, "K5 split": len(passes),
                "K8 scan_roll": 1}
        y, c, t = e2e(f"bench {variant}", "stream", M, xv, sr, want)
        note_launches(c, variant)
        check(y.dtype == dt and y.shape == (M.n_rows,), f"bench {variant}: y {y.dtype}")
        xin = xv.float().cpu().numpy()
        if dt == torch.bfloat16 and sr is PLUS_TIMES:
            ref = oracle64(M, xin)
            rel = float(np.abs(y.float().cpu().numpy() - ref).max() / max(1.0, np.abs(ref).max()))
            check(rel < 0.08, f"bench {variant}: max err / max(1, max|y|) {rel:.4f} >= 0.08")
            verdict = f"max err / max(1, max|y|) {rel:.5f} of the float64 oracle (gate 0.08)"
        elif sr is PLUS_TIMES:
            ref = oracle64(M, xin)
            check(np.allclose(y.float().cpu().numpy(), ref, rtol=RTOL, atol=ATOL),
                  f"bench {variant}: outside rtol {RTOL} atol {ATOL} of the oracle")
            verdict = f"within rtol {RTOL} atol {ATOL} of the float64 oracle (half-multiple data)"
        else:
            ref = scatter_oracle(M, xv, lambda a, b: a + b, "amin", float("inf")).to(dt)
            check(torch.equal(y, ref), f"bench {variant}: differs from the oracle")
            verdict = "equal bit for bit to the float32 scatter oracle rounded once"
        print(f"bench {variant} stream end to end: {verdict}; launches {c}; {t:.4f} "
              f"ms/call = {M.nnz / t / 1e6:.3f} Gnnz/s ({card})")
        del M, dp, part, prod, args7, args8

    # the sssp graph in bfloat16, one min-plus relaxation (K3 -> K5 -> K8)
    variant = "bfloat16 min_plus"
    Gb, gdp = typed(G, gplan, lambda t: t.bfloat16())
    gp0 = gplan.shuffle.passes[0]
    gg, gsc, gd0 = gdp.gather, gdp.scan, gdp.shuffle_dev[0]
    gt, gF = gplan.n_gather_tiles, int(gsc["counts"].shape[0])
    d_np = np.random.default_rng(5).uniform(0.0, 30.0, G.n_cols).astype(np.float32)
    d_np[np.random.default_rng(6).random(G.n_cols) < 0.3] = np.inf
    dv = torch.from_numpy(d_np).bfloat16().to(dev)
    x2d = ts._x_table(gdp, dv, G.n_cols)
    kw3 = dict(sbt=8, n_tiles=gt, K=gp0.K, Q=gp0.Q, rows_per_g=gp0.out_rows // gp0.K)
    args3 = (x2d, gg["Ax"], gg["q"], gg["xb"], gd0["s1"], gd0["s2"], gd0["s3"],
             gd0["starts"], gd0["pos"])
    hold("K4 gather", lambda: ts._gather_pass(*args3[:4], sr=MIN_PLUS, n_tiles=gt),
         lambda: ts._gather_plain(*args3[:4], sr=MIN_PLUS, n_tiles=gt), True,
         note=f" (sssp graph, {variant})", reads=args3[:4], variant=variant)
    fused = hold("K3 gather_split",
                 lambda: ts._gather_split_pass(*args3, sr=MIN_PLUS, gaps=gd0["gaps"], **kw3),
                 lambda: ts._gather_split_plain(*args3, sr=MIN_PLUS, **kw3), True,
                 note=f" (sssp graph, {variant})", reads=args3 + (gd0["gaps"],),
                 variant=variant)
    rest = (gplan.shuffle.passes[1:], gdp.shuffle_dev[1:])
    k5g = lambda: tsh.apply_shuffle(fused.reshape(-1, 128), *rest, fill=np.inf)
    hold("K5 split", k5g, lambda: shuffle_plain(fused.reshape(-1, 128), *rest, np.inf),
         True, note=f" (sssp graph, passes 2..{len(gplan.shuffle.passes)}, {variant})",
         reads=[fused] + [v for d in rest[1] for v in d.values()],
         extra_bytes=sum(p.out_rows * 128 * 2 for p in rest[0][:-1]) * 2,
         variant=f"{variant} (sssp graph)")
    gprod = k5g()
    gprod = torch.nn.functional.pad(gprod, (0, 0, 0, max(0, gF * 128 - gprod.shape[0])),
                                    value=np.inf)[:gF * 128].contiguous()
    args8 = (gprod, *[gsc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2",
                                        "r2s3", "valid2")])
    hold("K8 scan_roll", lambda: ts._scan_roll_pass(*args8, sr=MIN_PLUS, F_pad=gF),
         lambda: ts._scan_roll_plain(*args8, sr=MIN_PLUS, F_pad=gF), True,
         note=f" (sssp graph, {variant})", reads=args8, variant=f"{variant} (sssp graph)")
    want = {"K3 gather_split": 1, "K5 split": len(gplan.shuffle.passes) - 1,
            "K8 scan_roll": 1}
    y, c, t = e2e(f"sssp graph {variant}", "merge_genl", Gb, dv, MIN_PLUS, want)
    note_launches({"K3 gather_split": 1, "K4 gather": 0}, variant)
    note_launches({"K5 split": c["K5 split"], "K8 scan_roll": 1}, f"{variant} (sssp graph)")
    ref = scatter_oracle(Gb, dv, lambda a, b: a + b, "amin", float("inf")).bfloat16()
    check(torch.equal(y, ref), f"sssp graph {variant}: differs from the oracle")
    print(f"sssp graph {variant} relaxation (merge_genl): equal bit for bit to the "
          f"float32 scatter oracle rounded once; launches {c}; {t:.4f} ms = "
          f"{G.nnz / t / 1e6:.3f} Gnnz/s ({card})")
    del Gb, gdp, fused, gprod, args3, args8, x2d
    print(f"phase 29 (bfloat16 and float16) done in {time.perf_counter() - t_start:.1f} s")

    # 30. user-defined rings, each compiled from its torch callables into a
    # library of its own at its first CUDA call
    max_plus = Semiring("max_plus", lambda: float("-inf"), lambda a, x: a + x,
                        lambda acc, v: torch.maximum(acc, v))
    sat = Semiring("sat_add_times", lambda: 0.0, lambda a, x: a * x,
                   lambda acc, v: torch.clamp(acc + v, max=4.0))
    for ring in (max_plus, sat):
        t = time.perf_counter()
        _cuda.ring_lib(ring)
        secs = _cuda.ring_build_seconds.get(ring.name)
        print(f"ring library {ring.name}: built and loaded in {time.perf_counter() - t:.3f} "
              f"s (nvcc {'cached' if secs is None else f'{secs:.3f}'} s)")
        ptxas_report(_cuda.ring_build_logs[ring.name],
                     ("18reduce_roll_kernel", "16scan_roll_kernel", "19gather_split_kernel",
                      "13gather_kernel", "18merge_group_kernel", "19group_reduce_kernel",
                      "10dia_kernel", "18spmm_window_kernel", "16local_ell_kernel"))
    variant = "max_plus (user ring)"
    x = torch.from_numpy(x_np).to(dev)
    dplan = plan.to(dev)
    g, rd, sc = dplan.gather, dplan.reduce, dplan.scan
    x2d = ts._x_table(dplan, x, A.n_cols)
    kw = dict(sr=max_plus, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"], out_rows=rd["out_rows"])
    args7 = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
    part = hold("K7 reduce_roll", lambda: ts._reduce_pass(*args7, **kw),
                lambda: ts._reduce_roll_plain(*args7, **kw), True,
                note=f" (bench, {variant})", reads=k7_reads(args7, rd["Qp"]), variant=variant)
    prod = tsh.apply_shuffle(part, passes, dplan.shuffle_dev, fill=float("-inf"))
    prod = torch.nn.functional.pad(prod, (0, 0, 0, max(0, F * 128 - prod.shape[0])),
                                   value=float("-inf"))[:F * 128].contiguous()
    args8 = (prod, *[sc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2",
                                     "r2s3", "valid2")])
    hold("K8 scan_roll", lambda: ts._scan_roll_pass(*args8, sr=max_plus, F_pad=F),
         lambda: ts._scan_roll_plain(*args8, sr=max_plus, F_pad=F), True,
         note=f" (bench, {variant})", reads=args8, variant=variant)
    del part, prod, args7, args8
    gdplan = gplan.to(dev)
    gg, gd0 = gdplan.gather, gdplan.shuffle_dev[0]
    x2d = ts._x_table(gdplan, torch.from_numpy(d_np).to(dev), G.n_cols)
    args3 = (x2d, gg["Ax"], gg["q"], gg["xb"], gd0["s1"], gd0["s2"], gd0["s3"],
             gd0["starts"], gd0["pos"])
    hold("K4 gather", lambda: ts._gather_pass(*args3[:4], sr=max_plus, n_tiles=gt),
         lambda: ts._gather_plain(*args3[:4], sr=max_plus, n_tiles=gt), True,
         note=f" (sssp graph, {variant})", reads=args3[:4], variant=variant)
    hold("K3 gather_split",
         lambda: ts._gather_split_pass(*args3, sr=max_plus, gaps=gd0["gaps"], **kw3),
         lambda: ts._gather_split_plain(*args3, sr=max_plus, **kw3), True,
         note=f" (sssp graph, {variant})", reads=args3 + (gd0["gaps"],), variant=variant)
    dg = torch.from_numpy(d_np).to(dev)
    y, c, t = e2e("sssp graph merge_genl max_plus", "merge_genl", G, dg, max_plus, want)
    note_launches({"K3 gather_split": 1, "K4 gather": 0}, variant)
    check(torch.equal(y, scatter_oracle(G, dg, lambda a, b: a + b, "amax", float("-inf"))),
          "sssp graph merge_genl max_plus: differs from the oracle")
    print(f"sssp graph merge_genl max_plus (user ring): equal bit for bit to torch's scatter "
          f"oracle; launches {c}; {t:.4f} ms = {G.nnz / t / 1e6:.3f} Gnnz/s ({card})")
    del gdplan, args3, x2d
    # K11 on bench's csr_vector_ell plan, K10 on its tuned merge plan
    ep = tcv.csr_ell_plan(A, dev)
    eprod = tell.ell_products(A, x, max_plus, ep)
    hold("K11 group_reduce",
         lambda: tell._group_reduce_pass(eprod, W=ep.width, strategy="tree", sr=max_plus),
         lambda: tell._group_reduce_plain(eprod, W=ep.width, strategy="tree",
                                          sr=max_plus)[:, ::ep.width], True,
         note=f" (bench, W {ep.width}, tree, {variant})", reads=(eprod,), variant=variant)
    md = tm.device_merge_plan(A, tm.TUNED_POLICY, dev)
    S, P = tm.TUNED_POLICY.nnz_per_tile // 128, tm.TUNED_POLICY.rows_per_tile // 128
    mrest = (md.rel_tiles.view(-1, 128), md.pr1, md.pr2, md.pr3, md.r_start, md.lrow, md.cnt)
    mprod = tm.merge_products(A, x, max_plus, md)
    hold("K10 merge_group", lambda: tm._merge_group_pass(mprod, *mrest, sr=max_plus, S=S, P=P),
         lambda: tm._merge_group_plain(mprod, *mrest, sr=max_plus, S=S, P=P), True,
         note=f" (bench tuned plan, {variant})", reads=(mprod,) + mrest,
         ops=3 * mprod.numel(), variant=variant)
    del eprod, mprod
    # end to end on bench: stream, merge_genl, csr_vector_ell, merge_tiled
    ref = scatter_oracle(A, x, lambda a, b: a + b, "amax", float("-inf"))
    roll = {"K1 xprep": 1, "K7 reduce_roll": 1, "K5 split": len(passes), "K8 scan_roll": 1}
    for kind, want in (("stream", roll), ("merge_genl", roll),
                       ("csr_vector_ell", {"K9 pgather": 1, "K11 group_reduce": 1}),
                       ("merge_tiled", {"K9 pgather": 2, "K10 merge_group": 1})):
        y, c, t = e2e(f"bench {kind} max_plus", kind, A, x, max_plus, want)
        check(torch.equal(y, ref), f"bench {kind} max_plus: differs from the oracle")
        if kind in ("stream", "csr_vector_ell", "merge_tiled"):
            note_launches(c, variant)
        print(f"bench {kind} max_plus (user ring): equal bit for bit to torch's scatter "
              f"oracle; launches {c}; {t:.4f} ms/call = {A.nnz / t / 1e6:.3f} Gnnz/s ({card})")
    # K12 on poisson2d, K13 on the arxiv-size graph, K11' on 2 shards of bench
    Pm = poisson2d(POISSON_M)
    vals, valid, offs = tdia.device_dia_plan(Pm, dev)
    xp = torch.from_numpy(np.random.default_rng(11).standard_normal(Pm.n_cols).astype(
        np.float32)).to(dev)
    hold("K12 dia", lambda: tdia._dia_pass(vals, valid, xp, offs, sr=max_plus),
         lambda: tdia._dia_plain(vals, valid, xp, offs, sr=max_plus), True,
         note=f" (poisson2d, {variant})", reads=(vals, valid, xp), variant=variant)
    reset()
    y = st.spmv("dia", Pm, xp, semiring=max_plus)
    torch.cuda.synchronize()
    c = counts()
    check(c == {"K12 dia": 1}, f"poisson2d dia max_plus: launches {c}")
    note_launches(c, variant)
    check(torch.equal(y, scatter_oracle(Pm, xp, lambda a, b: a + b, "amax", float("-inf"))),
          "poisson2d dia max_plus: differs from the oracle")
    print(f"poisson2d dia max_plus (user ring): equal bit for bit to torch's scatter oracle; "
          f"launches {c}")
    del vals, valid, Pm
    Gx = power_law_csr(ARXIV[0], ARXIV[0], ARXIV[1], alpha=1.5, seed=0)
    dw = tspmm.device_window_plan(Gx, np.float32, dev)
    Xblk = torch.nn.functional.pad(torch.from_numpy(np.random.default_rng(15).standard_normal(
        (Gx.n_cols, 128)).astype(np.float32)).to(dev), (0, 0, 0, dw["rows_pad"] - Gx.n_cols))
    args13 = (Xblk, dw["ax"], dw["q"], dw["xb"])
    hold("K13 spmm_window", lambda: tspmm._spmm_window_pass(*args13, sr=max_plus),
         lambda: tspmm._spmm_window_plain(*args13, sr=max_plus), True,
         note=f" (arxiv-size, B 128, {variant})", reads=args13, variant=variant)
    reset()
    Y = st.spmm(Gx, Xblk[:Gx.n_cols], semiring=max_plus, method="window")
    torch.cuda.synchronize()
    c = counts()
    check(c == {"K13 spmm_window": 1}, f"arxiv-size spmm window max_plus: launches {c}")
    note_launches(c, variant)
    check(torch.equal(Y[:, 0], scatter_oracle(Gx, Xblk[:Gx.n_cols, 0], lambda a, b: a + b,
                                              "amax", float("-inf"))),
          "arxiv-size spmm window max_plus: column 0 differs from the oracle")
    print(f"arxiv-size spmm(method='window') max_plus (user ring), B 128: launches {c}, "
          f"column 0 equal bit for bit to torch's scatter oracle")
    del Gx, dw, Xblk, Y
    d2 = distribute_csr(A, make_mesh("shards", n_shards=2, device=dev))
    b = d2.dev["self"]
    xs = d2.shard_x(x)
    argsl = (b["aj"], b["ax"], b["valid"], xs)
    hold("K11' local_ell", lambda: tds._local_ell_pass(*argsl, W=b["W"], sr=max_plus),
         lambda: tds._local_ell_plain(*argsl, W=b["W"], sr=max_plus), True,
         note=f" (bench, 2 local shards, self block, W {b['W']}, {variant})",
         reads=argsl, variant=variant)
    d2.matvec(x, semiring=max_plus)
    torch.cuda.synchronize()
    reset()
    y = d2.matvec(x, semiring=max_plus)
    torch.cuda.synchronize()
    c = counts()
    check(c == {"K11' local_ell": 2}, f"bench distribute_csr max_plus: launches {c}")
    note_launches(c, variant)
    check(torch.equal(y, ref), "bench distribute_csr max_plus: differs from the oracle")
    print(f"bench distribute_csr (2 local shards) max_plus (user ring): equal bit for bit "
          f"to torch's scatter oracle; launches {c}")
    del d2, xs, argsl
    # the saturating sum on non-negative data (there clamping is order-free)
    variant = "sat_add_times (user ring)"
    Ms, dps = typed(A, plan, lambda t: t.abs())
    xa = x.abs()
    g, rd = dps.gather, dps.reduce
    x2d = ts._x_table(dps, xa, A.n_cols)
    kw = dict(sr=sat, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"], out_rows=rd["out_rows"])
    args7 = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
    hold("K7 reduce_roll", lambda: ts._reduce_pass(*args7, **kw),
         lambda: ts._reduce_roll_plain(*args7, **kw), False,
         note=f" (bench, {variant})", reads=k7_reads(args7, rd["Qp"]), variant=variant)
    y, c, t = e2e("bench stream sat_add_times", "stream", Ms, xa, sat, roll)
    note_launches({"K7 reduce_roll": 1}, variant)
    ref = scatter_oracle(Ms, xa, lambda a, b: a * b, "sum", 0.0).clamp(max=4.0)
    check(torch.allclose(y, ref, rtol=RTOL, atol=ATOL),
          f"bench stream sat_add_times: outside rtol {RTOL} atol {ATOL} of sum-then-clamp")
    print(f"bench stream sat_add_times (user ring, |Ax| and |x|): within rtol {RTOL} atol "
          f"{ATOL} of torch's scatter sum clamped at 4 (max |diff| "
          f"{float((y - ref).abs().max()):.3e}); launches {c}; {t:.4f} ms/call ({card})")
    print(f"phase 30 (user rings) done; phases 29-30 took {time.perf_counter() - t_start:.1f} s")


def half_direct_phases(dev, card, hold, results, reset, counts, bench):
    """Phase 31: bfloat16 and float16 values off the stream path. K9 ->
    K11 (csr_vector_ell) and K9 -> K10 -> K9 (merge_tiled) on bench, K11'
    (distribute_csr) and K7 -> K5 -> K8 per shard (distribute_stream) on
    bench over 4 local shards, K12 (dia, csr_vector) on poisson2d(1024),
    K13 (spmm window, B = 128) on the arxiv-size graph: bf16 and f16
    plus-times (f16 on multiples of 1/2 in [-1, 1]) and bf16 min-plus.
    `bench` is (label, A, x) of the stream phases; its ELL, merge and
    distributed plans, built by the earlier phases, are reused with their
    values mapped elementwise (a map that keeps 0), so no plan of bench is
    built again. Each kernel is held against its plain version: bit for
    bit, K10's sums within rtol 2e-4 / atol 1e-5; each call against the
    float64 oracle (bf16 within 0.08 of max(1, max|y|), f16 within rtol
    2e-4 / atol 1e-5 or equal to it rounded to f16, but on rows cut
    across shards, see `judge`) or, in min-plus, the float32 scatter
    oracle rounded once, bit for bit."""
    import dataclasses

    from scipy.sparse import csr_matrix

    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.formats import host_values
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.kernels import csr_vector as tcv
    from spmv_tpu_torch.kernels import dia as tdia
    from spmv_tpu_torch.kernels import ell as tell
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import pgather as tpg
    from spmv_tpu_torch.kernels import spmm as tspmm
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.registry import plan_cache, plan_cached
    from spmv_tpu_torch.ops.semiring import MIN_PLUS, PLUS_TIMES
    from spmv_tpu_torch.ops.tuning import detect_chip, policy_for
    from spmv_tpu_torch.parallel import dist_spmv as tds
    from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    _, A, x_np = bench
    name16 = {torch.bfloat16: "bfloat16", torch.float16: "float16"}

    def halves(t):
        """Multiples of 1/2 in [-1, 1] (phase 29's f16 data)."""
        return (t * 2).round().clamp(-2, 2) / 2

    def mapped(a, f):
        """A host value array of float32 values mapped by f, as the
        planners carry the result (bfloat16 as its bits)."""
        return host_values(f(torch.from_numpy(np.ascontiguousarray(a))))

    def typed(M, f, keys):
        """M with Ax -> f(Ax) (a torch tensor), and M's host plans under
        `keys` (those already built), their values mapped by f, in the
        new matrix's plan cache."""
        M2 = st.CSR(M.n_rows, M.n_cols, M.Ap, M.Aj, f(torch.from_numpy(np.asarray(M.Ax))))
        for key, remap in keys:
            if plan_cached(M, key):
                host = plan_cache(M, key, None)
                plan_cache(M2, key, lambda: remap(host, f))
        return M2

    W = tell.select_width(A.mean_nnz_per_row)
    pol4 = policy_for(4, chip=detect_chip(dev))
    check(policy_for(2, chip=detect_chip(dev)) == pol4,
          "the stream policy of 2-byte values differs from float32's: bench's "
          "distribute_stream plan cannot be reused")
    dist_key = lambda blk, f: {**blk, "ax": mapped(blk["ax"], f)}
    bench_keys = (
        (("ell", W), lambda h, f: dataclasses.replace(h, ax=mapped(h.ax, f))),
        (("merge", tm.TUNED_POLICY),
         lambda h, f: dataclasses.replace(h, ax_tiles=mapped(h.ax_tiles, f))),
        (("dist_csr", 4, "nnz"),
         lambda h, f: {**h, "self": dist_key(h["self"], f), "halo": dist_key(h["halo"], f)}),
        (("dist_stream", 4, "nnz", pol4),
         lambda h, f: (h[0], dataclasses.replace(
             h[1], dev={**h[1].dev, "Ax": mapped(h[1].dev["Ax"], f)}))))
    mesh4 = make_mesh("shards", n_shards=4, device=dev)
    cpu4 = make_mesh("shards", n_shards=4, device="cpu")

    def oracle64(M, xv):
        return st.spmv_ref(st.CSR(M.n_rows, M.n_cols, M.Ap, M.Aj, np.asarray(
            torch.as_tensor(M.Ax).float().numpy(), np.float64)),
            xv.float().cpu().numpy().astype(np.float64), y_dtype=np.float64)

    def scatter_min(M, xv):
        """The min-plus y by torch's scatter reduction of the float32 terms
        on the card, rounded to x's dtype once."""
        rows = torch.from_numpy(M.row_ids().astype(np.int64)).to(dev)
        terms = (torch.as_tensor(M.Ax).float().to(dev)
                 + xv.float()[torch.from_numpy(np.asarray(M.Aj, np.int64)).to(dev)])
        y = torch.full((M.n_rows,), float("inf"), device=dev)
        return y.scatter_reduce_(0, rows, terms, "amin", include_self=True).to(xv.dtype)

    def f16_close(yn, ref):
        """Per element: within rtol 2e-4 / atol 1e-5 of the float64 oracle,
        or equal to it rounded to f16 (through float32, as torch converts).
        On multiples of 1/2 every product and sum is exact, so that
        rounding is the nearest f16 answer; past 512 f16 holds no
        quarters, and one rounding there is more than rtol 2e-4.
        Returns (the mask, how many needed the rounding)."""
        close = np.isclose(yn, ref, rtol=RTOL, atol=ATOL)
        rounded = yn == torch.from_numpy(ref).to(torch.float16).float().numpy()
        return close | rounded, int((rounded & ~close).sum())

    def judge(what, y, M, xv, sr, dt, split=None):
        """y against the oracle; returns the verdict. `split` (f16 on a
        mesh) are the rows cut across shards: each shard's partial of such
        a row is rounded to f16 where a kernel or the glue writes it, as
        in the reference, and a partial past 512 holds no quarters, so
        those rows are left out of the oracle's rtol (the caller holds
        them to the CPU's plain versions bit for bit)."""
        check(y.dtype == dt and tuple(y.shape)[0] == M.n_rows,
              f"{what}: y {y.dtype} {tuple(y.shape)}, want {dt}")
        if sr is MIN_PLUS:
            check(torch.equal(y, scatter_min(M, xv)), f"{what}: differs from the oracle")
            return "equal bit for bit to the float32 scatter oracle rounded once"
        ref = oracle64(M, xv)
        yn = y.float().cpu().numpy()
        if dt == torch.bfloat16:
            rel = float(np.abs(yn - ref).max() / max(1.0, np.abs(ref).max()))
            check(rel < 0.08, f"{what}: max err / max(1, max|y|) {rel:.4f} >= 0.08")
            return f"max err / max(1, max|y|) {rel:.5f} of the float64 oracle (gate 0.08)"
        keep = np.ones(M.n_rows, bool)
        if split is not None:
            keep[split] = False
        if dt == torch.float16:
            ok, n_round = f16_close(yn[keep], ref[keep])
            past = f" ({n_round} rows past it equal to the oracle rounded to float16)"
        else:  # float32 y
            ok, past = np.isclose(yn[keep], ref[keep], rtol=RTOL, atol=ATOL), ""
        check(ok.all(), f"{what}: {int((~ok).sum())} rows outside rtol {RTOL} atol {ATOL} "
                        f"of the float64 oracle{' and not it rounded to float16' if past else ''}")
        verdict = f"within rtol {RTOL} atol {ATOL} of the float64 oracle{past}"
        if split is not None:
            verdict += (f" but on the {len(split)} rows split across shards (max |diff| "
                        f"{np.abs(yn - ref)[split].max():.3e} there, f16 partials)")
        return verdict

    def e2e(what, run, want, M, xv, sr, dt, variant, split=None, cpu=None):
        run()
        torch.cuda.synchronize()
        reset()
        y = run()
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{what}: launches {c}, want {want}")
        for k, n in c.items():
            v = results.get(k, {}).get("variants", {}).get(variant)
            if v is not None:
                v["launches"] = n
        verdict = judge(what, y, M, xv, sr, dt, split)
        if cpu is not None:
            check(torch.equal(y.cpu().view(torch.int16), cpu().view(torch.int16)),
                  f"{what}: differs from the same call on the CPU (plain versions)")
            verdict += "; equal bit for bit to the same call on the CPU (plain versions)"
        t = cuda_time_ms(run, iters=10)["median_ms"]
        print(f"{what}: {verdict}; launches {c}; {t:.4f} ms/call = "
              f"{M.nnz / t / 1e6:.3f} Gnnz/s ({card})")
        return y

    # bench: csr_vector_ell, merge_tiled, distribute_csr, distribute_stream
    x32 = torch.from_numpy(x_np)
    for dt, sr, f in ((torch.bfloat16, PLUS_TIMES, lambda t: t.bfloat16()),
                      (torch.float16, PLUS_TIMES, lambda t: halves(t).half()),
                      (torch.bfloat16, MIN_PLUS, lambda t: t.abs().bfloat16())):
        variant = f"{name16[dt]} {sr.name}"
        timed, exact = sr is PLUS_TIMES, sr is not PLUS_TIMES
        M = typed(A, f, bench_keys)
        xv = f(x32).to(dev)
        # K9 -> K11
        ep = tcv.csr_ell_plan(M, dev)
        pg = ep.pgather
        args9 = (xv, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
        kw9 = dict(C=pg.n_chunks, R=pg.rounds)
        idx = ep.aj.reshape(-1).long()
        hold("K9 pgather", lambda: tpg._pgather_pass(*args9, **kw9),
             lambda: tpg._pgather_plain(*args9, **kw9), True,
             note=f" (bench csr_vector_ell, {variant})", reads=args9,
             lib=lambda: xv[idx], time_it=timed, variant=variant)
        prod = tell.ell_products(M, xv, sr, ep)
        hold("K11 group_reduce",
             lambda: tell._group_reduce_pass(prod, W=W, strategy="linear", sr=sr),
             lambda: tell._group_reduce_plain(prod, W=W, strategy="linear", sr=sr)[:, ::W],
             True, note=f" (bench, W {W}, linear, leaders, {variant})", reads=(prod,),
             lib=(lambda: prod.view(-1, W).sum(1)) if timed else None, time_it=timed,
             variant=variant)
        e2e(f"bench csr_vector_ell {variant}", lambda: st.spmv("csr_vector_ell", M, xv,
                                                              semiring=sr),
            {"K9 pgather": 1, "K11 group_reduce": 1}, M, xv, sr, dt, variant)
        del prod
        # K9 -> K10 -> K9
        md = tm.device_merge_plan(M, tm.TUNED_POLICY, dev)
        S, P = tm.TUNED_POLICY.nnz_per_tile // 128, tm.TUNED_POLICY.rows_per_tile // 128
        rest = (md.rel_tiles.view(-1, 128), md.pr1, md.pr2, md.pr3, md.r_start, md.lrow,
                md.cnt)
        mprod = tm.merge_products(M, xv, sr, md)
        y_tiles = hold("K10 merge_group",
                       lambda: tm._merge_group_pass(mprod, *rest, sr=sr, S=S, P=P),
                       lambda: tm._merge_group_plain(mprod, *rest, sr=sr, S=S, P=P), exact,
                       note=f" (bench tuned plan, {variant})", reads=(mprod,) + rest,
                       ops=3 * mprod.numel(), time_it=timed, variant=variant)
        pgy = md.pgather_y
        argsy = (y_tiles.reshape(-1), pgy.qlo, pgy.qhi, pgy.s1, pgy.s2, pgy.s3)
        kwy = dict(C=pgy.n_chunks, R=pgy.rounds)
        hold("K9 pgather", lambda: tpg._pgather_pass(*argsy, **kwy),
             lambda: tpg._pgather_plain(*argsy, **kwy), True,
             note=f" (bench tuned merge plan, y assembly, {variant})", time_it=False)
        e2e(f"bench merge_tiled {variant}", lambda: st.spmv("merge_tiled", M, xv, semiring=sr),
            {"K9 pgather": 2, "K10 merge_group": 1}, M, xv, sr, dt, variant)
        del mprod, y_tiles
        # K11' over 4 local shards
        d4 = distribute_csr(M, mesh4)
        b = d4.dev["self"]
        xs = d4.shard_x(xv)
        ax = d4._values("self", dt)
        argsl = (b["aj"], ax, b["valid"], xs)
        v = b["valid"]
        n_valid = int(v.sum())
        n_x = int(torch.unique((torch.arange(v.shape[0], device=dev).view(-1, 1, 1, 1)
                                * xs.shape[1] + b["aj"].long())[v]).numel())
        hold("K11' local_ell", lambda: tds._local_ell_pass(*argsl, W=b["W"], sr=sr),
             lambda: tds._local_ell_plain(*argsl, W=b["W"], sr=sr), True,
             note=f" (bench, 4 local shards, self block, W {b['W']}, {variant})",
             reads=(v,), extra_bytes=(4 + 2) * n_valid + 2 * n_x,
             ops=2 * n_valid, time_it=timed, cold=timed, variant=variant)
        half = dt == torch.float16
        split = np.unique(d4.plan.export_rows[d4.plan.export_rows >= 0]) if half else None
        e2e(f"bench distribute_csr (4 local shards) {variant}",
            lambda: d4.matvec(xv, semiring=sr), {"K11' local_ell": 2}, M, xv, sr, dt, variant,
            split, (lambda: distribute_csr(M, cpu4).matvec(xv.cpu(), semiring=sr))
            if half else None)
        if dt == torch.bfloat16 and sr is PLUS_TIMES:  # bf16 Ax with a float32 x
            x32d = x32.to(dev)
            e2e(f"bench distribute_csr (4 local shards) bfloat16 Ax, float32 x",
                lambda: d4.matvec(x32d), {"K11' local_ell": 2}, M, x32d, sr,
                torch.float32, "bfloat16 Ax, float32 x")
        del d4, xs, ax, argsl
        # K7 -> K5 -> K8 per shard over 4 local shards
        D = distribute_stream(M, mesh4)
        u = D.uni
        args7 = D.reduce_inputs(xv, 0)
        kw7 = dict(sr=sr, n_tiles=u.pad_tiles, Qp=u.Qp, out_rows=u.out_rows)
        hold("K7 reduce_roll", lambda: ts._reduce_roll_pass(*args7, **kw7),
             lambda: ts._reduce_roll_plain(*args7, **kw7), exact,
             tol=None if exact else (ULP16[dt], ATOL),
             note=f" (bench, shard 0 of 4 of distribute_stream, {u.pad_tiles} gather "
                  f"tiles, Qp {u.Qp}, {variant})", reads=k7_reads(args7, u.Qp),
             time_it=timed, variant=f"{variant} (distribute_stream)")
        npass = len(u.split_meta)
        e2e(f"bench distribute_stream (4 local shards) {variant}",
            lambda: D.matvec(xv, semiring=sr),
            {"K7 reduce_roll": 4, "K5 split": 4 * npass, "K8 scan_roll": 4}, M, xv, sr, dt,
            f"{variant} (distribute_stream)", split,
            (lambda: distribute_stream(M, cpu4, policy=pol4).matvec(xv.cpu(), semiring=sr))
            if half else None)
        if dt == torch.bfloat16 and sr is PLUS_TIMES:
            reset()
            try:
                D.matvec(x32.to(dev))
                check(False, "bench distribute_stream: bf16 Ax with a float32 x did not raise")
            except ValueError as e:
                check(counts() == {}, f"bench distribute_stream: launches {counts()} "
                                      f"before its ValueError")
                print(f"bench distribute_stream bfloat16 Ax, float32 x: ValueError before "
                      f"any launch, as the reference raises ({e})")
        del D, args7, M
    print(f"phase 31 bench paths done in {time.perf_counter() - t_start:.1f} s")

    # K12 on poisson2d(1024): dia, then csr_vector on it
    t = time.perf_counter()
    Pm = poisson2d(POISSON_M)
    prof = tdia.diag_profile(Pm)
    host = tdia.build_dia_plan(Pm, prof[0])
    print(f"poisson2d({POISSON_M}) and its DIA plan in {time.perf_counter() - t:.3f} s (host)")
    xp32 = torch.from_numpy(np.random.default_rng(11).standard_normal(Pm.n_cols).astype(
        np.float32))
    for dt, f in ((torch.bfloat16, lambda t: t.bfloat16()),
                  (torch.float16, lambda t: halves(t).half())):
        variant = f"{name16[dt]} plus_times"
        Pt = typed(Pm, f, ())
        plan_cache(Pt, ("dia", "profile"), lambda: prof)
        plan_cache(Pt, ("dia", "plan"), lambda: (f(torch.from_numpy(host[0])).float().numpy(),)
                   + host[1:])
        vals, valid, offs = tdia.device_dia_plan(Pt, dev, dt)
        xv = f(xp32).to(dev)
        hold("K12 dia", lambda: tdia._dia_pass(vals, valid, xv, offs, sr=PLUS_TIMES),
             lambda: tdia._dia_plain(vals, valid, xv, offs, sr=PLUS_TIMES), True,
             note=f" (poisson2d, {variant})", reads=(vals, valid, xv), cold=True,
             variant=variant)
        for kind in ("dia", "csr_vector"):
            e2e(f"poisson2d {kind} {variant}", lambda: st.spmv(kind, Pt, xv),
                {"K12 dia": 1}, Pt, xv, PLUS_TIMES, dt, variant)
        del vals, valid, Pt
    del Pm, host

    # K13 on the arxiv-size graph, B = 128
    t = time.perf_counter()
    Gx = power_law_csr(ARXIV[0], ARXIV[0], ARXIV[1], alpha=1.5, seed=0)
    wplan = tspmm._plan_spmm_window(Gx)
    print(f"arxiv-size graph and its window plan in {time.perf_counter() - t:.3f} s (host)")
    X32 = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (Gx.n_cols, 128)).astype(np.float32))
    for dt, f in ((torch.bfloat16, lambda t: t.bfloat16()),
                  (torch.float16, lambda t: halves(t).half())):
        variant = f"{name16[dt]} plus_times"
        Gt = typed(Gx, f, ())
        plan_cache(Gt, "spmm_window", lambda: {
            **wplan, "ax": f(torch.from_numpy(wplan["ax"]).float()).double().numpy()})
        dw = tspmm.device_window_plan(Gt, dt, dev)
        X = f(X32).to(dev)
        Xblk = torch.nn.functional.pad(X, (0, 0, 0, dw["rows_pad"] - Gx.n_cols))
        cols = (dw["xb"].long()[:, None] * 128 + dw["q"].long()).reshape(-1)
        args13 = (Xblk, dw["ax"], dw["q"], dw["xb"])
        hold("K13 spmm_window", lambda: tspmm._spmm_window_pass(*args13, sr=PLUS_TIMES),
             lambda: tspmm._spmm_window_plain(*args13, sr=PLUS_TIMES), True,
             note=f" (arxiv-size, B 128, {variant})", reads=args13,
             lib=lambda: Xblk.index_select(0, cols), cold=True, variant=variant)
        st.spmm(Gt, X, method="window")
        torch.cuda.synchronize()
        reset()
        Y = st.spmm(Gt, X, method="window")
        torch.cuda.synchronize()
        c = counts()
        check(c == {"K13 spmm_window": 1}, f"arxiv-size spmm window {variant}: launches {c}")
        results["K13 spmm_window"]["variants"][variant]["launches"] = 1
        check(Y.dtype == dt and tuple(Y.shape) == (Gx.n_rows, 128),
              f"arxiv-size spmm window {variant}: Y {Y.dtype} {tuple(Y.shape)}")
        Gs = csr_matrix((torch.as_tensor(Gt.Ax).double().numpy(), np.asarray(Gx.Aj),
                         np.asarray(Gx.Ap)), shape=Gx.shape)
        ref = Gs @ X.double().cpu().numpy()
        yn = Y.float().cpu().numpy()
        if dt == torch.bfloat16:
            rel = float(np.abs(yn - ref).max() / max(1.0, np.abs(ref).max()))
            check(rel < 0.08, f"arxiv-size spmm window {variant}: {rel:.4f} >= 0.08")
            verdict = f"max err / max(1, max|Y|) {rel:.5f} of SciPy in float64 (gate 0.08)"
        else:
            ok, n_round = f16_close(yn, ref)
            check(ok.all(), f"arxiv-size spmm window {variant}: {int((~ok).sum())} entries "
                            f"outside rtol {RTOL} atol {ATOL} and not SciPy's rounded")
            verdict = (f"within rtol {RTOL} atol {ATOL} of SciPy in float64 ({n_round} entries "
                       f"past it, |Y| over 512, equal to SciPy's rounded to float16)")
        tc = cuda_time_ms(lambda: st.spmm(Gt, X, method="window"), iters=10)["median_ms"]
        print(f"arxiv-size spmm(method='window') {variant}, B 128: {verdict}; launches {c}; "
              f"{tc:.4f} ms/call ({card})")
        del dw, X, Xblk, Y, Gt
    print(f"phase 31 (16-bit values off the stream path) done in "
          f"{time.perf_counter() - t_start:.1f} s")


def device_loop_phases(dev, card, hold, results, bench, wide, factors):
    """Phase 32, the device loops: every device kind captured in a CUDA
    graph and replayed against its eager call (the harness's default
    kinds on bench in the four built-in rings, `dia` and `csr_vector`'s
    dia branch on poisson2d(POISSON_M), `dense` on poisson2d(DENSE_M));
    the harness's graph-chained kernel time of every default kind beside
    back-to-back calls and the profiler's device time, the memory of a
    50-call chain on `wide`, and cpu_naive by calls; K14 against its plain version on ILU(0)'s factors of
    poisson2d(ILU_M) (`factors`) and on a random lower triangle, timed
    alone, flushed, beside its bound and the time of a chain of as many
    one-slot levels; cg and bicgstab by replayed graph against their
    chunks run eagerly on poisson2d(POISSON_M) and poisson2d(CG_ILU_M),
    with the host's reads."""
    import spmv_tpu_torch as st
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.bench.harness import DEFAULT_KINDS
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.ops.registry import ATOMIC_FOLD_KINDS
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.utils import timing
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    label, A, x_np = bench
    x = torch.from_numpy(x_np).to(dev)
    P = poisson2d(POISSON_M)
    xp = torch.from_numpy(np.random.default_rng(31).standard_normal(P.n_cols)
                          .astype(np.float32)).to(dev)
    rings = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)

    # 32a. every device kind captured and replayed
    def replay(kind, A_m, xv, sr, what):
        fn = lambda v: st.spmv(kind, A_m, v, semiring=sr)
        want = fn(xv)  # the eager warm-up call
        xs, out = xv.clone(), []
        g = timing.capture_graph(lambda: out.append(fn(xs)),
                                 f"spmv({kind!r}) on {what} in {sr.name}", dev)
        g.replay()
        torch.cuda.synchronize()
        got = out[0]
        same = torch.equal(got, want)
        if kind in ATOMIC_FOLD_KINDS and sr is PLUS_TIMES:
            a, b = got.cpu().numpy(), want.cpu().numpy()
            ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
            check(np.all(np.abs(a - b) <= ulp), f"spmv({kind!r}) on {what}: the graph's "
                                                f"replay differs from the eager call by "
                                                f"more than one float32 ulp")
            return f"{sr.name} within one ulp (bit for bit: {same})"
        check(same, f"spmv({kind!r}) on {what} in {sr.name}: the graph's replay is not "
                    f"bit for bit the eager call")
        return f"{sr.name} bit for bit"

    cases = [(k, A, x, label, rings) for k in DEFAULT_KINDS] + [
        ("dia", P, xp, f"poisson2d({POISSON_M})", rings),
        ("csr_vector", P, xp, f"poisson2d({POISSON_M}), its dia branch", rings),
        ("dense", poisson2d(DENSE_M), None, f"poisson2d({DENSE_M})", (PLUS_TIMES,))]
    for kind, A_m, xv, what, srs in cases:
        if xv is None:
            xv = torch.ones(A_m.n_cols, device=dev)
        got = [replay(kind, A_m, xv, sr, what) for sr in srs]
        print(f"graph capture: spmv({kind!r}) on {what}, captured after one eager call "
              f"and replayed: {'; '.join(got)}")
    print(f"phase 32a (every kind captured) done in {time.perf_counter() - t_start:.1f} s")

    # 32b. the harness's timing on the card, by graph chain, per default kind
    for kind in DEFAULT_KINDS:
        r = timing.benchmark_spmv(kind, A, x, iters=20, check=False)
        b2b = timing._back_to_back_s(lambda v: st.spmv(kind, A, v), x, 20)
        busy = device_ms(lambda: st.spmv(kind, A, x))
        check(r.kernel_s > 0, f"harness timing of {kind}: kernel_s {r.kernel_s}")
        print(f"harness timing, {kind} on {label}: kernel_s {r.kernel_s * 1e3:.4f} ms by "
              f"graph chain ({r.gnnz_per_s:.3f} Gnnz/s, SoL {100 * r.sol_fraction:.1f}%); "
              f"20 calls back to back {b2b * 1e3:.4f} ms a call; device busy "
              f"{busy:.4f} ms a call (profiler); one call host-observed "
              f"{r.total_s * 1e3:.3f} ms ({card})")
    # a 50-call chain on the wide-row matrix: what a call frees inside the
    # capture serves the next call, and each chain's graph is freed
    w_label, Wm, xw_np = wide
    xw = torch.from_numpy(xw_np).to(dev)
    st.spmv("stream", Wm, xw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st.spmv("stream", Wm, xw)
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    r = timing.benchmark_spmv("stream", Wm, xw, iters=50, check=False)
    chain, held = torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base
    check(chain <= 2 * one and held < one, f"a 50-call chain on {w_label}: peak {chain} B "
                                           f"over the plan for {one} B a call, {held} B held "
                                           f"after")
    print(f"harness timing, stream on {w_label}, --iters 50: kernel_s {r.kernel_s * 1e3:.4f} ms; "
          f"one call peaks {one / 2**20:.1f} MiB over its plan, the chains' timing "
          f"{chain / 2**20:.1f} MiB, {held / 2**20:.1f} MiB held after it ({card})")
    r = timing.benchmark_spmv("cpu_naive", A, x, iters=3, check=False)
    check(r.kernel_s > 0, "harness timing of cpu_naive")
    print(f"harness timing, cpu_naive on {label}: {r.kernel_s * 1e3:.3f} ms a call, timed "
          f"by {timing.timing_of('cpu_naive', dev)} (a host kind: no graph) ({card})")

    # 32c. K14 on ILU(0)'s factors and on a random lower triangle
    def tri_args(T, lower, unit, b, dtype=torch.float32):
        plan = ttri._solve_plan(T, lower, unit)
        args = ([plan[k].to(dev) for k in ("rows", "cols")]
                + [plan[k].to(dev, dtype) for k in ("vals", "diag")] + [b.to(dtype)])
        return args, dict(n=T.n_rows, l0=ttri._level_of_row0(plan["rows"])), plan

    def library(T, lower, unit, b):
        """torch.triangular_solve on T as a sparse CSR tensor (cuSPARSE's
        triangular solve), the one PyTorch call computing the same x, or
        None where this PyTorch does not take a sparse CSR matrix."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            Ts = torch.sparse_csr_tensor(
                torch.from_numpy(np.asarray(T.Ap, np.int64)),
                torch.from_numpy(np.asarray(T.Aj, np.int64)),
                torch.from_numpy(np.asarray(T.Ax, np.float32)), size=T.shape).to(dev)
            f = lambda: torch.triangular_solve(b[:, None], Ts, upper=not lower,
                                               unitriangular=unit)[0]
            try:
                f()
                return f
            except (RuntimeError, NotImplementedError) as e:
                print(f"K14's library call: torch.triangular_solve on a sparse CSR "
                      f"matrix is not available here ({type(e).__name__}: {e})")
                return None

    L, U = factors
    rng = np.random.default_rng(32)
    n_r = RANDOM_TRI[0]
    rr = np.repeat(np.arange(1, n_r), RANDOM_TRI[1])
    cc = (rng.random(rr.size) * rr).astype(np.int64)  # an earlier row
    Tr = st.coo_to_csr(st.COO(n_r, n_r, np.concatenate([rr, np.arange(n_r)]),
                              np.concatenate([cc, np.arange(n_r)]),
                              np.concatenate([rng.uniform(-0.2, 0.2, rr.size),
                                              1.0 + rng.random(n_r)]).astype(np.float32)),
                       sum_duplicates=True)
    for name, T, lower, unit in (("L", L, True, True), ("U", U, False, False),
                                 ("random lower", Tr, True, False)):
        b = torch.from_numpy(rng.standard_normal(T.n_rows).astype(np.float32)).to(dev)
        t = time.perf_counter()
        args, kw, plan = tri_args(T, lower, unit, b)
        t_plan = time.perf_counter() - t
        n_off = T.nnz - (0 if unit else T.n_rows)
        lib = library(T, lower, unit, b)
        if lib is not None:
            lx = lib()[:, 0]
            ok = torch.allclose(lx, ttri._sptrsv_pass(*args, **kw), rtol=1e-3, atol=1e-3)
            print(f"K14 ({name}): torch.triangular_solve agrees within rtol 1e-3 atol 1e-3: "
                  f"{ok}")
        note = (f" ({name} of {'ILU(0) on poisson2d(%d)' % ILU_M if name != 'random lower' else 'random_tri %s' % (RANDOM_TRI,)}: "
                f"{plan['n_levels']} levels x {tuple(plan['cols'].shape[1:])} (PL, W), "
                f"l0 {kw['l0']}, plan {t_plan:.2f} s)")
        # the bound counts what the solve needs: each off-diagonal entry's
        # column and value, the diagonal where it is not unit, the row
        # order, b read and x written once (x by `hold`); the plan's padded
        # (levels, PL, W) envelope, which K14 reads whole, beside it
        n, vs = T.n_rows, 4
        need = n_off * (4 + vs) + (0 if unit else n * vs) + n * 4 + n * vs
        ops = 2 * n_off + n * (1 if unit else 2)
        env_ms, _ = bound_of(tensor_bytes(*args) + n * vs, ops)
        hold("K14 sptrsv", lambda: ttri._sptrsv_pass(*args, **kw),
             lambda: ttri._sptrsv_plain(*args, n=kw["n"]), True, note=note,
             extra_bytes=need, ops=ops, lib=lib, cold=True)
        print(f"K14 ({name}): the plan's envelope {(tensor_bytes(*args) + n * vs) / 1e6:.1f} "
              f"MB would bound it at {env_ms:.4f} ms; the triangle's own bytes "
              f"{(need + n * vs) / 1e6:.1f} MB ({n_off} off-diagonal entries)")
        if name == "L":
            results["K14 sptrsv"]["envelope_bound_ms"] = env_ms
        # the level floor: one CTA walking as many levels of one slot (W 1)
        nl = plan["n_levels"]
        chain = [torch.arange(nl, dtype=torch.int32, device=dev)[:, None],
                 (torch.arange(nl, dtype=torch.int32, device=dev) - 1).clamp(min=0)[:, None, None],
                 torch.full((nl, 1, 1), 0.5, device=dev), torch.ones((nl, 1), device=dev),
                 torch.ones(nl, device=dev)]
        floor = cuda_time_ms(lambda: ttri._sptrsv_pass(*chain, n=nl, l0=0),
                             iters=ITERS)["median_ms"]
        if name == "L":
            results["K14 sptrsv"]["level_floor_ms"] = floor
        print(f"K14 ({name}): a chain of {nl} one-slot levels (W 1) takes {floor:.4f} ms "
              f"= {floor / nl * 1e3:.3f} us a level; the solve "
              f"{cuda_time_ms(lambda: ttri._sptrsv_pass(*args, **kw), iters=ITERS)['median_ms']:.4f}"
              f" ms ({card})")
        if name == "L":
            for dt in (torch.bfloat16, torch.float16):
                a16, kw16, _ = tri_args(T, lower, unit, b, dt)
                hold("K14 sptrsv", lambda: ttri._sptrsv_pass(*a16, **kw16),
                     lambda: ttri._sptrsv_plain(*a16, n=kw16["n"]), True,
                     note=f" ({name}, {dt})", time_it=False)
        if name == "random lower":
            bn = b.clone()
            # late rows, so that the NaN and +-inf reach some dependents, not all
            bn[-2000], bn[-500], bn[-1] = float("inf"), float("nan"), -float("inf")
            args[4] = bn
            a, w = ttri._sptrsv_pass(*args, **kw), ttri._sptrsv_plain(*args, n=kw["n"])
            torch.cuda.synchronize()
            nan = torch.isnan(w)
            check(torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], w[~nan]),
                  "K14 with +-inf and NaN in b differs from its plain version")
            print(f"K14 ({name}) with +-inf and NaN in b: equal to its plain version bit "
                  f"for bit, NaN as NaN ({int(nan.sum())} NaN, "
                  f"{int(torch.isinf(w).sum())} inf of {T.n_rows})")

    # 32d. cg and bicgstab: a replayed graph per chunk against eager chunks
    # (float32 BiCGSTAB breaks down on poisson2d(512) and larger)
    for name, m in (("cg", POISSON_M), ("bicgstab", CG_ILU_M)):
        Pm = P if m == POISSON_M else poisson2d(m)
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(Pm.n_rows)
                             .astype(np.float32)).to(dev)
        f = getattr(st, name)
        solve = lambda M: f(Pm, b, rtol=1e-6, maxiter=10000, M=M, kind="csr_vector")
        solve(None)  # captures the chunk's graph, cached on P
        torch.cuda.synchronize()
        reads = solvers.host_reads
        t = time.perf_counter()
        xg, ig = solve(None)
        torch.cuda.synchronize()
        t_graph = (time.perf_counter() - t) * 1e3
        reads = solvers.host_reads - reads
        t = time.perf_counter()
        xe, ie = solve(lambda r: r)  # a callable M: the same chunks, eager
        torch.cuda.synchronize()
        t_eager = (time.perf_counter() - t) * 1e3
        it = ig["iters"]
        check(ig["converged"], f"{name} on poisson2d({m}) did not converge: {ig}")
        check(ig == ie and torch.equal(xg, xe),
              f"{name}: the graph's solve ({ig}) differs from the eager chunks' ({ie})")
        check(reads == 1 + -(-it // solvers.CHUNK), f"{name}: {reads} host reads for {it} "
                                                     f"iterations")
        print(f"{name} on poisson2d({m}) (csr_vector -> dia -> K12), rtol 1e-6: "
              f"{it} iterations, the same iters and x bit for bit by graph and by eager "
              f"chunks; {reads} host reads (1 + one per chunk of {solvers.CHUNK}); "
              f"{t_graph / it:.4f} ms per iteration by graph, {t_eager / it:.4f} by eager "
              f"chunks (host clock) ({card})")
    print(f"phase 32 (device loops) done in {time.perf_counter() - t_start:.1f} s")


def shuffle_plain(data, passes, sdev, fill=0.0):
    """The plain split passes in sequence: K5's plain version over a
    plan's passes, in data's dtype."""
    from spmv_tpu_torch.kernels import shuffle as tsh

    for p, d in zip(passes, sdev):
        data = tsh._split_plain(
            data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"],
            n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
            rows_per_g=p.out_rows // p.K, fill=fill).reshape(p.out_rows, 128)
    return data


POISSON_M = 1024                      # poisson2d(1024): 1,048,576 rows
HARNESS_MTX_M = 256                   # poisson2d(256) through a .mtx file
STENCIL = (88, 88, 128)               # 991,232 rows, offsets up to +-7744
PWTK = (217_918, 11_524_432, 3)       # the size class of SuiteSparse's pwtk
CG_ITERS = (2200, 2700)               # NumPy's float32 CG: 2449 iterations
ARXIV = (169_343, 1_166_243)          # ogbn-arxiv's nodes and edges, as OGB publishes them
SPMM_STREAM = (16384, 16384, 20000)   # random_csr for spmm(method="stream")
SPGEMM_SAMPLE = 4096                  # rows of C held to the NumPy min-plus oracle
ILU_M = 1024                          # ILU(0) and its apply on poisson2d(1024)
CG_ILU_M = 256                        # CG with M="ilu0" on poisson2d(256)
DENSE_M = 64                          # the dense kind's capture: poisson2d(64)
RANDOM_TRI = (100_000, 6)             # K14's random lower triangle: rows, deps a row
GRAPH_EX = (1 << 20, 4_194_304)       # PageRank and BFS: --nodes, --edges


def dijkstra_scipy(G, source: int) -> np.ndarray:
    """SciPy's Dijkstra in float64 on the graph's out-edges (G holds
    in-edges), duplicate edges collapsed to their least weight first
    (csr_matrix would sum them)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    rows = G.row_ids().astype(np.int64)   # edge target
    cols = np.asarray(G.Aj, np.int64)     # edge source
    w = np.asarray(G.Ax, np.float64)
    order = np.lexsort((w, rows, cols))   # by (source, target), least weight first
    src, dst, w = cols[order], rows[order], w[order]
    first = np.ones(src.size, bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    M = csr_matrix((w[first], (src[first], dst[first])), shape=G.shape)
    return dijkstra(M, directed=True, indices=source)


if __name__ == "__main__":
    sys.exit(main())
