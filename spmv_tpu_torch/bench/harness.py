"""Benchmark CLI: load or make a matrix, run each kind, check it against
the float64 oracle, time it and report it against the roofline.

Counterpart of `spmv_tpu/bench/harness.py`, with the same CLI, kinds
and report; the report's flow is the reference's main.cu (load .mtx ->
CSR -> device copy -> CPU oracle -> per-kind correctness delta ->
per-kind timing -> report). Times come from `utils/timing.py`: on the
card a kind's kernel time is device time per call, the slope between two
chains of calls captured as CUDA graphs, as the reference chains its
calls in one device loop; the host kind `cpu_naive` is timed by calls
back to back. Each row ends with the timing it used (`timing_of`). The
speed of light comes from `utils/roofline.py`.

Usage:
    python -m spmv_tpu_torch.bench.harness MATRIX [kind ...]
    python -m spmv_tpu_torch.bench.harness --synthetic powerlaw --nnz 4000000 merge xla
    python -m spmv_tpu_torch.bench.harness --device cpu --synthetic random --rows 512 --nnz 4096 xla

MATRIX is a .mtx path, or use --synthetic {banded,random,powerlaw,kron}.
Default kinds = the reference's default list. It runs on
`config.default_device()`, the card, unless `--device` says otherwise,
and raises without a card; `--device cpu` runs the kinds' plain
versions, timed by the host clock. A kind that
fails is reported on stderr and left out of the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

from spmv_tpu_torch import list_kinds
from spmv_tpu_torch.config import device_for
from spmv_tpu_torch.io.generate import banded_csr, kron_graph_csr, power_law_csr, random_csr
from spmv_tpu_torch.io.matrix_market import read_matrix_market
from spmv_tpu_torch.utils.roofline import chip_specs
from spmv_tpu_torch.utils.timing import benchmark_spmv, timing_of

DEFAULT_KINDS = [
    "xla",
    "csr_scalar",
    "csr_vector",
    "csr_vector_shfl",
    "csr_vector_shfl2",
    "csr_vector_ell",
    "light_vec",
    "light_warp",
    "light_vec_ell",
    "merge_stock",
    "merge",
    "merge_genl",
    "merge_tiled",
    "stream",
]


def load_matrix(args):
    if args.matrix and not args.synthetic:
        return read_matrix_market(args.matrix, as_csr=True)
    kind = args.synthetic or "powerlaw"
    n = args.rows
    if kind == "banded":
        return banded_csr(n, bandwidth=max(args.nnz // max(n, 1) // 2, 1))
    if kind == "random":
        return random_csr(n, n, args.nnz)
    if kind == "powerlaw":
        return power_law_csr(n, n, args.nnz, alpha=args.alpha)
    if kind == "kron":
        scale = max(int(math.log2(max(n, 2))), 2)
        return kron_graph_csr(scale, edge_factor=max(args.nnz // (1 << scale), 1))
    raise SystemExit(f"unknown synthetic kind {kind}")


def _device(name) -> torch.device:
    """The device the run takes (`config.device_for`): never the CPU
    unless asked for; without a card it exits naming --device cpu."""
    try:
        return device_for(name, who="harness",
                          how="pass --device cpu to run the plain versions on the "
                              "CPU (host-clock times, no device time)")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("matrix", nargs="?", help=".mtx file path")
    p.add_argument("kinds", nargs="*", help="kernel kinds (default: the reference's list)")
    p.add_argument("--synthetic", choices=["banded", "random", "powerlaw", "kron"])
    p.add_argument("--rows", type=int, default=1 << 20)
    p.add_argument("--nnz", type=int, default=1 << 23)
    p.add_argument("--alpha", type=float, default=1.5)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    p.add_argument("--autotune", metavar="TABLE.json", nargs="?", const="", default=None,
                   help="refit the stream tile policy on this matrix before "
                        "benchmarking; the optional path persists the fitted table "
                        "(default: ops.tuning.default_table_path())")
    p.add_argument("--plan-dir", metavar="DIR", default=None,
                   help="on-disk plan cache: build each matrix's stream plan once, "
                        "reload it on later runs (utils/plancache)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler trace of each kind's timing into "
                        "DIR/<kind>/trace.json (chrome://tracing or Perfetto)")
    p.add_argument("--x", choices=["ones", "random"], default="random",
                   help="x vector (the reference CLI's is all ones; random is "
                        "value-sensitive and the default here)")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the kinds run (default: config.default_device(), "
                        "the card; it raises without one)")
    args = p.parse_args(argv)
    dev = _device(args.device)

    # Positional juggling: `harness kinds...` with --synthetic.
    kinds = list(args.kinds)
    if args.matrix and args.synthetic:
        kinds = [args.matrix] + kinds
        args.matrix = None
    if not kinds:
        kinds = DEFAULT_KINDS
    bad = [k for k in kinds if k not in list_kinds(include_aliases=True)]
    if bad:
        raise SystemExit(f"unknown kinds {bad}; valid: {list_kinds(include_aliases=True)}")

    if args.plan_dir:
        from spmv_tpu_torch import config

        config.set_plan_dir(args.plan_dir)

    A = load_matrix(args)
    chip, bw = chip_specs(dev)
    print(f"matrix: {A.n_rows} x {A.n_cols}, nnz={A.nnz} "
          f"(mean {A.mean_nnz_per_row:.2f}/row)  device={chip} ({bw:.0f} GB/s)",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    x_np = (np.ones(A.n_cols, np.float32) if args.x == "ones"
            else rng.standard_normal(A.n_cols).astype(np.float32))
    x = torch.from_numpy(x_np).to(dev)

    from spmv_tpu_torch.ops import tuning

    table_chip = tuning.detect_chip(dev)
    if args.autotune is not None:
        fields, _ = tuning.autotune_stream(A, x, iters=args.iters)
        tuning.set_active(fields)
        print(f"autotuned stream policy: {fields}", file=sys.stderr)
        tuning.save_table(fields, args.autotune or tuning.default_table_path(),
                          chip=table_chip)
    else:
        # pick up a previously persisted autotune result for this chip
        loaded = tuning.load_table(tuning.default_table_path(), chip=table_chip)
        if loaded:
            print(f"loaded persisted tuning table: {loaded}", file=sys.stderr)

    results, failed = [], []
    for kind in kinds:
        try:
            if args.trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                with profile(activities=acts) as prof:
                    r = benchmark_spmv(kind, A, x, iters=args.iters,
                                       check=not args.no_check)
                os.makedirs(os.path.join(args.trace, kind), exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.trace, kind, "trace.json"))
            else:
                r = benchmark_spmv(kind, A, x, iters=args.iters, check=not args.no_check)
        except Exception as e:  # keep the report going, like the reference CLI
            print(f"{kind:18s} FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            failed.append(kind)
            continue
        results.append(r)
        if args.json:
            print(json.dumps(dataclasses.asdict(r)))
            print(f"{kind}: timed by {timing_of(kind, dev)}", file=sys.stderr)
        else:
            print(f"{r.row()}  [{timing_of(kind, dev)}]")
    if failed:
        print(f"harness: failed kinds (left out of the results): {failed}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
