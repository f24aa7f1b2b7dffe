"""Weak-scaling benchmark for the multi-device layer.

Counterpart of `spmv_tpu/bench/weak_scaling.py`, with the same flags,
JSON records and fallback. The per-shard problem size is held constant
while the shard count grows; efficiency(n) = t(n_first) / t(n).

- One process (the default): a local mesh of n shards on one device,
  the card unless `--device cpu`. On one card the shards run one after
  another, so the ideal there is t(n) = n * t(1): "efficiency" checks
  the mechanism (per-shard work and exchange stay flat as n grows) and
  is not a scaling figure.
- Under torchrun with WORLD_SIZE > 1: a process-group mesh, one shard
  per rank (NCCL on the card, gloo with `--device cpu`); only the shard
  count equal to the world size runs, and rank 0 prints the JSON.

`--impl stream` runs `distribute_stream` and falls back to
`distribute_csr` (printed) when a shard is too small or sparse for the
stream planner; `--impl ell` runs `distribute_csr`. Each point's y
(each rank's owned rows) must first lie within rtol 2e-4 / atol 1e-5 of
the float64 oracle, or the run fails. Time per call: on
the card, the median between CUDA events (utils/timing.py); on the
CPU, the median of the calls' host-clock times.

Usage:
    python -m spmv_tpu_torch.bench.weak_scaling [--rows-per-dev 65536]
        [--nnz-per-dev 524288] [--devices 1 2 4 8] [--iters 20]
        [--mode halo|allgather] [--impl stream|ell] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def run(n_devices: int, rows_per_dev: int, nnz_per_dev: int,
        iters: int, mode: str = "halo", seed: int = 0,
        impl: str = "stream", device=None):
    """One weak-scaling point: the record, or None when the mesh cannot
    have n_devices shards (a process group of another size)."""
    import torch.distributed as dist

    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.ops.reference import spmv_ref
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.parallel import (distribute_csr, distribute_stream,
                                         make_mesh)
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            return None
        mesh = make_mesh("shards", distributed=True)
    else:
        mesh = make_mesh("shards", n_shards=n_devices, device=device,
                         distributed=False)
    n = rows_per_dev * n_devices
    A = power_law_csr(n, n, nnz_per_dev * n_devices, alpha=1.5, seed=seed)
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)

    dist_mv = None
    if impl == "stream":
        try:
            dist_mv = distribute_stream(A, mesh)
            matvec = lambda xv: dist_mv.matvec(xv)
        except PlanCapacityError as e:
            print(f"n={n_devices}: stream infeasible ({e}); ELL path",
                  file=sys.stderr)
    if dist_mv is None:
        dist_mv = distribute_csr(A, mesh)
        matvec = lambda xv: dist_mv.matvec(xv, mode=mode)
    xs = dist_mv.shard_x(x)
    y = matvec(xs).cpu().numpy()  # uploads settle, kernels built
    # the correctness gate: this process's rows against the float64 oracle
    rows = slice(0, A.n_rows)
    if mesh.distributed:
        rs = dist_mv.plan.row_starts
        rows = slice(int(rs[mesh.rank]), int(rs[mesh.rank + 1]))
    ref = spmv_ref(A, x, y_dtype=np.float64)[rows]
    if y.shape != ref.shape or not np.allclose(y, ref, rtol=2e-4, atol=1e-5):
        raise RuntimeError(f"weak_scaling n={n_devices}: y outside rtol 2e-4 "
                           f"atol 1e-5 of the float64 oracle")

    if mesh.device.type == "cuda":
        t = cuda_time_ms(lambda: matvec(xs), iters=iters)["median_ms"] / 1e3
        name = torch.cuda.get_device_name(mesh.device)
    else:  # CPU calls return when done: the median of their host times
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            matvec(xs)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        name = "cpu"
    return {
        "n_devices": n_devices,
        "nnz": A.nnz,
        "time_s": t,
        "gnnz_per_s": A.nnz / t / 1e9,
        "comm_bytes_per_shard": dist_mv.comm_bytes_per_shard,
        "allgather_bytes_per_shard": dist_mv.allgather_bytes_per_shard,
        "device": name,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows-per-dev", type=int, default=1 << 16)
    p.add_argument("--nnz-per-dev", type=int, default=1 << 19)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--mode", choices=["halo", "allgather"], default="halo")
    p.add_argument("--impl", choices=["stream", "ell"], default="stream",
                   help="per-shard compute: the stream pipeline (default) "
                        "or the ELL path (K11')")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the shards run (default: config.default_device(), "
                        "the card)")
    args = p.parse_args(argv)
    if args.iters < 1:
        p.error("--iters must be at least 1")
    from spmv_tpu_torch.config import device_for

    try:
        device = device_for(args.device, who="weak_scaling", how="pass --device cpu")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    from spmv_tpu_torch.parallel import init_distributed

    world = init_distributed(backend="nccl" if device.type == "cuda" else "gloo")
    rank = 0
    if world > 1:
        import torch.distributed as dist

        rank = dist.get_rank()

    results = []
    base = None
    for n in args.devices:
        r = run(n, args.rows_per_dev, args.nnz_per_dev, args.iters,
                mode=args.mode, impl=args.impl, device=device)
        if r is None:
            if rank == 0:
                print(f"n={n}: the process group has {world} ranks, "
                      f"skipping", file=sys.stderr)
            continue
        if base is None:
            base = r["time_s"]
        r["weak_scaling_efficiency"] = base / r["time_s"]
        results.append(r)
        # one device runs the n shards one after another: the ideal
        # there is eff = 1/n; eff*n is the share of that ideal reached
        one_device = world == 1
        adj = (f"  (x n = {r['weak_scaling_efficiency'] * r['n_devices'] * 100:.0f}% "
               f"of the one-device serial ideal)" if one_device else "")
        if rank == 0:
            print(f"n={r['n_devices']}: {r['time_s'] * 1e3:.3f} ms/iter  "
                  f"{r['gnnz_per_s']:.2f} Gnnz/s  "
                  f"eff={r['weak_scaling_efficiency'] * 100:.0f}%{adj}  "
                  f"comm {r['comm_bytes_per_shard'] / 1e6:.2f} MB vs "
                  f"allgather {r['allgather_bytes_per_shard'] / 1e6:.2f} MB  "
                  f"({r['device']})", file=sys.stderr)
    if rank == 0:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
