"""Time the port's GMRES and its multi-device matvec from one checkout of
the repo, so that two commits can be compared on one card within one call.

    python scripts/time_gmres_torch.py --tree DIR --label NAME [--restart M]
    python scripts/time_gmres_torch.py --tree DIR --label NAME --k15 32,160

imports `spmv_tpu_torch` from DIR (the repo's root or an unpacked `git
archive` of another commit), builds its kernels there, and prints one JSON
line: the card's name and power limit; ms a restart cycle of
`gmres(restart=M, rtol=1e-5)` (M = 32 by default; the median of 3 solves on the host clock,
after one solve that builds the plans and, where the tree has it,
captures the cycle's graph) on a nonsymmetric matrix of 1,048,576 rows (tests/
test_torch_solvers.py's `_nonsym` form, seed 3) with kind "stream" and
"xla", and on poisson2d(256) with M="ilu0" and kind "csr_vector", each
with its iterations; and CUDA-event medians of one `spmv("stream")` call
on that matrix and of a `matvec` call of
`distribute_stream` and of `distribute_csr` (halo) over 4 local shards on
bench (power_law_csr(1<<20, 1<<20, 3.3M, alpha 1.5, seed 42)), after two
calls. A solve the tree cannot run (a restart its K15 does not take)
is recorded as the error it raised.

With --k15, it times K15 (`hessenberg_lstsq`) instead, at each m listed,
on a random (m+1, m) Hessenberg (`chip_smoke.hessenberg`'s form, seed 0,
the entries above the diagonal scaled by 2 / sqrt(m) past m = 160): ms
alone with its wrapper (CUDA events, median of --iters launches), ms a
launch back to back (20 launches an event pair, median of 10) and device
µs a launch (torch.profiler over 20 launches, launch excluded); an m the
tree's K15 refuses is recorded as the error it raised.

Run parent, change, change, parent in one call, each in its own
process. It imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

# this checkout's chip_smoke.py, whatever tree --tree names
_SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "chip_smoke.py")


def nonsym(st, n, seed=3):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    off = rows != cols
    _, uniq = np.unique(rows * n + cols, return_index=True)
    keep = uniq[off[uniq]]
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32) * 0.1
    return st.coo_to_csr(st.COO(n, n, np.concatenate([rows, np.arange(n)]),
                                np.concatenate([cols, np.arange(n)]),
                                np.concatenate([vals, np.full(n, 5.0, np.float32)])))


def hessenberg(m, seed=0):
    """chip_smoke.hessenberg's random (m+1, m) upper Hessenberg, float32,
    the entries above the diagonal scaled by 2 / sqrt(m) past m = 160."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", _SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.hessenberg(m, seed, scale=1.0 if m <= 160 else 2 / np.sqrt(m))


def events_ms(fn, iters, batch=1):
    """Median ms of `batch` calls of fn between a CUDA event pair, over
    `iters` pairs, after two calls."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def device_us(fn, calls=20):
    """torch.profiler's device time of one fn() call, µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if not e.key.startswith(("aten::", "cuda"))) / calls


def time_k15(ms, dev, iters):
    """{m: K15's times at m, or the error the tree's K15 raised}."""
    import torch
    from spmv_tpu_torch.kernels import krylov

    out = {}
    beta = torch.tensor(1.5, device=dev)
    for m in ms:
        H = torch.from_numpy(hessenberg(m)).to(dev)
        fn = lambda: krylov.hessenberg_lstsq(H, beta)
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            out[m] = f"raises {type(e).__name__}: {e}"
            continue
        out[m] = {"alone_ms": events_ms(fn, iters), "b2b_ms": events_ms(fn, 10, batch=20),
                  "device_us": device_us(fn)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--restart", type=int, default=32)
    ap.add_argument("--k15", type=lambda v: [int(m) for m in v.split(",")], default=None,
                    help="time K15 alone at these m (comma-separated) instead")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("time_gmres_torch: no card", file=sys.stderr)
        return 2
    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card}
    t0 = time.perf_counter()
    if args.k15:
        out["k15"] = time_k15(args.k15, dev, args.iters)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out))
        return 0
    m = args.restart
    out["restart"] = m
    N = nonsym(st, 1 << 20)
    P = poisson2d(256)
    for name, A, kind, M in (("nonsym_stream", N, "stream", None),
                             ("nonsym_xla", N, "xla", None),
                             ("poisson256_ilu0", P, "csr_vector", "ilu0")):
        b = torch.from_numpy(np.random.default_rng(33).standard_normal(A.n_rows)
                             .astype(np.float32)).to(dev)
        solve = lambda: st.gmres(A, b, rtol=1e-5, restart=m, M=M, kind=kind)
        try:
            solve()
        except (RuntimeError, ValueError) as e:
            out[f"gmres_{name}"] = f"raises {type(e).__name__}: {e}"
            continue
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, info = solve()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / (info["iters"] / m))
        if not (info["converged"] and torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: {info}")
        out[f"gmres_{name}_ms_per_cycle"] = float(np.median(times))
        out[f"gmres_{name}_iters"] = info["iters"]

    bN = torch.from_numpy(np.random.default_rng(33).standard_normal(N.n_rows)
                          .astype(np.float32)).to(dev)
    out["nonsym_stream_matvec_ms"] = events_ms(lambda: st.spmv("stream", N, bN), args.iters)
    B = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(B.n_cols)
                         .astype(np.float32)).to(dev)
    mesh = make_mesh("shards", n_shards=4, device=dev)
    D = distribute_stream(B, mesh)
    out["distribute_stream_4_ms"] = events_ms(lambda: D.matvec(x), args.iters)
    d = distribute_csr(B, mesh)
    out["distribute_csr_4_halo_ms"] = events_ms(lambda: d.matvec(x), args.iters)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
