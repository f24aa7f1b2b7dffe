"""Time the port's triangular solve (K14) from one checkout of the repo, so
that two commits can be compared on one card within one call.

    python scripts/time_sptrsv_torch.py --tree DIR --label NAME

imports `spmv_tpu_torch` from DIR (the repo's root or an unpacked `git
archive` of another commit), builds its kernels there, and prints one JSON
line: the card's name and power limit, and CUDA-event medians of
`sptrsv` on ILU(0)'s L and U of poisson2d(1024), on a random lower
triangle of 100,000 rows (6 earlier rows each) and on a wide-level one
(524,288 rows, 2 earlier rows each for half of them), of `ilu0_apply` on
poisson2d(1024), and of an iteration of `cg(M="ilu0")` on poisson2d(256)
(host clock over a solve). Run parent, change, change, parent in one call,
each in its own process. It imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("time_sptrsv_torch: no card", file=sys.stderr)
        return 2
    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.kernels import trisolve as ttri

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]

    def events_ms(fn, iters=args.iters):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def lower(n, deps, p_dep, seed):
        rng = np.random.default_rng(seed)
        rr = np.repeat(np.arange(1, n), deps)
        rr = rr[np.repeat(rng.random(n - 1) < p_dep, deps)]
        cc = (rng.random(rr.size) * rr).astype(np.int64)
        return st.coo_to_csr(st.COO(
            n, n, np.concatenate([rr, np.arange(n)]), np.concatenate([cc, np.arange(n)]),
            np.concatenate([rng.uniform(-0.2, 0.2, rr.size), 1.0 + rng.random(n)])
            .astype(np.float32)), sum_duplicates=True)

    out = {"label": args.label, "card": card}
    t0 = time.perf_counter()
    P = poisson2d(1024)
    L, U = ttri.ilu0(P)
    tri = {"L": (L, True, True), "U": (U, False, False),
           "random": (lower(100_000, 6, 1.0, 32), True, False),
           "wide": (lower(524_288, 2, 0.5, 33), True, False)}
    for name, (T, lo, unit) in tri.items():
        b = torch.from_numpy(np.random.default_rng(1).standard_normal(T.n_rows)
                             .astype(np.float32)).to(dev)
        x = ttri.sptrsv(T, b, lower=lo, unit_diagonal=unit)  # plans, upload
        torch.cuda.synchronize()
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{name}: non-finite solve")
        out[f"{name}_ms"] = events_ms(lambda: ttri.sptrsv(T, b, lower=lo, unit_diagonal=unit))
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(P.n_rows)
                         .astype(np.float32)).to(dev)
    out["ilu0_apply_ms"] = events_ms(lambda: ttri.ilu0_apply(L, U, r), iters=20)
    P2 = poisson2d(256)
    b2 = torch.from_numpy(np.random.default_rng(0).standard_normal(P2.n_rows)
                          .astype(np.float32)).to(dev)
    solve = lambda: st.cg(P2, b2, rtol=1e-6, M="ilu0", kind="csr_vector")
    solve()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, info = solve()
    torch.cuda.synchronize()
    out["cg_ilu0_ms_per_iter"] = (time.perf_counter() - t) * 1e3 / info["iters"]
    out["cg_ilu0_iters"] = info["iters"]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
