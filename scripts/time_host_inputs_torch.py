"""Time the port's entry points on host (NumPy) inputs from one checkout of
the repo, so that two commits can be compared on one card within one call.

    python scripts/time_host_inputs_torch.py --tree DIR --label NAME

imports `spmv_tpu_torch` from DIR (the repo's root or an unpacked `git
archive` of another commit) and prints one JSON line: the card's name and
power limit, where a NumPy x and b were computed on, the host-clock
median of `spmv("stream", bench, x_np)` calls (bench: power_law_csr(1<<20,
1<<20, 3.3M, alpha 1.5, seed 42); its plan built and cached by a first
call) and the host-clock time of one `cg(poisson2d(1024), b_np, rtol 1e-6,
kind "csr_vector")` solve after a one-iteration solve that builds its
plans (and, on the card, captures its chunk graph). Each timed call ends
in a device synchronize. A tree that puts NumPy inputs on the CPU times
the plain versions there. Run parent, change, change, parent in one call,
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
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("time_host_inputs_torch: no card", file=sys.stderr)
        return 2
    import spmv_tpu_torch as st
    from spmv_tpu_torch.examples.solve_poisson import poisson2d
    from spmv_tpu_torch.io.generate import power_law_csr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    out = {"label": args.label, "tree": args.tree, "card": card}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    A = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x_np = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    y, out["spmv_first_ms"] = timed(lambda: st.spmv("stream", A, x_np))
    out["spmv_device"] = str(y.device)
    ms = [timed(lambda: st.spmv("stream", A, x_np))[1] for _ in range(args.calls)]
    out["spmv_ms"] = float(np.median(ms))
    out["spmv_ms_all"] = ms

    P = poisson2d(1024)
    b_np = np.random.default_rng(0).standard_normal(P.n_rows).astype(np.float32)
    _, out["cg_setup_ms"] = timed(lambda: st.cg(P, b_np, rtol=1e-6, maxiter=1,
                                                kind="csr_vector"))
    (x, info), out["cg_ms"] = timed(lambda: st.cg(P, b_np, rtol=1e-6, maxiter=10000,
                                                  kind="csr_vector"))
    out["cg_device"] = str(x.device)
    out["cg_iters"] = info["iters"]
    out["cg_converged"] = info["converged"]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
