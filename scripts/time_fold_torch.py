"""Time the paths that end in the sorted-segment row fold from one checkout
of the repo, so that two commits can be compared on one card within one
call.

    python scripts/time_fold_torch.py --tree DIR --label NAME

imports `spmv_tpu_torch` from DIR (the repo's root or an unpacked `git
archive` of another commit) and prints one JSON line: the card's name and
power limit and, for each path, the ms of a call (CUDA events, the median
of 20 calls alone after warm-up), its device busy time a call and the part
of it in the fold's kernels (torch.profiler over 10 calls: K16's
`fold_fill_kernel`, `fold_rows_kernel` and `fold_cols_kernel`, or the
index_add_ kernels by which a tree without K16 folds plus-times), and
whether ten calls gave y bit for bit. Paths: `csr_vector_ell` and `xla` on
bench
(power_law_csr(1<<20, 1<<20, 3.3M, alpha 1.5, seed 42)), `spmm` by window
and by gather at B = 128 and `spmv_values` on the arxiv-size graph
(power_law_csr(169343, 169343, 1166243, alpha 1.5, seed 0)), and
`distribute_csr` on a 4-shard local mesh of bench, by replay (its
`matvec`) and eagerly. Run parent, change, change, parent in one call,
each in its own process. It imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FOLD_STEMS = ("fold_rows_kernel", "fold_cols_kernel", "fold_fill_kernel", "indexFunc",
              "index_add")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_fold_torch: no card", file=sys.stderr)
        return 2
    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.ops.autodiff import spmv_values
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {"label": args.label, "tree": args.tree, "card": card, "paths": {}}
    A = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n_cols)
                         .astype(np.float32)).to(dev)
    G = power_law_csr(169_343, 169_343, 1_166_243, alpha=1.5, seed=0)
    rng = np.random.default_rng(15)
    X = torch.from_numpy(rng.standard_normal((G.n_cols, 128)).astype(np.float32)).to(dev)
    xg = torch.from_numpy(rng.standard_normal(G.n_cols).astype(np.float32)).to(dev)
    Gx = torch.from_numpy(np.asarray(G.Ax, np.float32)).to(dev)
    d4 = distribute_csr(A, make_mesh("shards", n_shards=4, device=dev))
    paths = {
        "csr_vector_ell bench": lambda: st.spmv("csr_vector_ell", A, x),
        "xla bench": lambda: st.spmv("xla", A, x),
        "spmm window arxiv B128": lambda: st.spmm(G, X, method="window"),
        "spmm xla arxiv B128": lambda: st.spmm(G, X, method="xla"),
        "spmv_values arxiv": lambda: spmv_values(G, Gx, xg),
        "distribute_csr bench 4 shards replay": lambda: d4.matvec(x),
        "distribute_csr bench 4 shards eager": lambda: d4._matvec_eager(x),
    }
    for name, fn in paths.items():
        y = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(fn(), y) for _ in range(10))
        ms = cuda_time_ms(fn, iters=20)["median_ms"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        busy = fold = 0.0
        for e in prof.key_averages():
            if e.key.startswith(("aten::", "cuda")):
                continue
            busy += e.self_device_time_total
            if any(s in e.key for s in FOLD_STEMS):
                fold += e.self_device_time_total
        out["paths"][name] = {"ms": ms, "busy_ms": busy / 10 / 1e3,
                              "fold_ms": fold / 10 / 1e3, "ten_calls_bit_for_bit": same}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
