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
index_add_ kernels by which a tree without K16 folds plus-times), the
fold's kernel launches a call, the memsets' device time and count a call
(K16's look-back records and identity fill; no other kernel of these
paths memsets), and whether ten calls gave y bit for bit.
Then K16 alone (`kernels/fold.py:_launch`, where the tree has it) on the
path's largest fold, its inputs recorded from one call: ms alone with
its wrapper (median of 20), back to back (20 an event pair, median of
10), its device µs a launch (the profiler over 20 launches: its kernels
and memsets), its launches a call, and its bound (vals, seg and perm
read once, y written once, at 3.35 TB/s). Paths: `csr_vector_ell` and `xla` on
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
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate at 700 W


def _nbytes(*ts):
    import torch

    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _profile(fn, calls):
    """(device µs a call over every kernel and memset, over the fold's
    kernels, the fold's kernel launches a call, over the memsets, the
    memsets a call) by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = fold = launched = memset = memsets = 0.0
    for e in prof.key_averages():
        if e.key.startswith(("aten::", "cuda")):
            continue
        busy += e.self_device_time_total
        if any(s in e.key for s in FOLD_STEMS):
            fold += e.self_device_time_total
            launched += e.count
        if e.key.startswith("Memset"):
            memset += e.self_device_time_total
            memsets += e.count
    return busy / calls, fold / calls, launched / calls, memset / calls, memsets / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("time_fold_torch: no card", file=sys.stderr)
        return 2
    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.kernels import fold as tfold
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
    launch = getattr(tfold, "_launch", None)
    for name, fn in paths.items():
        y = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(fn(), y) for _ in range(10))
        ms = cuda_time_ms(fn, iters=20)["median_ms"]
        busy, fold, launched, memset, memsets = _profile(fn, 10)
        row = {"ms": ms, "busy_ms": busy / 1e3, "fold_ms": fold / 1e3,
               "fold_kernels_a_call": launched, "memset_ms": memset / 1e3,
               "memsets_a_call": memsets, "ten_calls_bit_for_bit": same}
        seen = []
        if launch is not None:
            tfold._launch = lambda *a: seen.append(a) or launch(*a)
            try:
                fn()
            finally:
                tfold._launch = launch
        if launch is not None and seen:  # a replayed graph calls no wrapper
            vals, seg, n_seg, code, ident, perm = max(seen, key=lambda a: a[0].numel())
            k16 = lambda: launch(vals, seg, n_seg, code, ident, perm)  # noqa: E731
            y = k16()
            moved = _nbytes(vals if perm is None else vals[:seg.numel()], seg, perm, y)
            _, dev_us, per, _, _ = _profile(k16, 20)
            busy_us = _profile(k16, 20)[0]
            row["k16"] = {
                "n": seg.numel(), "B": 1 if vals.dim() == 1 else vals.shape[1],
                "n_segments": n_seg, "folds_a_call": len(seen),
                "alone_ms": cuda_time_ms(k16, iters=20)["median_ms"],
                "b2b_ms": cuda_time_ms(k16, iters=10, batch=20)["median_ms"],
                "device_us": dev_us, "device_with_memsets_us": busy_us,
                "kernels_a_launch": per, "bound_us": moved / HBM_BYTES_PER_S * 1e6}
        out["paths"][name] = row
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
