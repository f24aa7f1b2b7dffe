"""PageRank as repeated SpMV.

Counterpart of `examples/pagerank.py`. rank_{t+1} = d * P^T rank_t +
teleport, with P the row-stochastic out-link matrix of a power-law
directed graph; the dangling nodes' mass is spread uniformly, so the
ranks stay a probability distribution. Every iteration is one registry
SpMV on `device` (pick the kind with --kind; `stream` by default, which
on a CUDA device runs K1 -> K2 -> K5 -> K6 where the plan reduces early)
and one host sync, for the convergence test.

Run: python -m spmv_tpu_torch.examples.pagerank [--kind stream]
     [--nodes 100000] [--edges 1000000] [--device cpu]
(on the card unless --device says otherwise)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from spmv_tpu_torch import spmv
from spmv_tpu_torch.config import device_for
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.io.generate import power_law_csr


def pagerank(A_t, out_deg, kind: str, damping=0.85, tol=1e-8,
             max_iters=200, device=None):
    """Ranks of the graph whose TRANSPOSED link matrix is A_t, on
    `device` (by default `config.default_device()`, the card unless the
    process asked for the CPU).

    A_t[i, j] = 1/out_deg(j) for each edge j->i (column-stochastic after
    the dangling fixup). Returns (ranks, iterations)."""
    device = device_for(device, who="pagerank", how='pass device="cpu" (--device cpu)')
    n = A_t.n_rows
    dangling = torch.from_numpy(out_deg == 0).to(device)
    any_dangling = bool((out_deg == 0).any())
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    for it in range(1, max_iters + 1):
        # dangling nodes spread their mass uniformly
        d_mass = torch.where(dangling, r, 0.0).sum() if any_dangling else 0.0
        r_new = damping * spmv(kind, A_t, r) + (
            (1.0 - damping) / n + damping * d_mass / n)
        delta = float((r_new - r).abs().sum())
        r = r_new
        if delta < tol:
            return r, it
    return r, max_iters


def build(nodes: int, edges: int):
    """The reference example's graph: power-law, alpha 1.6, seed 7, with
    edge weights 1/out_deg(src). Returns (W, A_t = W^T, out_deg)."""
    G = power_law_csr(nodes, nodes, edges, alpha=1.6, seed=7)
    out_deg = G.row_lengths()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1), 0.0)
    W = CSR(G.n_rows, G.n_cols, G.Ap, G.Aj,
            np.repeat(inv, out_deg).astype(np.float32))
    return W, W.transpose(), out_deg


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kind", default="stream")
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=1_000_000)
    p.add_argument("--damping", type=float, default=0.85)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    device = device_for(args.device, who="pagerank", how="pass --device cpu")
    W, A_t, out_deg = build(args.nodes, args.edges)
    print(f"graph: {args.nodes} nodes, {W.nnz} edges; kind={args.kind}, "
          f"device={device}", flush=True)

    t0 = time.perf_counter()
    r, iters = pagerank(A_t, out_deg, args.kind, damping=args.damping,
                        device=device)
    r = r.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"converged in {iters} iterations ({dt:.2f}s, "
          f"{dt/iters*1e3:.1f} ms/iter, first-call plan build included)")
    print(f"rank sum={r.sum():.6f} (should be ~1)")
    top = np.argsort(r)[::-1][:5]
    print("top nodes:", ", ".join(f"{i}={r[i]:.2e}" for i in top))

    # the dense NumPy power iteration (small graphs only: the dense
    # operator is O(nodes^2) memory)
    if args.nodes <= 4000:
        P = W.to_dense().T
        rd = np.full(args.nodes, 1.0 / args.nodes)
        for _ in range(iters):
            dm = rd[out_deg == 0].sum()
            rd = args.damping * (P @ rd) + (
                (1 - args.damping) / args.nodes
                + args.damping * dm / args.nodes)
        err = np.abs(rd - r).max()
        print(f"dense-oracle max abs diff: {err:.2e}")
        assert err < 1e-5
    return {"ranks": r, "iters": iters, "seconds": dt, "A_t": A_t,
            "out_deg": out_deg}


if __name__ == "__main__":
    main()
