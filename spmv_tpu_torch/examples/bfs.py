"""Breadth-first search by boolean (or, and) semiring SpMV.

Counterpart of `examples/bfs.py`. One BFS level is one SpMV of the
frontier's indicator vector under the boolean ring: y[i] = OR_j
(A^T[i,j] AND f[j]) marks every vertex with an in-edge from the
frontier. The frontier lives on `device`; `merge_genl` on float32 runs
the or-and ring as a counting ring on the plus-times stream kernels
(K3 -> K5 -> K6 on this graph's transpose), and each level brings the
new vertices to the host.

Run: python -m spmv_tpu_torch.examples.bfs [--kind merge_genl]
     [--nodes 20000] [--edges 120000] [--device cpu]
(on the card unless --device says otherwise)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from spmv_tpu_torch import OR_AND, spmv
from spmv_tpu_torch.config import device_for
from spmv_tpu_torch.io.generate import power_law_csr


def bfs(A_t, source: int, kind: str, device=None):
    """BFS levels on the graph whose transposed adjacency is A_t, the
    frontier on `device` (by default `config.default_device()`, the card
    unless the process asked for the CPU).

    Returns (level, depth): level[i] = hop distance from source (-1 if
    unreachable), depth the eccentricity of the source."""
    device = device_for(device, who="bfs", how='pass device="cpu" (--device cpu)')
    n = A_t.n_rows
    level = np.full(n, -1, np.int32)
    level[source] = 0
    frontier = torch.zeros((n,), dtype=torch.float32, device=device)
    frontier[source] = 1.0
    visited = frontier
    for depth in range(1, n):
        reached = spmv(kind, A_t, frontier, semiring=OR_AND)
        frontier = torch.where(visited > 0, 0.0, reached)
        new = torch.nonzero(frontier > 0).flatten().cpu().numpy()
        if new.size == 0:
            return level, depth - 1
        level[new] = depth
        visited = torch.maximum(visited, frontier)
    return level, n


def bfs_ref(A_t, source: int):
    """Host BFS over the same in-edge CSR (adjacency-list queue walk)."""
    Ap, Aj = np.asarray(A_t.Ap), np.asarray(A_t.Aj)
    n = A_t.n_rows
    # invert the in-edge structure back to out-edges once
    out = [[] for _ in range(n)]
    for i in range(n):
        for t in range(Ap[i], Ap[i + 1]):
            out[Aj[t]].append(i)
    level = np.full(n, -1, np.int32)
    level[source] = 0
    q = [source]
    while q:
        nq = []
        for u in q:
            for v in out[u]:
                if level[v] < 0:
                    level[v] = level[u] + 1
                    nq.append(v)
        q = nq
    return level


def build(nodes: int, edges: int, source: int = -1):
    """The reference example's graph (power-law, alpha 1.6, seed 5) as
    A_t = G^T, and the source (default: the hub of largest out-degree)."""
    G = power_law_csr(nodes, nodes, edges, alpha=1.6, seed=5)
    A_t = G.transpose()  # y = A^T f expands the frontier along out-edges
    if source < 0:
        source = int(np.argmax(G.row_lengths()))
    return G, A_t, source


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kind", default="merge_genl")
    p.add_argument("--nodes", type=int, default=20_000)
    p.add_argument("--edges", type=int, default=120_000)
    p.add_argument("--source", type=int, default=-1,
                   help="source vertex (default: max out-degree hub)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    device = device_for(args.device, who="bfs", how="pass --device cpu")
    G, A_t, source = build(args.nodes, args.edges, args.source)
    print(f"graph: {args.nodes} nodes, {G.nnz} edges; kind={args.kind}, "
          f"source={source}, device={device}", flush=True)

    t0 = time.perf_counter()
    level, depth = bfs(A_t, source, args.kind, device=device)
    dt = time.perf_counter() - t0
    reach = int((level >= 0).sum())
    print(f"BFS done: eccentricity {depth}, {reach} reachable "
          f"({dt:.2f}s, {dt/max(depth,1)*1e3:.1f} ms/level, first-call plan "
          f"build included)")

    ref = bfs_ref(A_t, source)
    assert np.array_equal(level, ref), "levels disagree with host BFS"
    print("host-BFS oracle: exact match")
    return {"level": level, "depth": depth, "seconds": dt, "A_t": A_t,
            "source": source}


if __name__ == "__main__":
    main()
