"""Single-source shortest paths by min-plus semiring SpMV.

Counterpart of `examples/shortest_paths.py`. With the (min, +) ring,
y = A (x) d relaxes every edge once, and iterating to a fixed point is
Bellman-Ford. Distances live in a dense vector on `device`; inf is the
ring's identity. On a CUDA device each relaxation runs the stream
pipeline's kernels (K3 -> K5 -> K8 on a uniform-degree graph).

Run: python -m spmv_tpu_torch.examples.shortest_paths [n] [kind] [--device cpu]
(on the card unless --device says otherwise)
"""

from __future__ import annotations

import argparse
import heapq
import time

import numpy as np
import torch

from spmv_tpu_torch import MIN_PLUS, coo_to_csr, spmv
from spmv_tpu_torch.config import device_for
from spmv_tpu_torch.formats import COO


def random_graph(n: int, deg: int = 4, seed: int = 0):
    """`deg` out-edges per vertex to uniform random targets, weights in
    [0.1, 1), self-loops dropped, duplicate edges kept. Stored
    transposed, so that y[i] = min_j (A[i,j] + x[j]) relaxes the edges
    INTO i. The same CSR as the reference example's for the same seed."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    w = rng.uniform(0.1, 1.0, n * deg).astype(np.float32)
    keep = src != dst
    return coo_to_csr(COO(n, n, dst[keep], src[keep], w[keep]),
                      sum_duplicates=False)


def sssp(A, source: int, kind: str = "merge_genl", max_iter=None,
         device=None, on_relax=None):
    """Bellman-Ford from `source`: relax until the distances stop
    changing (torch.allclose, as the reference's np.allclose). Returns
    (distances on `device`, relaxations run); `device` is by default
    `config.default_device()`, the card unless the process asked for the
    CPU. `on_relax(d, relaxed)`, if given, sees each relaxation's input
    and SpMV output."""
    device = device_for(device, who="sssp", how='pass device="cpu" (--device cpu)')
    n = A.n_rows
    d = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    d[source] = 0.0
    if max_iter is None:
        max_iter = n
    for it in range(max_iter):
        relaxed = spmv(kind, A, d, semiring=MIN_PLUS)
        if on_relax is not None:
            on_relax(d, relaxed)
        nd = torch.minimum(d, relaxed)
        if torch.allclose(nd, d, equal_nan=True):
            return nd, it + 1
        d = nd
    return d, max_iter


def dijkstra_ref(A, source: int) -> np.ndarray:
    """Dijkstra on the host in float64, walking the out-edges (A holds
    in-edges); duplicate edges count by their least weight."""
    Ap, Aj, Ax = (np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))
    n = A.n_rows
    out = [[] for _ in range(n)]
    for i in range(n):
        for t in range(Ap[i], Ap[i + 1]):
            out[Aj[t]].append((i, float(Ax[t])))
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for v, w in out[u]:
            if d + w < dist[v]:
                dist[v] = d + w
                heapq.heappush(pq, (dist[v], v))
    return dist


def main(n: int = 2000, kind: str = "merge_genl", device=None):
    A = random_graph(n)
    device = device_for(device, who="shortest_paths", how="pass --device cpu")
    t0 = time.perf_counter()
    d, iters = sssp(A, 0, kind=kind, device=device)
    secs = time.perf_counter() - t0
    ref = dijkstra_ref(A, 0)
    reach = np.isfinite(ref)
    d = d.cpu().numpy()
    err = np.abs(d[reach] - ref[reach]).max() if reach.any() else 0.0
    print(f"n={n} kind={kind} device={device}: converged in {iters} "
          f"relaxations ({secs:.3f} s, first-call plan build included), "
          f"{int(reach.sum())}/{n} reachable, max |d - dijkstra| = {err:.2e}")
    assert err < 1e-4 and np.array_equal(np.isfinite(d), reach)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=2000)
    ap.add_argument("kind", nargs="?", default="merge_genl")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.n, args.kind, args.device)
