"""Solve a 2-D Poisson system with CG, end to end.

Counterpart of `examples/solve_poisson.py`. Builds the standard 5-point
Laplacian on an m x m grid as CSR and solves A x = b (b from
`default_rng(0)`) with the port's conjugate-gradient solver, whose
matvecs dispatch through the registry on `device`, without
preconditioning, with Jacobi and with ILU(0) (host factorization, two
level-scheduled triangular solves per iteration on `device`). With
`kind="csr_vector"` the matvec runs the DIA kind: one K12 launch per
matvec on a CUDA device. It prints the iterations, the recursive
residual, and the true residual computed on the host in float64.

Run: python -m spmv_tpu_torch.examples.solve_poisson [m] [kind] [--device cpu]
(on the card unless --device says otherwise)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from spmv_tpu_torch import coo_to_csr
from spmv_tpu_torch.formats import COO
from spmv_tpu_torch.ops.reference import spmv_ref
from spmv_tpu_torch.solvers import cg


def poisson2d(m: int):
    """The 5-point Laplacian on an m x m grid: 4 on the diagonal, -1 to
    each grid neighbour; the same CSR as the reference example's."""
    n = m * m
    k = np.arange(n)
    i, j = k // m, k % m
    rows = [k]
    cols = [k]
    vals = [np.full(n, 4.0, np.float32)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < m) & (jj >= 0) & (jj < m)
        rows.append(k[ok])
        cols.append((ii * m + jj)[ok])
        vals.append(np.full(ok.sum(), -1.0, np.float32))
    return coo_to_csr(COO(n, n, np.concatenate(rows), np.concatenate(cols),
                          np.concatenate(vals)))


def true_relative_residual(A, b: np.ndarray, x: np.ndarray) -> float:
    """||b - A x|| / ||b|| in float64 on the host."""
    r = b.astype(np.float64) - spmv_ref(A, x, y_dtype=np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64)))


def main(m: int = 64, kind: str = "xla", device: str = "cuda",
         maxiter: int = 5000) -> list:
    A = poisson2d(m)
    b_np = np.random.default_rng(0).standard_normal(A.n_rows).astype(np.float32)
    b = torch.from_numpy(b_np).to(device)
    print(f"Poisson {m}x{m}: n={A.n_rows} nnz={A.nnz}, kind={kind}, device={device}")
    out = []
    for i, M in enumerate((None, "jacobi", "ilu0")):
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = cg(A, b, rtol=1e-6, maxiter=maxiter, M=M, kind=kind)
        x_np = x.cpu().numpy()
        secs = time.perf_counter() - t0
        rel = true_relative_residual(A, b_np, x_np)
        print(f"  M={M!s:6}: {info['iters']:4d} iters  resnorm={info['resnorm']:.3e}  "
              f"true ||r||/||b||={rel:.3e} (float64)  {secs:.2f}s"
              + ("" if i else " (includes the plan build)")
              + (" (includes the factorization)" if M == "ilu0" else ""))
        out.append({"M": M, "info": info, "true_rel_residual": rel, "seconds": secs})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", nargs="?", type=int, default=64)
    ap.add_argument("kind", nargs="?", default="xla")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.m, args.kind, args.device)
