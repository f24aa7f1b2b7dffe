"""Matrix reordering: reverse Cuthill-McKee and permutation application.

Counterpart of `spmv_tpu/ops/reorder.py`, line for line: the same
permutations bit for bit. A smaller bandwidth means fewer distinct x
windows per gather tile (the stream planner routes by column window,
kernels/stream.py) and shorter halo lists in the multi-device partition
(parallel/partition.py). It is not a triangular-solve optimization: a
band's lower triangle is one long dependency chain, the worst case for
the level schedule of kernels/trisolve.py.

Pure host NumPy (reordering is a plan-time, run-once step) with its own
BFS; no SciPy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from spmv_tpu_torch.formats import CSR, COO, coo_to_csr


def _symmetric_pattern(A: CSR) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacency of the symmetrized pattern |A| + |A|^T (no self loops)
    as (indptr, indices), deduplicated, neighbors sorted by id."""
    if A.n_rows != A.n_cols:
        raise ValueError("RCM needs a square matrix "
                         f"(got {A.n_rows}x{A.n_cols})")
    n = A.n_rows
    rows = A.row_ids().astype(np.int64)
    cols = np.asarray(A.Aj, dtype=np.int64)
    off = rows != cols
    u = np.concatenate([rows[off], cols[off]])
    v = np.concatenate([cols[off], rows[off]])
    # dedup (u,v) pairs
    key = u * n + v
    uniq = np.unique(key)
    u = (uniq // n).astype(np.int64)
    v = (uniq % n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, v


def rcm_permutation(A: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of A's symmetrized pattern.

    Returns ``perm`` with ``perm[k]`` = the original index placed at
    position k of the new ordering. Handles disconnected graphs
    (each component seeded from its minimum-degree vertex).
    """
    indptr, adj = _symmetric_pattern(A)
    n = A.n_rows
    deg = np.diff(indptr)
    order = np.empty(n, np.int64)
    visited = np.zeros(n, bool)
    pos = 0
    # visit components in min-degree-seed order
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        # BFS from s, neighbors in increasing-degree order
        order[pos] = s
        visited[s] = True
        head, tail = pos, pos + 1
        pos += 1
        while head < tail:
            u = order[head]
            head += 1
            nbrs = adj[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[tail:tail + nbrs.size] = nbrs
                tail += nbrs.size
        pos = tail
    return order[::-1].copy()


def bandwidth(A: CSR) -> int:
    """max |i - j| over stored entries (0 for an empty matrix)."""
    if A.nnz == 0:
        return 0
    rows = A.row_ids().astype(np.int64)
    cols = np.asarray(A.Aj, dtype=np.int64)
    return int(np.abs(rows - cols).max())


def permute(A: CSR, row_perm: np.ndarray,
            col_perm: Optional[np.ndarray] = None) -> CSR:
    """PAQ^T: reorder rows by ``row_perm`` and relabel columns by
    ``col_perm`` (defaults to ``row_perm`` — the symmetric permutation
    RCM wants). ``perm[k]`` = original index at new position k.
    Preserves Ap/Aj/Ax dtypes; per-row entries re-sorted by column.
    """
    row_perm = np.asarray(row_perm, np.int64)
    if col_perm is None:
        col_perm = row_perm
    col_perm = np.asarray(col_perm, np.int64)
    if row_perm.shape != (A.n_rows,) or col_perm.shape != (A.n_cols,):
        raise ValueError("permutation length mismatch")
    inv_col = np.empty(A.n_cols, np.int64)
    inv_col[col_perm] = np.arange(A.n_cols)

    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj)
    Ax = np.asarray(A.Ax)
    lens = (Ap[1:] - Ap[:-1])[row_perm]
    new_rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), lens)
    # gather source nnz ranges in new row order, vectorized:
    # idx[k] = starts[row(k)] + (k - new_row_start(k))
    starts = Ap[row_perm]
    out_starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = (np.repeat(starts - out_starts, lens)
           + np.arange(int(lens.sum()), dtype=np.int64))
    new_cols = inv_col[Aj[idx].astype(np.int64)]
    coo = COO(A.n_rows, A.n_cols, new_rows, new_cols, Ax[idx])
    return coo_to_csr(coo, offset_dtype=np.asarray(A.Ap).dtype,
                      index_dtype=np.asarray(A.Aj).dtype)


def rcm_reorder(A: CSR) -> Tuple[CSR, np.ndarray]:
    """Convenience: RCM-permute A symmetrically; returns (PAP^T, perm).

    ``spmv(kind, PAPt, x[perm]) == spmv(kind, A, x)[perm]``.
    """
    perm = rcm_permutation(A)
    return permute(A, perm), perm
