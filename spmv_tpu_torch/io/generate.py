"""Synthetic sparse-matrix generators for tests and benchmarks.

Counterpart of `spmv_tpu/io/generate.py`: the same NumPy generator
calls in the same order, so a seed gives the same CSR, bit for bit, in
both packages.

- banded / regular rows   -> csr-vector-friendly
- uniform random          -> gather-bandwidth stress
- power-law               -> load-imbalance stress (merge-path territory)
- Kronecker (R-MAT) graph -> the heavy-tailed degrees of Graph500's graphs
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.formats import COO, CSR, coo_to_csr


def _finish(rows, cols, vals, n_rows, n_cols, index_dtype, offset_dtype, value_dtype):
    coo = COO(n_rows, n_cols, rows.astype(index_dtype), cols.astype(index_dtype),
              vals.astype(value_dtype))
    return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype)


def random_csr(n_rows: int, n_cols: int, nnz: int, seed: int = 0,
               value_dtype=np.float32, index_dtype=np.int32,
               offset_dtype=np.int32) -> CSR:
    """Uniformly random coordinates (duplicates allowed, like real COO data)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz, dtype=np.int64)
    cols = rng.integers(0, n_cols, nnz, dtype=np.int64)
    vals = rng.standard_normal(nnz)
    return _finish(rows, cols, vals, n_rows, n_cols, index_dtype, offset_dtype, value_dtype)


def banded_csr(n: int, bandwidth: int = 5, seed: int = 0,
               value_dtype=np.float32, index_dtype=np.int32,
               offset_dtype=np.int32) -> CSR:
    """Square banded matrix: each row has entries in [i-b, i+b]."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), offs.size)
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size)
    return _finish(rows, cols, vals, n, n, index_dtype, offset_dtype, value_dtype)


def power_law_csr(n_rows: int, n_cols: int, nnz: int, alpha: float = 1.5,
                  seed: int = 0, value_dtype=np.float32,
                  index_dtype=np.int32, offset_dtype=np.int32) -> CSR:
    """Row degrees ~ Zipf(alpha): a few huge rows, a long tail of tiny ones."""
    rng = np.random.default_rng(seed)
    w = (1.0 + np.arange(n_rows)) ** (-alpha)
    rng.shuffle(w)
    p = w / w.sum()
    rows = rng.choice(n_rows, size=nnz, p=p).astype(np.int64)
    cols = rng.integers(0, n_cols, nnz, dtype=np.int64)
    vals = rng.standard_normal(nnz)
    return _finish(rows, cols, vals, n_rows, n_cols, index_dtype, offset_dtype, value_dtype)


def kron_graph_csr(
    scale: int,
    edge_factor: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    value_dtype=np.float32,
    index_dtype=np.int32,
    offset_dtype=np.int32,
) -> CSR:
    """Graph500-style stochastic Kronecker (R-MAT) generator.

    n = 2**scale vertices, nnz ≈ edge_factor * n directed edges.
    Produces the heavy-tailed degree distribution of the 'kron'
    SuiteSparse family named in BASELINE.json.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r_bit = rng.random(m) > ab
        c_bit = rng.random(m) > np.where(r_bit, c_norm, a_norm)
        rows |= r_bit.astype(np.int64) << bit
        cols |= c_bit.astype(np.int64) << bit
    vals = rng.standard_normal(m)
    return _finish(rows, cols, vals, n, n, index_dtype, offset_dtype, value_dtype)
