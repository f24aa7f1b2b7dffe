"""Sparse matrix containers: COO and CSR.

Counterpart of `spmv_tpu/formats.py`. A matrix is a host container of
NumPy arrays: ``Aj.dtype`` is the index type, ``Ap.dtype`` the offset
type and ``Ax.dtype`` the value type; x and y dtypes are free at call
time. Kernels upload what they need (the stream plan) to the device of
``x``; the container itself never lives on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(eq=False)  # identity hash: containers key plan caches
class COO:
    """Coordinate-format sparse matrix: parallel 1-D rows/cols/vals."""

    n_rows: int
    n_cols: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def to_dense(self) -> np.ndarray:
        vals = np.asarray(self.vals)
        d = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        np.add.at(d, (np.asarray(self.rows), np.asarray(self.cols)), vals)
        return d


@dataclasses.dataclass(eq=False)  # identity hash: containers key plan caches
class CSR:
    """Compressed-sparse-row matrix.

    Ap: (n_rows+1,) row offsets (int64 when nnz may exceed int32).
    Aj: (nnz,) column indices.
    Ax: (nnz,) values.
    """

    n_rows: int
    n_cols: int
    Ap: np.ndarray
    Aj: np.ndarray
    Ax: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.Aj.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def row_ids(self) -> np.ndarray:
        """Per-nnz row index (the COO row array of this CSR)."""
        ap = np.asarray(self.Ap).astype(np.int64)
        return np.repeat(np.arange(self.n_rows, dtype=np.asarray(self.Aj).dtype),
                         ap[1:] - ap[:-1])

    def to_coo(self) -> COO:
        return COO(self.n_rows, self.n_cols, self.row_ids(),
                   np.asarray(self.Aj), np.asarray(self.Ax))

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()


def coo_to_csr(
    coo: COO,
    offset_dtype=np.int32,
    index_dtype=None,
    sum_duplicates: bool = False,
) -> CSR:
    """COO -> CSR by a stable counting sort over rows (per-row input
    order kept; duplicates kept unless `sum_duplicates`). Gives the
    same arrays as `spmv_tpu.formats.coo_to_csr` for the same input."""
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols)
    vals = np.asarray(coo.vals)
    n_rows, n_cols = coo.n_rows, coo.n_cols
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("COO row index out of range")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("COO col index out of range")

    # native stable counting sort when available, NumPy stable argsort
    # otherwise; both keep per-row input order
    order = None
    i32max = np.iinfo(np.int32).max
    if n_rows <= i32max and n_cols <= i32max and np.issubdtype(cols.dtype, np.integer):
        try:
            from spmv_tpu_torch import native

            if native.available():
                Ap, Aj_n, order = native.coo_to_csr_perm(n_rows, rows, cols)
                Aj = Aj_n.astype(cols.dtype, copy=False)
                Ax = vals[order]
        except (NotImplementedError, ValueError):
            order = None
    if order is None:
        counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
        Ap = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=Ap[1:])
        order = np.argsort(rows, kind="stable")
        Aj = cols[order]
        Ax = vals[order]

    if sum_duplicates:
        order2 = np.lexsort((Aj, rows[order]))
        r2, j2, x2 = rows[order][order2], Aj[order2], Ax[order2]
        key_change = np.empty(r2.size, dtype=bool)
        if r2.size:
            key_change[0] = True
        key_change[1:] = (r2[1:] != r2[:-1]) | (j2[1:] != j2[:-1])
        group = np.cumsum(key_change) - 1
        n_groups = int(group[-1]) + 1 if r2.size else 0
        Ax_m = np.zeros(n_groups, dtype=x2.dtype)
        np.add.at(Ax_m, group, x2)
        Aj = j2[key_change]
        counts = np.bincount(r2[key_change], minlength=n_rows).astype(np.int64)
        Ap = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=Ap[1:])
        Ax = Ax_m

    if index_dtype is None:
        index_dtype = cols.dtype
    max_off = int(Ap[-1])
    if np.dtype(offset_dtype) == np.int32 and max_off > i32max:
        raise OverflowError(
            f"nnz={max_off} overflows int32 offsets; pass offset_dtype=np.int64")
    return CSR(n_rows, n_cols, Ap.astype(offset_dtype), Aj.astype(index_dtype), Ax)


def csr_to_dense(csr: CSR) -> np.ndarray:
    return csr.to_dense()
