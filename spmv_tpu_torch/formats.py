"""Sparse matrix containers: COO and CSR.

Counterpart of `spmv_tpu/formats.py`. A matrix is a host container of
NumPy arrays: ``Aj.dtype`` is the index type, ``Ap.dtype`` the offset
type and ``Ax.dtype`` the value type; x and y dtypes are free at call
time. Kernels upload what they need (the stream plan) to the device of
``x``; the container itself never lives on a device.

bfloat16 values, which NumPy has no dtype of its own for, are taken as a
CPU ``torch.bfloat16`` tensor or as an ``ml_dtypes`` array (told by its
dtype's name; the port never imports ``ml_dtypes``). The host planners
carry them as their ``uint16`` bit patterns (``host_values``), so every
NumPy gather moves them bit for bit and the plan arrays equal the
reference's through a ``uint16`` view; ``as_values`` views the bits back
as ``torch.bfloat16`` where they are uploaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def is_bfloat16(v) -> bool:
    """True for a torch.bfloat16 tensor or dtype and for an array whose
    dtype is named bfloat16 (ml_dtypes', without importing it)."""
    dt = getattr(v, "dtype", v)
    return dt == torch.bfloat16 if isinstance(dt, torch.dtype) \
        else getattr(dt, "name", None) == "bfloat16"


def host_values(v) -> np.ndarray:
    """Values as a NumPy array for the host planners: bfloat16 as its
    uint16 bit patterns, a tensor as its NumPy array, anything else as
    np.asarray takes it."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if is_bfloat16(a) else a


def value_dtype(v) -> torch.dtype:
    """The torch dtype of a value array (bfloat16 for an ml_dtypes
    bfloat16 array)."""
    if isinstance(v, torch.Tensor):
        return v.dtype
    if is_bfloat16(v):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.asarray(v).dtype)).dtype


# The 2-byte floating dtypes, which the kernels widen to float32 on load
HALF_DTYPES = (torch.bfloat16, torch.float16)


def widen16(t: torch.Tensor) -> torch.Tensor:
    """t in float32 where it holds 2-byte floats, as the kernels widen
    them on load (exactly); any other tensor as it is. The plain versions
    compute on it and round to the value dtype once, where the kernel
    writes."""
    return t.float() if t.dtype in HALF_DTYPES else t


def float_values(v, dtype=np.float64) -> np.ndarray:
    """Values as a NumPy float array of `dtype` (bfloat16 widened)."""
    if is_bfloat16(v):
        return as_values(host_values(v), torch.bfloat16).float().numpy().astype(dtype)
    return np.asarray(v, dtype=dtype)


def as_values(t, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of `dtype` from values the host carried (`host_values`):
    bfloat16 bit patterns (uint16 or int16) are viewed as bfloat16, and
    NumPy arrays become CPU tensors."""
    if not isinstance(t, torch.Tensor):
        a = np.ascontiguousarray(t)
        t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)
    if dtype in (torch.bfloat16, torch.uint16) and t.dtype in (torch.int16,
                                                                 torch.uint16):
        return t.view(dtype)
    return t


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
    Ax: (nnz,) values: a NumPy array, or bfloat16 values as a CPU
    torch.bfloat16 tensor or an ml_dtypes array.
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

    @property
    def mean_nnz_per_row(self) -> float:
        return self.nnz / max(self.n_rows, 1)

    def row_lengths(self) -> np.ndarray:
        ap = np.asarray(self.Ap)
        return ap[1:] - ap[:-1]

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

    def transpose(self) -> "CSR":
        """A^T as CSR, by a stable counting sort over columns: the rows
        of A^T keep A's row order within each column."""
        coo = self.to_coo()
        flipped = COO(self.n_cols, self.n_rows, coo.cols, coo.rows, coo.vals)
        return coo_to_csr(flipped, offset_dtype=np.asarray(self.Ap).dtype,
                          index_dtype=np.asarray(self.Aj).dtype)

    def astype(self, value_dtype=None, index_dtype=None,
               offset_dtype=None) -> "CSR":
        """The same matrix with the given value, index and offset dtypes
        (None keeps that array as it is)."""
        Ap = np.asarray(self.Ap).astype(offset_dtype) if offset_dtype else self.Ap
        Aj = np.asarray(self.Aj).astype(index_dtype) if index_dtype else self.Aj
        Ax = np.asarray(self.Ax).astype(value_dtype) if value_dtype else self.Ax
        return CSR(self.n_rows, self.n_cols, Ap, Aj, Ax)


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


def csr_from_dense(dense: np.ndarray, index_dtype=np.int32,
                   offset_dtype=np.int32) -> CSR:
    """The nonzeros of a dense 2-D array as CSR, in row-major order."""
    dense = np.asarray(dense)
    rows, cols = np.nonzero(dense)
    coo = COO(dense.shape[0], dense.shape[1], rows.astype(index_dtype),
              cols.astype(index_dtype), dense[rows, cols])
    return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype)


def csr_to_dense(csr: CSR) -> np.ndarray:
    return csr.to_dense()
