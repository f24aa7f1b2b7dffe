"""Interop: scipy.sparse and torch's sparse tensors.

Counterpart of `spmv_tpu/io/interop.py`. The SciPy pair is the
reference's; its BCOO pair (JAX's own sparse format) becomes
`from_torch_sparse`/`to_torch_sparse` on torch's sparse COO and CSR
tensors, so code already written against `torch.sparse` can hand its
matrices to the port's kinds. The converters keep dtypes; SciPy is
imported lazily, so the package works without it.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.config import device_for
from spmv_tpu_torch.formats import COO, CSR, coo_to_csr


def _scipy_sparse():
    try:
        import scipy.sparse as sp
        return sp
    except ImportError as e:  # pragma: no cover - scipy is installed
        raise ImportError(
            "scipy is required for scipy.sparse interop") from e


def from_scipy(mat, *, offset_dtype=None, index_dtype=None) -> CSR:
    """Any scipy.sparse matrix/array -> CSR.

    Non-CSR inputs are converted by scipy's own tocsr() (which sums
    duplicates, matching scipy semantics). Index/offset dtypes default
    to whatever scipy used (int32 or int64 by size).
    """
    sp = _scipy_sparse()
    if not sp.issparse(mat):
        raise TypeError(f"expected a scipy.sparse matrix, got {type(mat)}")
    m = mat.tocsr()
    m.sort_indices()
    Ap = np.asarray(m.indptr)
    Aj = np.asarray(m.indices)
    if offset_dtype is not None:
        Ap = Ap.astype(offset_dtype)
    if index_dtype is not None:
        Aj = Aj.astype(index_dtype)
    return CSR(int(m.shape[0]), int(m.shape[1]), Ap, Aj,
               np.asarray(m.data))


def to_scipy(A: CSR):
    """CSR -> scipy.sparse.csr_matrix (shares no plan state; plain copy)."""
    sp = _scipy_sparse()
    return sp.csr_matrix(
        (np.asarray(A.Ax), np.asarray(A.Aj), np.asarray(A.Ap)),
        shape=(A.n_rows, A.n_cols))


def from_torch_sparse(mat: torch.Tensor, *, offset_dtype=np.int32,
                      index_dtype=None, sum_duplicates: bool = True) -> CSR:
    """A 2-D torch sparse tensor (COO or CSR layout, on any device) -> CSR.

    A COO tensor may hold unsorted and duplicated coordinates; duplicates
    are summed by default (what its own matvec computes), as the
    reference's `from_bcoo` does. Batched and hybrid tensors (sparse
    dims other than 2, or dense dims) are refused."""
    if mat.layout not in (torch.sparse_coo, torch.sparse_csr):
        raise ValueError(f"expected a sparse COO or CSR tensor, got layout {mat.layout}")
    if mat.ndim != 2 or mat.sparse_dim() != 2 or mat.dense_dim() != 0:
        raise ValueError(
            "only plain 2-D unbatched sparse tensors are supported, got "
            f"ndim={mat.ndim}, sparse_dim={mat.sparse_dim()}, "
            f"dense_dim={mat.dense_dim()}")
    if mat.layout == torch.sparse_coo:
        idx = mat._indices().cpu().numpy()  # as stored, duplicates kept
        rows, cols = idx[0], idx[1]
        vals = mat._values().cpu().numpy()
    else:
        crow = mat.crow_indices().cpu().numpy().astype(np.int64)
        cols = mat.col_indices().cpu().numpy()
        rows = np.repeat(np.arange(mat.shape[0], dtype=np.int64), np.diff(crow))
        vals = mat.values().cpu().numpy()
    coo = COO(int(mat.shape[0]), int(mat.shape[1]),
              rows.astype(np.int64), cols.astype(np.int64), vals)
    return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype,
                      sum_duplicates=sum_duplicates)


def to_torch_sparse(A: CSR, layout=torch.sparse_csr, device=None) -> torch.Tensor:
    """CSR -> a torch sparse tensor in `layout` (sparse_csr or sparse_coo,
    sorted indices) on `device`, by default `config.default_device()`
    (the card unless the process asked for the CPU, as the reference's
    `to_bcoo` puts it on JAX's default device), values in A's dtype."""
    dev = device_for(device, who="to_torch_sparse", how='pass device="cpu"')
    Ap = torch.from_numpy(np.asarray(A.Ap, np.int64))
    Aj = torch.from_numpy(np.asarray(A.Aj, np.int64))
    Ax = torch.from_numpy(np.ascontiguousarray(A.Ax))
    if layout == torch.sparse_csr:
        out = torch.sparse_csr_tensor(Ap, Aj, Ax, size=A.shape)
    elif layout == torch.sparse_coo:
        rows = torch.from_numpy(A.row_ids().astype(np.int64))
        out = torch.sparse_coo_tensor(torch.stack([rows, Aj]), Ax, size=A.shape)
    else:
        raise ValueError(f"layout must be torch.sparse_csr or torch.sparse_coo, "
                         f"got {layout}")
    return out.to(dev)
