"""CPU reference oracle for SpMV, plain and semiring-generalized.

Counterpart of `spmv_tpu/ops/reference.py`: y = A x accumulated in
float64 for the plain ring, and the semiring oracle computed in the
value dtype. Host NumPy; it never touches a device.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.ops.semiring import Semiring, PLUS_TIMES

_REDUCEAT = {"plus_times": np.add, "min_plus": np.minimum,
             "max_times": np.maximum, "or_and": np.maximum}


def spmv_ref(A: CSR, x, y_dtype=None) -> np.ndarray:
    """Plain (+, x) CSR SpMV oracle. Accumulates in float64 whatever
    the storage dtype, so it is more accurate than any device kernel."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = np.asarray(A.Ax, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    prod = Ax * x[Aj]
    y = np.zeros(A.n_rows, dtype=np.float64)
    lens = Ap[1:] - Ap[:-1]
    nonempty = np.nonzero(lens > 0)[0]
    if nonempty.size:
        y[nonempty] = np.add.reduceat(prod, Ap[nonempty])
    if y_dtype is None:
        y_dtype = np.asarray(A.Ax).dtype
    return y.astype(y_dtype)


def spmv_ref_semiring(A: CSR, x, semiring: Semiring = PLUS_TIMES, y_dtype=None) -> np.ndarray:
    """Generalized semiring SpMV oracle.

    y[i] = reduce over j in row i of combine(A[i,j], x[j]), starting
    from initialize(); empty rows yield the identity. Terms are formed
    with the ring's own `combine` (elementwise, so all at once). The
    built-in rings reduce each row with the matching NumPy ufunc; any
    other ring runs the row loop with its own `reduce`."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = np.asarray(A.Ax)
    x = np.asarray(x)
    if y_dtype is None:
        y_dtype = np.result_type(Ax.dtype, x.dtype)
    ident = semiring.identity_for(y_dtype)
    terms = semiring.combine(torch.from_numpy(np.ascontiguousarray(Ax)),
                             torch.from_numpy(np.ascontiguousarray(x[Aj])))
    terms = terms.numpy().astype(y_dtype)
    y = np.full(A.n_rows, ident, dtype=y_dtype)
    ufunc = _REDUCEAT.get(semiring.name)
    if ufunc is not None:
        nonempty = np.nonzero(Ap[1:] > Ap[:-1])[0]
        if nonempty.size:
            y[nonempty] = ufunc(ufunc.reduceat(terms, Ap[nonempty]),
                                ident).astype(y_dtype)
        return y
    for i in range(A.n_rows):
        acc = torch.tensor(ident)
        for k in range(Ap[i], Ap[i + 1]):
            acc = semiring.reduce(acc, torch.tensor(terms[k]))
        y[i] = acc.numpy().astype(y_dtype)
    return y


def correctness_delta(y_ref, y) -> dict:
    """Sum and per-row mean of |delta|, with max |delta| and the max
    relative error (|delta| / max(|y_ref|, 1))."""
    y_ref = np.asarray(y_ref, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    d = np.abs(y_ref - y)
    denom = np.maximum(np.abs(y_ref), 1.0)
    return {
        "sum_abs": float(d.sum()),
        "mean_abs": float(d.mean()) if d.size else 0.0,
        "max_abs": float(d.max()) if d.size else 0.0,
        "max_rel": float((d / denom).max()) if d.size else 0.0,
    }
