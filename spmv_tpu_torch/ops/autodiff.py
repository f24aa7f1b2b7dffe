"""Differentiable SpMV.

Counterpart of `spmv_tpu/ops/autodiff.py`. Two paths, by what is
differentiated:

1. **Fixed structure and values, gradient w.r.t. x** (solvers,
   PageRank-style fixed operators, graph networks on a fixed adjacency).
   `SparseOperator` wraps any registered kind in a
   `torch.autograd.Function` whose backward is one SpMV with the
   transpose A^T, built once and cached, so both directions run the
   planned kernels and both plans are reused from call to call. The
   reference's `jax.custom_vjp` becomes that Function, reverse mode
   only, as a custom VJP is.

2. **Gradient w.r.t. the nonzero values too** (learned edge weights).
   `spmv_values(A, Ax, x)` takes the values as a live tensor over A's
   pattern and computes gather and multiply in plain torch and the
   sorted row fold by `segment_reduce_sorted`, so autograd (and
   `torch.func.jvp`) derive both gradients: d/dAx[k] = g[row(k)] *
   x[col(k)]. The fold is K16 on the card (kernels/fold.py, whose
   autograd rule is the gather g[row] and whose tangent is K16 again),
   its plain version on the CPU; both sum in float64 and round once, as
   every plus-times fold of the port does (the reference folds in
   float32).

Rings other than plus-times are not differentiable in general (min-plus
has kinks, or-and is discrete): both paths are plus-times only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.ops.registry import as_input, plan_cache, spmv
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, segment_reduce_sorted


class _MatVec(torch.autograd.Function):
    """y = op.matvec(x); the VJP is op.rmatvec(g)."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return op.matvec(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.op.rmatvec(g), None


class SparseOperator:
    """A fixed sparse matrix as a differentiable linear map.

    ``op(x)`` computes ``A @ x`` with the requested kind on x's device (a
    host x on the card unless the process asked for the CPU, as
    `matvec` and `rmatvec` place theirs) and is differentiable w.r.t. ``x``: the VJP is ``A^T @ g``, dispatched
    through the same registry on a transpose built once and cached.

    Parameters
    ----------
    A : CSR
        The matrix. Treated as a constant (its values receive no
        gradient; use `spmv_values` for that).
    kind : str
        Registered kind for the forward matvec.
    rkind : str, optional
        Kind for the transpose matvec (defaults to ``kind``): the
        transpose of a power-law matrix can have a very different row
        profile, so the best kind may differ.
    """

    def __init__(self, A: CSR, kind: str = "xla", rkind: Optional[str] = None):
        self.A = A
        self.kind = kind
        self.rkind = rkind or kind
        self._AT: Optional[CSR] = None
        self._Top: Optional["SparseOperator"] = None

    @property
    def shape(self):
        return (self.A.n_rows, self.A.n_cols)

    @property
    def dtype(self):
        return np.asarray(self.A.Ax).dtype

    def _transpose_csr(self) -> CSR:
        if self._AT is None:
            self._AT = self.A.transpose()
        return self._AT

    @property
    def T(self) -> "SparseOperator":
        """The transpose as its own differentiable operator. It shares
        the arrays both ways: ``op.T.T is op``."""
        if self._Top is None:
            t = SparseOperator(self._transpose_csr(), self.rkind, rkind=self.kind)
            t._AT = self.A
            t._Top = self
            self._Top = t
        return self._Top

    def matvec(self, x) -> torch.Tensor:
        """``A @ x`` (no gradient through it; use ``__call__`` under
        autograd)."""
        return spmv(self.kind, self.A, x)

    def rmatvec(self, y) -> torch.Tensor:
        """``A^T @ y`` through the cached transpose."""
        return spmv(self.rkind, self._transpose_csr(), y)

    def __call__(self, x) -> torch.Tensor:
        return _MatVec.apply(as_input(x), self)


def _pattern(A: CSR, device) -> dict:
    """A's row of each nonzero and its column, on `device`, cached."""
    return plan_cache(A, ("autodiff", str(device)), lambda: {
        "rows": torch.from_numpy(A.row_ids().astype(np.int64)).to(device),
        "Aj": torch.from_numpy(np.asarray(A.Aj, np.int64)).to(device)})


def spmv_values(A: CSR, Ax, x, *, n_rows: Optional[int] = None) -> torch.Tensor:
    """SpMV with live values over A's pattern, on x's device:
    differentiable in both ``Ax`` and ``x`` by plain autograd (reverse
    mode and ``torch.func.jvp``).

    ``A`` gives only ``Ap``/``Aj`` (the pattern); its stored values are
    ignored in favour of ``Ax``, which must have ``A.nnz`` entries. Under
    autograd the gradient w.r.t. ``Ax`` is ``g[row] * x[Aj]`` and w.r.t.
    ``x`` the fold of ``g[row] * Ax`` over the columns, both derived by
    torch. A host x goes to the card unless the process asked for the
    CPU (`as_input`); Ax follows x."""
    x = as_input(x)
    Ax = as_input(Ax, x.device)
    if tuple(Ax.shape) != (A.nnz,):
        raise ValueError(
            f"Ax has shape {tuple(Ax.shape)}, expected ({A.nnz},) for A's pattern")
    p = _pattern(A, x.device)
    n = n_rows if n_rows is not None else A.n_rows
    prod = Ax * x.index_select(0, p["Aj"])
    return segment_reduce_sorted(prod, p["rows"], n, PLUS_TIMES, 0.0)


def spmv_value_grad(A: CSR, x, g) -> torch.Tensor:
    """The gradient of ``g . (A x)`` w.r.t. each stored value,
    ``g[row(k)] * x[col(k)]``, on x's device (a host x on the card unless
    the process asked for the CPU; g follows x), without an autograd
    graph (e.g. to feed edge-weight updates)."""
    x = as_input(x)
    g = as_input(g, x.device)
    p = _pattern(A, x.device)
    return g.index_select(0, p["rows"]) * x.index_select(0, p["Aj"])
