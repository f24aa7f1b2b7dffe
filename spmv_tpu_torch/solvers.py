"""Iterative Krylov solvers on top of the SpMV kinds.

Counterpart of `spmv_tpu/solvers.py`: CG for SPD systems, BiCGSTAB and
restarted GMRES for general square systems, each matvec dispatched
through the registry (any registered kind, `kind="xla"` by default),
with optional Jacobi or ILU(0) preconditioning or a callable `M`. They
run on the device of `b`: pass a CUDA tensor and every matvec, vector
update and triangular solve runs on the card.

The stopping rules are the reference's and are tested every iteration
(every restart cycle for GMRES). That costs one host sync per iteration:
the reference keeps the test inside its `lax.while_loop` carry and
syncs once at the end, while PyTorch's eager loop must bring one
boolean to the host to decide whether to go on.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.trisolve import ilu0, ilu0_apply
from spmv_tpu_torch.ops.registry import as_input, spmv


def _matvec(A: CSR, kind: str) -> Callable:
    return lambda v: spmv(kind, A, v)


def _preconditioner(A: CSR, M, device) -> Callable:
    """None | 'jacobi' | 'ilu0' | callable -> apply function. 'ilu0'
    factorizes A on the host (kernels/trisolve.py) and applies the two
    level-scheduled triangular solves on the device of r."""
    if M is None:
        return lambda r: r
    if callable(M):
        return M
    if M == "jacobi":
        Ap = np.asarray(A.Ap, np.int64)
        Aj = np.asarray(A.Aj, np.int64)
        Ax = np.asarray(A.Ax)
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
        d = np.zeros(A.n_rows, dtype=Ax.dtype)
        on_diag = rows == Aj
        d[rows[on_diag]] = Ax[on_diag]
        if (d == 0).any():
            raise ValueError("jacobi preconditioner: zero diagonal entry")
        dinv = torch.from_numpy(1.0 / d).to(device)
        return lambda r: dinv * r
    if M == "ilu0":
        L, U = ilu0(A)
        return lambda r: ilu0_apply(L, U, r)
    raise ValueError(f"unknown preconditioner {M!r}; use None, 'jacobi', "
                     f"'ilu0', or a callable")


def _setup(A: CSR, b, x0, M, maxiter, kind: str, name: str):
    if A.n_rows != A.n_cols:
        raise ValueError(f"{name} requires a square matrix")
    b = as_input(b)
    if tuple(b.shape) != (A.n_rows,):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({A.n_rows},)")
    if maxiter is None:
        maxiter = min(10 * A.n_rows, 10_000)
    x = torch.zeros_like(b) if x0 is None else as_input(x0, b.device).to(b.dtype)
    return b, x, _matvec(A, kind), _preconditioner(A, M, b.device), maxiter


def _target(v: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    """max(rtol * ||v||, atol) as a 0-d tensor of v's dtype."""
    return torch.clamp(rtol * torch.linalg.norm(v), min=atol)


def _safe_div(num, den, ok):
    return torch.where(ok, num / den, torch.zeros_like(num))


def cg(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
       maxiter: Optional[int] = None, M=None, kind: str = "xla"):
    """Conjugate gradients for SPD A. Returns (x, info) with
    info = {"iters", "resnorm", "converged"}.

    Stops when ||r|| <= max(rtol*||b||, atol) (scipy.sparse.linalg.cg's
    rule), tested before every iteration: one host sync each. `kind`
    picks the SpMV kind (any registered one)."""
    b, x, mv, psolve, maxiter = _setup(A, b, x0, M, maxiter, kind, "cg")
    target = _target(b, rtol, atol)
    r = b - mv(x)
    z = psolve(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) > target):
        Ap_ = mv(p)
        denom = torch.dot(p, Ap_)
        alpha = _safe_div(rz, denom, denom != 0)
        x = x + alpha * p
        r = r - alpha * Ap_
        z = psolve(r)
        rz_new = torch.dot(r, z)
        beta = _safe_div(rz_new, rz, rz != 0)
        p = z + beta * p
        rz = rz_new
        k += 1
    resnorm = torch.linalg.norm(r)
    return x, {"iters": k, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


def bicgstab(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None, kind: str = "xla"):
    """BiCGSTAB for general square A. Returns (x, info) like `cg`; it
    also stops on breakdown (rho or omega vanished)."""
    b, x, mv, psolve, maxiter = _setup(A, b, x0, M, maxiter, kind, "bicgstab")
    target = _target(b, rtol, atol)
    r = b - mv(x)
    rhat = r  # shadow residual, fixed
    rho = torch.dot(rhat, r)
    p = r
    brk = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((torch.linalg.norm(r) > target) & ~brk):
        ph = psolve(p)
        v = mv(ph)
        denom = torch.dot(rhat, v)
        alpha = _safe_div(rho, denom, denom != 0)
        s = r - alpha * v
        sh = psolve(s)
        t = mv(sh)
        tt = torch.dot(t, t)
        omega = _safe_div(torch.dot(t, s), tt, tt != 0)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho_new = torch.dot(rhat, r)
        ok = (rho != 0) & (omega != 0)
        beta = torch.where(ok, (rho_new / rho) * (alpha / omega),
                           torch.zeros_like(rho))
        p = r + beta * (p - omega * v)
        brk = (rho_new == 0) | (omega == 0)
        rho = rho_new
        k += 1
    resnorm = torch.linalg.norm(r)
    return x, {"iters": k, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


def gmres(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
          restart: int = 32, maxiter: Optional[int] = None, M=None,
          kind: str = "xla"):
    """Restarted GMRES(m) for general square A. Returns (x, info).

    Left-preconditioned: stops when ||M^-1 (b - Ax)|| <= max(rtol *
    ||M^-1 b||, atol), tested once per restart cycle (one host sync).
    Each cycle is `restart` Arnoldi steps (modified Gram-Schmidt, the
    basis V (m+1, n) on b's device) and the (m+1) x m least-squares
    solve, which runs on the host (SVD-based, as the reference's
    `jnp.linalg.lstsq`). `maxiter` bounds the total inner iterations."""
    b, x, mv, psolve, maxiter = _setup(A, b, x0, M, maxiter, kind, "gmres")
    n = A.n_rows
    m = max(1, min(restart, n))
    max_cycles = -(-maxiter // m)
    target = _target(psolve(b), rtol, atol)

    def cycle(x):
        r = psolve(b - mv(x))
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            w = psolve(mv(V[j]))
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                H[i, j] = hij
            hnext = torch.linalg.norm(w)
            H[j + 1, j] = hnext
            V[j + 1] = w / torch.where(hnext > 0, hnext, torch.ones_like(hnext))
        e1 = torch.zeros((m + 1, 1), dtype=b.dtype)
        e1[0, 0] = beta.cpu()
        y = torch.linalg.lstsq(H.cpu(), e1, driver="gelsd").solution
        return x + V[:m].T @ y[:, 0].to(b.device)

    resnorm = torch.linalg.norm(psolve(b - mv(x)))
    k = 0
    while k < max_cycles and bool(resnorm > target):
        x = cycle(x)
        resnorm = torch.linalg.norm(psolve(b - mv(x)))
        k += 1
    return x, {"iters": k * m, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}
