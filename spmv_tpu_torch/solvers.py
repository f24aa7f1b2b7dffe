"""Iterative Krylov solvers on top of the SpMV kinds.

Counterpart of `spmv_tpu/solvers.py`: CG for SPD systems, BiCGSTAB and
restarted GMRES for general square systems, each matvec dispatched
through the registry (any registered kind, `kind="xla"` by default),
with optional Jacobi or ILU(0) preconditioning or a callable `M`. They
run on the device of `b`: pass a CUDA tensor and every matvec, vector
update and triangular solve runs on the card.

CG and BiCGSTAB keep the reference's stopping test in the loop's state,
as its `lax.while_loop` carry does: every iteration computes `active`
(not converged and k < maxiter, and no breakdown for BiCGSTAB) on the
device, and every update is `torch.where(active, new, old)`, so an
iteration past the stop changes nothing, bit for bit, and k counts only
the active ones. The host reads `active` once before the first chunk
and once after each chunk, never within one (`host_reads` counts the
reads). On a CUDA b a chunk is CHUNK iterations: with a device kind and
M None, "jacobi" or "ilu0", one CUDA graph, captured once per (A, kind,
M, dtype, device) and cached on A (`graph_key`), replayed on static
buffers into which each solve copies its start; with a callable M or a
host kind (ops/registry.py:HOST_KINDS) the same iterations eagerly. On
a CPU b, where a read costs no device sync, a chunk is HOST_CHUNK = 1
iteration, so that no masked iteration runs past the stop.
GMRES tests its stop once per restart cycle (one host read a cycle).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.trisolve import ilu0, ilu0_apply
from spmv_tpu_torch.ops.registry import as_input, is_host_kind, plan_cache, spmv

CHUNK = 32      # iterations between two host reads of the stopping test, on the card
HOST_CHUNK = 1  # the same on the CPU, where a read costs no device sync
host_reads = 0  # reads of the stopping test by cg and bicgstab, ever


def _matvec(A: CSR, kind: str) -> Callable:
    return lambda v: spmv(kind, A, v)


def _preconditioner(A: CSR, M, device) -> Callable:
    """None | 'jacobi' | 'ilu0' | callable -> apply function. 'ilu0'
    factorizes A on the host (kernels/trisolve.py) and applies the two
    level-scheduled triangular solves on the device of r. The Jacobi
    inverse (per device) and the ILU(0) factors are built once and cached
    on A."""
    if M is None:
        return lambda r: r
    if callable(M):
        return M
    if M == "jacobi":
        def build():
            Ap = np.asarray(A.Ap, np.int64)
            Aj = np.asarray(A.Aj, np.int64)
            Ax = np.asarray(A.Ax)
            rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
            d = np.zeros(A.n_rows, dtype=Ax.dtype)
            on_diag = rows == Aj
            d[rows[on_diag]] = Ax[on_diag]
            if (d == 0).any():
                raise ValueError("jacobi preconditioner: zero diagonal entry")
            return torch.from_numpy(1.0 / d).to(device)

        dinv = plan_cache(A, ("jacobi", str(device)), build)
        return lambda r: dinv * r
    if M == "ilu0":
        L, U = plan_cache(A, ("ilu0",), lambda: ilu0(A))
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


def _commit(st: dict, new: dict) -> None:
    """Write each new value into its buffer where `active`, keep the old
    one elsewhere; count the iteration where `active`."""
    a = st["active"]
    for k, v in new.items():
        torch.where(a, v, st[k], out=st[k])
    st["k"].add_(a)


def _start(x: torch.Tensor, r: torch.Tensor, maxiter: int, target, **vals) -> dict:
    """The loop state: every vector a buffer of its own (x widened as the
    first update widens it), k = 0 and the limits on the device."""
    st = {"x": x.to(torch.promote_types(x.dtype, r.dtype)).clone(), "r": r.clone()}
    st.update({k: v.clone() for k, v in vals.items()})
    st["k"] = torch.zeros((), dtype=torch.int64, device=r.device)
    st["target"] = target.clone()
    st["maxiter"] = torch.full((), maxiter, dtype=torch.int64, device=r.device)
    return st


def graph_key(name: str, kind: str, M, dtype, device, x_dtype=None) -> tuple:
    """The `plan_cache` key on A of the chunk graph of solver `name`
    ("cg" or "bicgstab") for `kind`, M, a residual of `dtype` and an x of
    `x_dtype` (by default `dtype`: no x0, or one of b's dtype) on
    `device`."""
    return ("solver graph", name, kind, M, dtype, x_dtype or dtype,
            str(torch.device(device)))


def _run(A: CSR, name: str, kind: str, M, st: dict, step: Callable) -> dict:
    """Run `step` on the state `st` in chunks while the host, reading
    `active` once a chunk, sees it set; returns the final state. On the
    card a chunk is CHUNK steps, one cached CUDA graph where the solve
    allows one (see the module's docstring), else eager; on the CPU a
    chunk is HOST_CHUNK steps."""
    global host_reads
    dev = st["r"].device
    # M is None, "jacobi" or "ilu0" (_preconditioner refused other strings)
    graphed = (dev.type == "cuda" and not is_host_kind(kind)
               and (M is None or isinstance(M, str)))
    if graphed:
        key = graph_key(name, kind, M, st["r"].dtype, dev, st["x"].dtype)
        graph, static = plan_cache(A, key, lambda: _chunk_graph(name, kind, st, step))
        for k, v in st.items():
            static[k].copy_(v)
        st, chunk = static, graph.replay
    else:
        steps = CHUNK if dev.type == "cuda" else HOST_CHUNK

        def chunk():
            for _ in range(steps):
                step(st)
    while True:
        host_reads += 1
        if not bool(st["active"]):
            return st
        chunk()


def _chunk_graph(name: str, kind: str, st: dict, step: Callable):
    """CHUNK steps captured as one CUDA graph on static copies of the
    state, after one step run eagerly on other copies on a side stream
    (plans, casts and libraries are made there, never in the capture).
    -> (graph, static state)."""
    from spmv_tpu_torch.utils.timing import capture_graph

    dev = st["r"].device
    scratch = {k: v.clone() for k, v in st.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(scratch)
    torch.cuda.current_stream(dev).wait_stream(side)
    static = {k: v.clone() for k, v in st.items()}

    def body():
        for _ in range(CHUNK):
            step(static)

    return capture_graph(body, f"{name} (kind {kind!r})", dev), static


def _info(st: dict, x0: torch.Tensor):
    resnorm = torch.linalg.norm(st["r"])
    k = int(st["k"])
    x = st["x"].clone() if k else x0  # no update widened x
    return x, {"iters": k, "resnorm": float(resnorm),
               "converged": bool(resnorm <= st["target"])}


def cg(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
       maxiter: Optional[int] = None, M=None, kind: str = "xla"):
    """Conjugate gradients for SPD A. Returns (x, info) with
    info = {"iters", "resnorm", "converged"}.

    Stops when ||r|| <= max(rtol*||b||, atol) (scipy.sparse.linalg.cg's
    rule), tested on the device every iteration and read by the host
    once every CHUNK iterations on the card (every iteration on the CPU).
    `kind` picks the SpMV kind (any registered one)."""
    b, x, mv, psolve, maxiter = _setup(A, b, x0, M, maxiter, kind, "cg")
    target = _target(b, rtol, atol)
    r = b - mv(x)
    z = psolve(r)
    st = _start(x, r, maxiter, target, z=z, p=z, rz=torch.dot(r, z))

    def go(st):
        return (torch.linalg.norm(st["r"]) > st["target"]) & (st["k"] < st["maxiter"])

    def step(st):
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        Ap_ = mv(p)
        denom = torch.dot(p, Ap_)
        alpha = _safe_div(rz, denom, denom != 0)
        r_new = r - alpha * Ap_
        z_new = psolve(r_new)
        rz_new = torch.dot(r_new, z_new)
        beta = _safe_div(rz_new, rz, rz != 0)
        _commit(st, {"x": x + alpha * p, "r": r_new, "z": z_new,
                     "p": z_new + beta * p, "rz": rz_new})
        st["active"].copy_(go(st))

    st["active"] = go(st)
    return _info(_run(A, "cg", kind, M, st, step), x)


def bicgstab(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None, kind: str = "xla"):
    """BiCGSTAB for general square A. Returns (x, info) like `cg`; it
    also stops on breakdown (rho or omega vanished)."""
    b, x, mv, psolve, maxiter = _setup(A, b, x0, M, maxiter, kind, "bicgstab")
    target = _target(b, rtol, atol)
    r = b - mv(x)
    st = _start(x, r, maxiter, target, rhat=r, p=r, rho=torch.dot(r, r),
                brk=torch.zeros((), dtype=torch.bool, device=b.device))

    def go(st):
        return ((torch.linalg.norm(st["r"]) > st["target"]) & (st["k"] < st["maxiter"])
                & ~st["brk"])

    def step(st):
        x, r, rhat, p, rho = st["x"], st["r"], st["rhat"], st["p"], st["rho"]
        ph = psolve(p)
        v = mv(ph)
        denom = torch.dot(rhat, v)
        alpha = _safe_div(rho, denom, denom != 0)
        s = r - alpha * v
        sh = psolve(s)
        t = mv(sh)
        tt = torch.dot(t, t)
        omega = _safe_div(torch.dot(t, s), tt, tt != 0)
        r_new = s - omega * t
        rho_new = torch.dot(rhat, r_new)
        ok = (rho != 0) & (omega != 0)
        beta = torch.where(ok, (rho_new / rho) * (alpha / omega),
                           torch.zeros_like(rho))
        _commit(st, {"x": x + alpha * ph + omega * sh, "r": r_new,
                     "p": r_new + beta * (p - omega * v), "rho": rho_new,
                     "brk": (rho_new == 0) | (omega == 0)})
        st["active"].copy_(go(st))

    st["active"] = go(st)
    return _info(_run(A, "bicgstab", kind, M, st, step), x)


def gmres(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
          restart: int = 32, maxiter: Optional[int] = None, M=None,
          kind: str = "xla"):
    """Restarted GMRES(m) for general square A. Returns (x, info).

    Left-preconditioned: stops when ||M^-1 (b - Ax)|| <= max(rtol *
    ||M^-1 b||, atol), tested once per restart cycle (one host read a
    cycle; the loop is eager, not a graph).
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
