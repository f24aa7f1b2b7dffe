"""The port's Krylov solvers against `spmv_tpu.solvers` on the reference
tests' small systems (tests/test_solvers.py), through the framework
gather (`kind="xla"`) and the csr-vector kind (DIA on the Poisson
matrices, the stream pipeline on the nonsymmetric ones); the
preconditioners, ILU(0) among them; and the Poisson example at m = 16.

Iteration counts must agree within one iteration; GMRES counts whole
restart cycles, which must agree within one cycle (near the target,
float32 rounding in the Arnoldi sweep decides whether one more cycle
runs). The solutions must agree within the tolerances the reference's
own tests use."""

import numpy as np
import pytest
import torch

from spmv_tpu import solvers as jsolvers
from spmv_tpu.formats import COO as JCOO
from spmv_tpu.formats import coo_to_csr as j_coo_to_csr
from spmv_tpu_torch import solvers as tsolvers
from spmv_tpu_torch.formats import COO as TCOO
from spmv_tpu_torch.formats import coo_to_csr as t_coo_to_csr

torch.set_num_threads(1)


def _both(n, rows, cols, vals):
    return (j_coo_to_csr(JCOO(n, n, rows, cols, vals)),
            t_coo_to_csr(TCOO(n, n, rows, cols, vals)))


def _poisson2d(m):
    """tests/test_solvers.py:16: the 5-point Laplacian on an m x m grid."""
    rows, cols, vals = [], [], []
    for i in range(m):
        for j in range(m):
            k = i * m + j
            rows.append(k), cols.append(k), vals.append(4.0)
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < m and 0 <= jj < m:
                    rows.append(k), cols.append(ii * m + jj), vals.append(-1.0)
    return _both(m * m, np.array(rows), np.array(cols), np.array(vals, np.float32))


def _nonsym(n, seed=3):
    """tests/test_solvers.py:33: a diagonally dominant nonsymmetric
    matrix without duplicate entries."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 4 * n)
    cols = rng.integers(0, n, 4 * n)
    off = ~np.isin(rows * n + cols, np.arange(n) * n + np.arange(n))
    _, uniq = np.unique(rows * n + cols, return_index=True)
    keep = uniq[off[uniq]]
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32) * 0.1
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 5.0, np.float32)])
    return _both(n, rows, cols, vals)


def _solve(name, Aj, At, b, **kw):
    xj, ij = getattr(jsolvers, name)(Aj, b, **kw)
    xt, it = getattr(tsolvers, name)(At, torch.from_numpy(b), **kw)
    assert it["converged"] == ij["converged"]
    return np.asarray(xj), ij, xt.numpy(), it


KINDS = ["xla", "csr_vector"]


@pytest.mark.parametrize("kind", KINDS)
def test_cg_poisson_matches_reference(kind):
    Aj, At = _poisson2d(12)
    b = np.random.default_rng(0).standard_normal(At.n_rows).astype(np.float32)
    xj, ij, xt, it = _solve("cg", Aj, At, b, rtol=1e-6, maxiter=2000, kind=kind)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 1, (it, ij)
    xd = np.linalg.solve(At.to_dense().astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(xt, xd, rtol=0, atol=5e-4)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=5e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_cg_jacobi_matches_reference(kind):
    Aj, At = _poisson2d(10)
    b = np.random.default_rng(1).standard_normal(At.n_rows).astype(np.float32)
    xj, ij, xt, it = _solve("cg", Aj, At, b, rtol=1e-6, maxiter=2000, M="jacobi",
                            kind=kind)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 1, (it, ij)
    x0, _ = tsolvers.cg(At, torch.from_numpy(b), rtol=1e-6, maxiter=2000, kind=kind)
    np.testing.assert_allclose(xt, x0.numpy(), atol=5e-3)
    np.testing.assert_allclose(xt, xj, atol=5e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_bicgstab_nonsymmetric_matches_reference(kind):
    Aj, At = _nonsym(150)
    b = np.random.default_rng(2).standard_normal(At.n_rows).astype(np.float32)
    xj, ij, xt, it = _solve("bicgstab", Aj, At, b, rtol=1e-6, maxiter=500, kind=kind)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 1, (it, ij)
    xd = np.linalg.solve(At.to_dense().astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(xt, xd, rtol=0, atol=5e-2)


@pytest.mark.parametrize("kind", KINDS)
def test_gmres_nonsymmetric_matches_reference(kind):
    Aj, At = _nonsym(160)
    xstar = np.random.default_rng(0).standard_normal(160).astype(np.float32)
    b = (At.to_dense() @ xstar).astype(np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-5, restart=40, kind=kind)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 40, (it, ij)
    np.testing.assert_allclose(xt, xstar, rtol=2e-3, atol=2e-3)


def test_gmres_restart_cycles_match_reference():
    Aj, At = _nonsym(200, seed=9)
    b = np.ones(200, np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-5, restart=8)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 8, (it, ij)
    r = b - At.to_dense() @ xt
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b) * 10


def test_gmres_jacobi_matches_reference():
    Aj, At = _poisson2d(14)
    b = np.ones(At.n_rows, np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-5, restart=20, M="jacobi")
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 20, (it, ij)
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres"])
def test_ilu0_matches_reference(name, m):
    """M="ilu0": the host factorization and the level-scheduled solves,
    against the reference's same solve, within the Jacobi cases'
    tolerances."""
    Aj, At = _poisson2d(m)
    b = np.random.default_rng(m).standard_normal(At.n_rows).astype(np.float32)
    kw = {"restart": 20} if name == "gmres" else {"maxiter": 2000}
    xj, ij, xt, it = _solve(name, Aj, At, b, rtol=1e-6, M="ilu0", **kw)
    slack = 20 if name == "gmres" else 1
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= slack, (it, ij)
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=5e-3)
    xd = np.linalg.solve(At.to_dense().astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(xt, xd, rtol=0, atol=5e-3)


def test_solver_validation_and_callable_preconditioner():
    _, At = _poisson2d(4)
    b = torch.ones(At.n_rows)
    with pytest.raises(ValueError, match="shape"):
        tsolvers.cg(At, b[:-1])
    with pytest.raises(ValueError, match="preconditioner"):
        tsolvers.cg(At, b, M="nope")
    rect = t_coo_to_csr(TCOO(3, 4, np.array([0]), np.array([1]),
                             np.array([1.0], np.float32)))
    with pytest.raises(ValueError, match="square"):
        tsolvers.bicgstab(rect, torch.ones(3))
    x1, i1 = tsolvers.cg(At, b, rtol=1e-6, M=lambda r: r / 4.0)
    x2, i2 = tsolvers.cg(At, b, rtol=1e-6, M="jacobi")
    assert i1["converged"] and i1["iters"] == i2["iters"]
    torch.testing.assert_close(x1, x2)


def test_cg_warm_start_takes_no_iteration():
    _, At = _poisson2d(6)
    b = torch.ones(At.n_rows)
    x1, _ = tsolvers.cg(At, b, rtol=1e-6)
    _, info = tsolvers.cg(At, b, x0=x1.numpy(), rtol=1e-6)
    assert info["iters"] == 0 and info["converged"]


def test_solve_poisson_example_on_the_cpu(capsys):
    from spmv_tpu_torch.examples import solve_poisson

    out = solve_poisson.main(16, "csr_vector", "cpu")
    assert [o["M"] for o in out] == [None, "jacobi", "ilu0"]
    for o in out:
        assert o["info"]["converged"] and o["true_rel_residual"] < 1e-5
    assert "Poisson 16x16: n=256 nnz=1216" in capsys.readouterr().out


# --- the stopping test in the loop's state, read once per chunk of iterations.
# The per-iteration loops the solvers ran before, kept here as the yardstick:
# the chunked solvers must give their iters and x bit for bit.

def _cg_per_iteration(A, b, *, x0=None, rtol=1e-6, atol=0.0, maxiter=None, M=None,
                      kind="xla"):
    b, x, mv, psolve, maxiter = tsolvers._setup(A, b, x0, M, maxiter, kind, "cg")
    target = tsolvers._target(b, rtol, atol)
    r = b - mv(x)
    z = psolve(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) > target):
        Ap_ = mv(p)
        denom = torch.dot(p, Ap_)
        alpha = tsolvers._safe_div(rz, denom, denom != 0)
        x = x + alpha * p
        r = r - alpha * Ap_
        z = psolve(r)
        rz_new = torch.dot(r, z)
        beta = tsolvers._safe_div(rz_new, rz, rz != 0)
        p = z + beta * p
        rz = rz_new
        k += 1
    resnorm = torch.linalg.norm(r)
    return x, {"iters": k, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


def _bicgstab_per_iteration(A, b, *, x0=None, rtol=1e-6, atol=0.0, maxiter=None,
                            M=None, kind="xla"):
    b, x, mv, psolve, maxiter = tsolvers._setup(A, b, x0, M, maxiter, kind, "bicgstab")
    target = tsolvers._target(b, rtol, atol)
    r = b - mv(x)
    rhat = r
    rho = torch.dot(rhat, r)
    p = r
    brk = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((torch.linalg.norm(r) > target) & ~brk):
        ph = psolve(p)
        v = mv(ph)
        denom = torch.dot(rhat, v)
        alpha = tsolvers._safe_div(rho, denom, denom != 0)
        s = r - alpha * v
        sh = psolve(s)
        t = mv(sh)
        tt = torch.dot(t, t)
        omega = tsolvers._safe_div(torch.dot(t, s), tt, tt != 0)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho_new = torch.dot(rhat, r)
        ok = (rho != 0) & (omega != 0)
        beta = torch.where(ok, (rho_new / rho) * (alpha / omega), torch.zeros_like(rho))
        p = r + beta * (p - omega * v)
        brk = (rho_new == 0) | (omega == 0)
        rho = rho_new
        k += 1
    resnorm = torch.linalg.norm(r)
    return x, {"iters": k, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


PER_ITERATION = {"cg": _cg_per_iteration, "bicgstab": _bicgstab_per_iteration}
CHUNK_CASES = {
    "poisson_xla": ("cg", lambda: _poisson2d(12), dict(kind="xla", maxiter=2000)),
    "poisson_csr_vector": ("cg", lambda: _poisson2d(12), dict(kind="csr_vector",
                                                              maxiter=2000)),
    "jacobi": ("cg", lambda: _poisson2d(10), dict(M="jacobi", maxiter=2000)),
    "ilu0": ("cg", lambda: _poisson2d(16), dict(M="ilu0", maxiter=2000)),
    "ilu0_bicgstab": ("bicgstab", lambda: _poisson2d(16), dict(M="ilu0", maxiter=2000)),
    "nonsym": ("bicgstab", lambda: _nonsym(150), dict(maxiter=500)),
    "nonsym_csr_vector": ("bicgstab", lambda: _nonsym(150), dict(kind="csr_vector",
                                                                  maxiter=500)),
    "maxiter_37": ("cg", lambda: _poisson2d(30), dict(maxiter=37)),
    "maxiter_37_bicgstab": ("bicgstab", lambda: _poisson2d(30), dict(maxiter=37)),
}


def _chunked_equals_per_iteration(case, chunk, monkeypatch):
    name, mats, kw = CHUNK_CASES[case]
    _, At = mats()
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(At.n_rows)
                         .astype(np.float32))
    monkeypatch.setattr(tsolvers, "HOST_CHUNK", chunk)
    reads = tsolvers.host_reads
    x, info = getattr(tsolvers, name)(At, b, rtol=1e-6, **kw)
    assert tsolvers.host_reads - reads == 1 + -(-info["iters"] // chunk)
    x_ref, info_ref = PER_ITERATION[name](At, b, rtol=1e-6, **kw)
    assert info == info_ref
    assert x.dtype == x_ref.dtype and torch.equal(x, x_ref)
    if case.startswith("maxiter"):
        assert info["iters"] == 37 and not info["converged"]


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_solver_equals_the_per_iteration_loop(case, monkeypatch):
    """Chunks of CHUNK iterations, as the card runs them (up to CHUNK - 1
    masked iterations past the stop): iters, resnorm and x bit for bit
    against the loop that read the stopping test every iteration, and the
    host read once before the first chunk and once after each."""
    _chunked_equals_per_iteration(case, tsolvers.CHUNK, monkeypatch)


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_cpu_solver_reads_every_iteration(case, monkeypatch):
    """On the CPU a chunk is HOST_CHUNK = 1 iteration: no masked
    iteration runs past the stop, the host reads once per iteration and
    once before, and iters and x equal the per-iteration loop's."""
    assert tsolvers.HOST_CHUNK == 1
    _chunked_equals_per_iteration(case, tsolvers.HOST_CHUNK, monkeypatch)


@pytest.mark.parametrize("case", ["poisson_xla", "jacobi", "ilu0", "nonsym"])
def test_chunked_solver_gives_the_reference_iters(case):
    name, mats, kw = CHUNK_CASES[case]
    Aj, At = mats()
    b = np.random.default_rng(11).standard_normal(At.n_rows).astype(np.float32)
    xj, ij, xt, it = _solve(name, Aj, At, b, rtol=1e-6, **kw)
    assert it["iters"] == ij["iters"] and it["converged"], (it, ij)


@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_warm_start_takes_no_iteration_and_one_read(name):
    _, At = _poisson2d(6)
    b = torch.ones(At.n_rows)
    f = getattr(tsolvers, name)
    x1, _ = f(At, b, rtol=1e-6)
    reads = tsolvers.host_reads
    x2, info = f(At, b, x0=x1, rtol=1e-6)
    assert info["iters"] == 0 and info["converged"]
    assert tsolvers.host_reads - reads == 1 and torch.equal(x2, x1)


def test_bicgstab_breakdown_stops_at_the_same_k():
    """A rotation: t = A s is orthogonal to s, so omega is 0 (exactly)
    in the first iteration and BiCGSTAB stops there on breakdown,
    unconverged, as the per-iteration loop and the reference stop."""
    Aj, At = _both(2, np.array([0, 1]), np.array([1, 0]), np.array([1.0, -1.0], np.float32))
    b = np.array([1.0, 2.0], np.float32)
    xj, ij, xt, it = _solve("bicgstab", Aj, At, b, rtol=1e-6, maxiter=100)
    x_ref, i_ref = _bicgstab_per_iteration(At, torch.from_numpy(b), rtol=1e-6, maxiter=100)
    assert it == i_ref and it["iters"] == ij["iters"] == 1 and not it["converged"]
    assert torch.equal(torch.from_numpy(xt), x_ref)
