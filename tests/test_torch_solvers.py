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
