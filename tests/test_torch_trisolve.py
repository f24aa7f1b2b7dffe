"""The port's triangular solves and ILU(0) (`spmv_tpu_torch.kernels.trisolve`)
against `spmv_tpu.kernels.trisolve` on the cases of tests/test_trisolve.py.

The host half is the reference's, line for line: the solve plans
(rows, cols, vals, diag, n_levels) and the ILU(0) factors must equal the
reference's bit for bit. The solves, a loop over the levels on b's
device, are held against the reference's `lax.scan` and SciPy's
`spsolve_triangular` in float64."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from spmv_tpu.formats import csr_from_dense as j_csr_from_dense
from spmv_tpu.kernels import trisolve as jtri
from spmv_tpu_torch.formats import CSR as TCSR
from spmv_tpu_torch.kernels import trisolve as ttri

torch.set_num_threads(1)

TOL = 2e-3  # tests/test_trisolve.py's float32 solves against float64


def _port(A):
    return TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                np.asarray(A.Ax))


def _to_scipy(A):
    return sp.csr_matrix((np.asarray(A.Ax), np.asarray(A.Aj), np.asarray(A.Ap)),
                         shape=A.shape)


def _rand_lower(n, density, seed, unit=False):
    """tests/test_trisolve.py:24."""
    rng = np.random.default_rng(seed)
    d = np.tril(rng.random((n, n)) < density, k=-1).astype(np.float64)
    vals = rng.standard_normal((n, n)) * d
    np.fill_diagonal(vals, 1.0 if unit else rng.random(n) + 1.0)
    if unit:
        np.fill_diagonal(vals, 1.0)
    return j_csr_from_dense(vals.astype(np.float32))


def _spd(n, seed):
    """tests/test_trisolve.py:84: sparse SPD on a symmetric pattern."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.06
    mask = mask | mask.T
    np.fill_diagonal(mask, True)
    M = rng.standard_normal((n, n)) * mask
    A = (M + M.T) / 2 + np.diag(np.full(n, float(n) / 3))
    return j_csr_from_dense((A * mask).astype(np.float64))


def _same_plan(pj, pt):
    assert pj["n_levels"] == pt["n_levels"]
    for k in ("rows", "cols", "vals", "diag"):
        a, b = np.asarray(pj[k]), pt[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _strip_diag(L):
    d = _to_scipy(L).toarray()
    np.fill_diagonal(d, 0.0)
    return j_csr_from_dense(d.astype(np.float32))


PLANS = {
    "lower_80": lambda: (_rand_lower(80, 0.1, seed=80), True, False),
    "lower_200": lambda: (_rand_lower(200, 0.03, seed=200), True, False),
    "upper_120": lambda: (j_csr_from_dense(_to_scipy(_rand_lower(120, 0.05, seed=3))
                                           .toarray().T.astype(np.float32)), False, False),
    "unit_60": lambda: (_strip_diag(_rand_lower(60, 0.08, seed=5, unit=True)), True, True),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_solve_plan_matches_reference(name):
    A, lower, unit = PLANS[name]()
    _same_plan(jtri._build_solve_plan(A, lower, unit),
               ttri._build_solve_plan(_port(A), lower, unit))
    np.testing.assert_array_equal(jtri._levels(A, lower), ttri._levels(_port(A), lower))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_sptrsv_matches_reference_and_scipy(name):
    A, lower, unit = PLANS[name]()
    b = np.random.default_rng(1).standard_normal(A.n_rows).astype(np.float32)
    x = ttri.sptrsv(_port(A), torch.from_numpy(b), lower=lower, unit_diagonal=unit)
    assert x.dtype == torch.float32 and x.shape == (A.n_rows,)
    xj = np.asarray(jtri.sptrsv(A, b, lower=lower, unit_diagonal=unit))
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-4, atol=1e-5)
    T = _to_scipy(A).astype(np.float64)
    if unit:
        T = T + sp.eye(A.n_rows)
    x_ref = spla.spsolve_triangular(T.tocsr(), b.astype(np.float64), lower=lower)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=TOL, atol=TOL)


def test_sptrsv_narrows_a_float64_b():
    A, lower, unit = PLANS["lower_80"]()
    b = np.random.default_rng(2).standard_normal(A.n_rows)
    x = ttri.sptrsv(_port(A), b)
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(jtri.sptrsv(A, b)), rtol=1e-4, atol=1e-5)


def test_sptrsv_rejects_nontriangular():
    A = _port(j_csr_from_dense(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)))
    with pytest.raises(ValueError, match="triangular"):
        ttri.sptrsv(A, np.ones(2, np.float32))


def test_sptrsv_missing_diag_raises():
    A = _port(j_csr_from_dense(np.array([[1.0, 0.0], [2.0, 0.0]], np.float32)))
    with pytest.raises(ValueError, match="diagonal"):
        ttri.sptrsv(A, np.ones(2, np.float32))


def test_sptrsv_shape_check():
    A, _, _ = PLANS["lower_80"]()
    with pytest.raises(ValueError, match="shape"):
        ttri.sptrsv(_port(A), np.ones(79, np.float32))


@pytest.mark.parametrize("n,seed", [(100, 11), (80, 13), (60, 17)])
def test_ilu0_factors_match_reference(n, seed):
    A = _spd(n, seed)
    (Lj, Uj), (Lt, Ut) = jtri.ilu0(A), ttri.ilu0(_port(A))
    for a, b in ((Lj, Lt), (Uj, Ut)):
        assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
        for f in ("Ap", "Aj", "Ax"):
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    # the defining property: (L@U)[i,j] == A[i,j] on A's pattern
    LU = (_to_scipy(Lt).toarray() + np.eye(n)) @ _to_scipy(Ut).toarray()
    Ad = _to_scipy(A).toarray()
    np.testing.assert_allclose(LU[Ad != 0], Ad[Ad != 0], rtol=1e-6, atol=1e-8)


def test_ilu0_apply_matches_reference_and_dense():
    A = _spd(80, seed=13)
    (Lj, Uj), (Lt, Ut) = jtri.ilu0(A), ttri.ilu0(_port(A))
    r = np.random.default_rng(4).standard_normal(A.n_rows)
    z = ttri.ilu0_apply(Lt, Ut, torch.from_numpy(r.astype(np.float32))).numpy()
    np.testing.assert_allclose(z, np.asarray(jtri.ilu0_apply(Lj, Uj, r.astype(np.float32))),
                               rtol=1e-4, atol=1e-5)
    Ld = _to_scipy(Lt).toarray() + np.eye(A.n_rows)
    z_ref = np.linalg.solve(_to_scipy(Ut).toarray(), np.linalg.solve(Ld, r))
    np.testing.assert_allclose(z, z_ref, rtol=TOL, atol=TOL)


def test_ilu0_improves_conditioning():
    A = _spd(60, seed=17)
    Ad = _to_scipy(A).toarray()
    L, U = ttri.ilu0(_port(A))
    b = np.random.default_rng(5).standard_normal(A.n_rows)
    z = ttri.ilu0_apply(L, U, b.astype(np.float32)).numpy().astype(np.float64)
    assert (np.linalg.norm(b - Ad @ z)
            < 0.5 * np.linalg.norm(b - Ad @ (b / np.diag(Ad))))


@pytest.mark.parametrize("case", ["rect", "dup", "no_diag", "zero_pivot"])
def test_ilu0_raises_as_the_reference(case):
    if case == "rect":
        A = j_csr_from_dense(np.ones((2, 3), np.float64))
    elif case == "no_diag":
        A = j_csr_from_dense(np.array([[1.0, 0.0], [2.0, 0.0]]))
    elif case == "zero_pivot":
        # a stored zero on the diagonal of row 0, which row 1 divides by
        from spmv_tpu.formats import CSR as JCSR

        A = JCSR(2, 2, np.array([0, 2, 4], np.int32), np.array([0, 1, 0, 1], np.int32),
                 np.array([0.0, 1.0, 1.0, 2.0]))
    else:
        from spmv_tpu.formats import CSR as JCSR

        A = JCSR(2, 2, np.array([0, 2, 3], np.int32), np.array([0, 0, 1], np.int32),
                 np.array([1.0, 1.0, 2.0]))
    errs = []
    for f, M in ((jtri.ilu0, A), (ttri.ilu0, _port(A))):
        with pytest.raises((ValueError, ZeroDivisionError)) as e:
            f(M)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


# --- K14's arithmetic, written in NumPy, against its plain version

def _k14_numpy(rows, cols, vals, diag, b, n, rnd=lambda v: v):
    """K14 on float32 NumPy arrays (2-byte inputs already widened): level
    by level every slot reads x as it stands before the level, sums
    acc = 0 + vals[w] * x[cols[w]] in slot order w = 0..W-1, and writes
    (b[row] - acc) / diag, rounded by `rnd`, to x[row], a padding row
    (-1) reading b[0] and writing slot n."""
    x = np.zeros(n + 1, np.float32)
    L, PL, W = cols.shape
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for lev in range(L):
            xg = x[cols[lev]]
            acc = np.zeros(PL, np.float32)
            for w in range(W):
                acc = acc + vals[lev, :, w] * xg[:, w]
            r = rows[lev]
            xi = (b[np.maximum(r, 0)] - acc) / diag[lev]
            x[np.where(r >= 0, r, n)] = rnd(xi.astype(np.float32))
    return x[:n]


def _same_bits_nan(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin].view(np.uint32), want[fin].view(np.uint32))


def _made_plan():
    """A plan made by hand: 3 levels of 4 slots, W 3, padding rows and
    slots, row 0 written in the last level (as an upper triangle has it),
    so that earlier padding slots read x[0] = 0 and the last level's read
    it before row 0 is written."""
    rows = np.array([[3, 5, -1, -1], [1, 4, 2, -1], [0, -1, -1, -1]], np.int32)
    cols = np.zeros((3, 4, 3), np.int32)
    cols[1, 0, :2], cols[1, 1, :1], cols[1, 2, :3] = (3, 5), (5,), (3, 5, 3)
    cols[2, 0, :3] = (1, 2, 4)
    vals = np.zeros((3, 4, 3), np.float32)
    vals[1, 0, :2], vals[1, 1, :1], vals[1, 2, :3] = (0.5, -2.0), (3.0,), (1.0, 1.0, -1.5)
    vals[2, 0, :3] = (0.25, -0.75, 1.5)
    diag = np.array([[2.0, -1.0, 1.0, 1.0], [4.0, 0.5, 3.0, 1.0], [1.5, 1.0, 1.0, 1.0]],
                    np.float32)
    return rows, cols, vals, diag, 6


def _plans():
    out = {"made": _made_plan()}
    for name in sorted(PLANS):
        A, lower, unit = PLANS[name]()
        p = ttri._build_solve_plan(_port(A), lower, unit)
        out[name] = (p["rows"].numpy(), p["cols"].numpy(), p["vals"].numpy(),
                     p["diag"].numpy(), A.n_rows)
    return out


B_CASES = {
    "normal": lambda n, rng: rng.standard_normal(n).astype(np.float32),
    "inf_nan": lambda n, rng: np.where(rng.random(n) < 0.1, np.float32(np.inf),
                                       np.where(rng.random(n) < 0.1, np.float32(np.nan),
                                                rng.standard_normal(n))).astype(np.float32),
    "inf_at_row_0": lambda n, rng: np.concatenate(
        [[-np.inf], rng.standard_normal(n - 1)]).astype(np.float32),
}


@pytest.mark.parametrize("bcase", sorted(B_CASES))
@pytest.mark.parametrize("plan", ["made"] + sorted(PLANS))
def test_k14_arithmetic_matches_plain_version(plan, bcase):
    rows, cols, vals, diag, n = _plans()[plan]
    b = B_CASES[bcase](n, np.random.default_rng(3))
    want = _k14_numpy(rows, cols, vals, diag, b, n)
    got = ttri._sptrsv_plain(*(torch.from_numpy(a) for a in (rows, cols, vals, diag, b)),
                             n=n)
    _same_bits_nan(got.numpy(), want)
    if bcase == "normal":
        assert np.isfinite(want).all()
    l0 = ttri._level_of_row0(torch.from_numpy(rows))
    assert rows[l0].tolist().count(0) == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("plan", ["made", "lower_200", "upper_120"])
def test_k14_rounds_two_byte_values_once_where_x_is_written(plan, dtype):
    """2-byte values: float32 arithmetic on the widened values, x rounded
    to the dtype (to nearest even) once where it is written; the public
    sptrsv in that dtype too."""
    dt = getattr(torch, dtype)
    rows, cols, vals, diag, n = _plans()[plan]
    b = B_CASES["normal"](n, np.random.default_rng(4))
    half = lambda a: torch.from_numpy(a).to(dt)
    widen = lambda a: half(a).float().numpy()
    rnd = lambda v: torch.from_numpy(v).to(dt).float().numpy()
    want = _k14_numpy(rows, cols, widen(vals), widen(diag), widen(b), n, rnd)
    got = ttri._sptrsv_plain(torch.from_numpy(rows), torch.from_numpy(cols), half(vals),
                             half(diag), half(b), n=n)
    assert got.dtype == dt
    _same_bits_nan(got.float().numpy(), want)
    if plan != "made":
        import ml_dtypes

        A, lower, unit = PLANS[plan]()
        np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float16
        Ab = TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                  np.asarray(A.Ax).astype(np_dt))
        x = ttri.sptrsv(Ab, half(b), lower=lower, unit_diagonal=unit)
        _same_bits_nan(x.float().numpy(), want)
