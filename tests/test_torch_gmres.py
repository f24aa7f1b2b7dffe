"""GMRES on the device (spmv_tpu_torch/solvers.py:gmres) and K15, its
Hessenberg least squares (spmv_tpu_torch/kernels/krylov.py), on the CPU.

K15's plain version against NumPy's SVD-based `lstsq` in float64 on
random Hessenbergs (up to m = 1000) and on ones whose Krylov space
closed early (the minimum-norm y, exact zeros past the breakdown); the
chain probe's chain in Python floats;
`gmres` against `spmv_tpu.solvers.gmres` with x0, a restart of 200, a
`maxiter` that is not a multiple of the restart and a diagonal matrix
whose Krylov space closes at step 3;
the chunking of cycles between host reads; and a cycle that reads
nothing on the host."""

import numpy as np
import pytest
import torch

from spmv_tpu import solvers as jsolvers
from spmv_tpu_torch import solvers as tsolvers
from spmv_tpu_torch.kernels import krylov

from test_torch_solvers import _both, _nonsym, _poisson2d, _solve

torch.set_num_threads(1)


def _hessenberg(m, seed, close_at=None, scale=1.0):
    """A random (m+1, m) upper Hessenberg matrix in float32, as Arnoldi
    makes them: a positive subdiagonal, a dominant diagonal, the entries
    above the diagonal N(0, scale^2) (at scale 1 the triangle's condition
    number grows exponentially with m: 1e13 at m = 300, 1e18 at 1000;
    Arnoldi's H on a well-conditioned A stays near A's). With `close_at`
    = k: H[k+1, k] = 0 and every column after k zero, as GMRES leaves H
    when its Krylov space closes at step k."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((m + 1, m)), -1)
    H[np.triu_indices(m + 1, 1, m)] *= scale
    H[np.arange(m), np.arange(m)] += 3.0
    H[np.arange(1, m + 1), np.arange(m)] = 0.5 + rng.random(m)
    if close_at is not None:
        H[close_at + 1, close_at] = 0.0
        H[:, close_at + 1:] = 0.0
    return H.astype(np.float32)


def _k15(H, beta):
    return krylov.hessenberg_lstsq(torch.from_numpy(H), torch.tensor(beta, dtype=torch.float32))


@pytest.mark.parametrize("m", [1, 2, 8, 32, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k15_plain_matches_numpy_lstsq(m, seed):
    """rtol 1e-5 after rounding to float32: both solve in float64; the
    orders of their sums differ (Givens against an SVD)."""
    H = _hessenberg(m, seed)
    beta = float(1.0 + seed)
    e1 = np.zeros(m + 1)
    e1[0] = beta
    want = np.linalg.lstsq(H.astype(np.float64), e1, rcond=None)[0].astype(np.float32)
    before = krylov.hessenberg_lstsq.launches
    y = _k15(H, beta)
    assert krylov.hessenberg_lstsq.launches == before  # the CPU runs the plain version
    assert y.dtype == torch.float32 and y.shape == (m,)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("m,k", [(8, 0), (8, 2), (32, 3), (40, 38), (32, 31)])
def test_k15_early_closing_gives_the_minimum_norm_y(m, k):
    """H[k+1, k] = 0 and zero columns after k: y past k is exactly 0 and
    y up to k is the square system's solution, NumPy's minimum-norm y
    within rtol 1e-5."""
    H = _hessenberg(m, 10 + k, close_at=k)
    e1 = np.zeros(m + 1)
    e1[0] = 2.0
    want = np.linalg.lstsq(H.astype(np.float64), e1, rcond=None)[0]
    y = _k15(H, 2.0).numpy()
    assert np.all(y[k + 1:] == 0)
    np.testing.assert_allclose(y[:k + 1], want[:k + 1].astype(np.float32), rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())
    np.testing.assert_allclose(want[k + 1:], 0, atol=1e-12)


@pytest.mark.parametrize("m", [161, 300, 1000])
@pytest.mark.parametrize("closed", [False, True])
def test_k15_plain_matches_numpy_lstsq_at_large_m(m, closed):
    """Past the register body's columns and the shared-memory triangle
    (and past m = 160, where K15 once stopped): the entries above the
    diagonal scaled by 2 / sqrt(m), which keeps H's condition number near
    5; closed 40 columns from the end. rtol 1e-5 after rounding to
    float32, exact zeros past the closing."""
    k = m - 40 if closed else None
    H = _hessenberg(m, m, close_at=k, scale=2 / np.sqrt(m))
    e1 = np.zeros(m + 1)
    e1[0] = 1.5
    want = np.linalg.lstsq(H.astype(np.float64), e1, rcond=None)[0]
    y = _k15(H, 1.5).numpy()
    np.testing.assert_allclose(y, want.astype(np.float32), rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())
    if closed:
        assert np.all(y[k + 1:] == 0)


@pytest.mark.parametrize("m", [1, 32, 300])
def test_k15_chain_probe_plain(m):
    """The probe's chain in Python floats: the rotations settle on a
    fixed point, the back-substitution adds 1.25 a step exactly, so its
    g counts the steps."""
    a, g = krylov._k15_chain_plain(m)
    assert 0 < a < 2 and g == a + 1.25 * m


@pytest.mark.parametrize("m", [1, 8, 32])
def test_k15_zero_beta_gives_zero_y(m):
    y = _k15(_hessenberg(m, 3), 0.0)
    assert torch.equal(y, torch.zeros(m))
    y = _k15(np.zeros((m + 1, m), np.float32), 0.0)  # beta 0 makes H 0 in GMRES
    assert torch.equal(y, torch.zeros(m))


def test_k15_zero_pivot_rule():
    """A pivot at (m + 1) * 2^-23 * max|R| counts as zero (y_j = 0, its
    column left out), the next float32 above it does not."""
    m = 2
    tol = np.float32((m + 1) * 2.0 ** -23 * 8.0)  # max|R| is H[0, 1] = 8
    for d, zero in ((tol, True), (np.nextafter(tol, np.float32(1)), False)):
        H = np.zeros((m + 1, m), np.float32)
        H[0, 0], H[0, 1], H[1, 1] = d, 8.0, 1.0
        y = _k15(H, 1.0).numpy()
        assert y[1] == 0 and y[0] == (0 if zero else np.float32(1 / np.float64(d)))


def test_k15_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        krylov.hessenberg_lstsq(torch.zeros(3, 2, device="meta"),
                                torch.zeros((), device="meta"))


def _diag3(n=60):
    """A diagonal matrix of three distinct values: GMRES's Krylov space
    closes at step 3."""
    d = np.array([1.0, 2.0, 4.0], np.float32)[np.arange(n) % 3]
    return _both(n, np.arange(n), np.arange(n), d), d


def test_gmres_with_x0_matches_reference():
    Aj, At = _nonsym(160, seed=4)
    rng = np.random.default_rng(5)
    xstar = rng.standard_normal(160).astype(np.float32)
    b = (At.to_dense() @ xstar).astype(np.float32)
    x0 = (xstar + 0.1 * rng.standard_normal(160)).astype(np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, x0=x0, rtol=1e-5, restart=16)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 16, (it, ij)
    np.testing.assert_allclose(xt, xstar, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(xt, xj, rtol=2e-3, atol=2e-3)


def test_gmres_restart_200_matches_reference():
    """A restart past K15's old card limit of 160: the port's CPU run
    against the reference's, with test_gmres_with_x0_matches_reference's
    tolerances. The card's run at m = 200 (its register body of 7 slots,
    the work area in shared memory) is held to this CPU run by
    tests/test_torch_cuda.py:test_gmres_restart_200_matches_the_cpu."""
    Aj, At = _nonsym(300)
    rng = np.random.default_rng(12)
    xstar = rng.standard_normal(300).astype(np.float32)
    b = (At.to_dense() @ xstar).astype(np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-5, restart=200)
    assert it["converged"] and abs(it["iters"] - ij["iters"]) <= 200, (it, ij)
    np.testing.assert_allclose(xt, xstar, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(xt, xj, rtol=2e-3, atol=2e-3)


def test_gmres_maxiter_not_a_multiple_of_the_restart():
    """maxiter 10 at restart 4: three cycles (12 inner iterations), not
    converged, in both packages; x after them agrees."""
    Aj, At = _poisson2d(12)
    b = np.random.default_rng(6).standard_normal(At.n_rows).astype(np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-10, restart=4, maxiter=10)
    assert it["iters"] == ij["iters"] == 12 and not it["converged"]
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("restart", [3, 10])
def test_gmres_krylov_space_closes_at_step_3(restart):
    """Diagonal A of three values: one cycle solves it (rtol 1e-5), in
    both packages, and x is b / d."""
    (Aj, At), d = _diag3()
    b = np.random.default_rng(7).standard_normal(d.size).astype(np.float32)
    xj, ij, xt, it = _solve("gmres", Aj, At, b, rtol=1e-5, restart=restart)
    assert it["converged"] and it["iters"] == ij["iters"] == restart, (it, ij)
    np.testing.assert_allclose(xt, b / d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)


GMRES_CASES = {
    "nonsym": (lambda: _nonsym(200, seed=9), dict(restart=8)),
    "jacobi": (lambda: _poisson2d(14), dict(restart=20, M="jacobi")),
    "ilu0": (lambda: _poisson2d(12), dict(restart=6, M="ilu0")),
    "maxiter_10": (lambda: _poisson2d(12), dict(restart=4, maxiter=10)),
    "csr_vector": (lambda: _nonsym(150), dict(restart=5, kind="csr_vector")),
}


@pytest.mark.parametrize("case", sorted(GMRES_CASES))
def test_gmres_chunking_changes_nothing(case, monkeypatch):
    """1 and 3 cycles between host reads (HOST_CHUNK patched): the same
    iters and x bit for bit, and the host read once before the first
    chunk and once after each."""
    mats, kw = GMRES_CASES[case]
    _, At = mats()
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(At.n_rows)
                         .astype(np.float32))
    m = kw["restart"]
    out = []
    for chunk in (1, 3):
        monkeypatch.setattr(tsolvers, "HOST_CHUNK", chunk)
        reads = tsolvers.host_reads
        x, info = tsolvers.gmres(At, b, rtol=1e-6, **kw)
        cycles = info["iters"] // m
        assert tsolvers.host_reads - reads == 1 + -(-cycles // chunk)
        out.append((x, info))
    (x1, i1), (x3, i3) = out
    assert i1 == i3 and torch.equal(x1, x3)
    if case == "maxiter_10":
        assert i1["iters"] == 12 and not i1["converged"]


def test_gmres_rejects_a_2_byte_b_as_the_reference_does():
    import jax.numpy as jnp

    Aj, At = _nonsym(30)
    b = np.ones(30, np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)):
        with pytest.raises(NotImplementedError):
            jsolvers.gmres(Aj, jnp.asarray(b, jdt), restart=4)
        with pytest.raises(NotImplementedError, match="float32"):
            tsolvers.gmres(At, torch.from_numpy(b).to(tdt), restart=4)


@pytest.mark.parametrize("M", [None, "jacobi", "ilu0"])
def test_a_cycle_reads_nothing_on_the_host(M, monkeypatch):
    """One restart cycle with Tensor.__bool__, .item and .cpu made to
    raise: it completes, and gives the unpatched one-cycle solve's x bit
    for bit."""
    _, At = _poisson2d(8)
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(At.n_rows)
                         .astype(np.float32))
    want, _ = tsolvers.gmres(At, b, rtol=1e-10, restart=6, maxiter=6, M=M)
    ran = []

    def one_cycle(A, name, kind, M_, st, step, steps=tsolvers.CHUNK, restart=None):
        def refuse(*a, **k):
            raise AssertionError("a host read inside a cycle")

        with monkeypatch.context() as mp:
            for attr in ("__bool__", "item", "cpu"):
                mp.setattr(torch.Tensor, attr, refuse)
            step(st)
        ran.append(name)
        return st

    monkeypatch.setattr(tsolvers, "_run", one_cycle)
    x, info = tsolvers.gmres(At, b, rtol=1e-10, restart=6, maxiter=6, M=M)
    assert ran == ["gmres"] and info["iters"] == 6
    assert torch.equal(x, want)


def test_gmres_past_the_stop_changes_nothing():
    """A cycle after the stop leaves the whole state (x, r, k, active) as
    it was, bit for bit (the masked commit), as the card's chunks run it."""
    _, At = _poisson2d(8)
    b = torch.from_numpy(np.random.default_rng(10).standard_normal(At.n_rows)
                         .astype(np.float32))
    seen = {}

    def capture(A, name, kind, M, st, step, steps=tsolvers.CHUNK, restart=None):
        while bool(st["active"]):
            step(st)
        before = {k: v.clone() for k, v in st.items()}
        step(st)
        seen.update(before=before, after=st)
        return st

    mp = pytest.MonkeyPatch()
    with mp.context() as c:
        c.setattr(tsolvers, "_run", capture)
        tsolvers.gmres(At, b, rtol=1e-10, restart=5)
    for k, v in seen["before"].items():
        assert torch.equal(seen["after"][k], v), k
