"""The DIA kind's seam and kernel: the port's `diag_profile` and
`build_dia_plan` equal the reference's bit for bit, and the plain
PyTorch version of K12 matches the reference's Pallas kernel in
interpret mode (offsets within its +-8000 halo) and its XLA pass (past
it).

K12 folds the diagonals in the reference's order, so min and max rings
and integer-valued float32 data match bit for bit; float sums are held
to rtol 2e-4 / atol 1e-5, the tolerance of every plus-times kind, since
XLA may contract or reorder them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.formats import COO as JCOO
from spmv_tpu.formats import coo_to_csr as j_coo_to_csr
from spmv_tpu.kernels import dia as jdia
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import dia as tdia
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5


def _port_csr(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _diag_matrix(n, offsets, seed, ints=False, drop=0.1, dups=0):
    """A square matrix on the given diagonals, a share of its slots
    dropped (invalid), `dups` duplicate entries appended."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in offsets:
        r = np.arange(max(0, -d), min(n, n - d))
        r = r[rng.random(r.size) >= drop]
        rows.append(r)
        cols.append(r + d)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    if dups:
        pick = rng.integers(0, rows.size, dups)
        rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    vals = (rng.integers(-4, 5, rows.size) if ints
            else rng.standard_normal(rows.size)).astype(np.float32)
    return j_coo_to_csr(JCOO(n, n, rows.astype(np.int32), cols.astype(np.int32), vals))


@pytest.mark.parametrize("offsets", [(-64, -1, 0, 1, 64), (-9000, -3, 0, 2, 8500)])
def test_dia_plan_matches_reference(offsets):
    A = _diag_matrix(20000, offsets, seed=1, dups=300)
    pj = jdia.diag_profile(A)
    pt = tdia.diag_profile(_port_csr(A))
    np.testing.assert_array_equal(pj[0], pt[0])
    assert pj[1] == pt[1]
    vj, okj, dj = jdia.build_dia_plan(A, pj[0])
    vt, okt, dt = tdia.build_dia_plan(_port_csr(A), pt[0])
    for a, b in ((vj, vt), (okj, okt)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert dj == dt == offsets


def test_dia_profile_refusals_match_reference():
    from spmv_tpu.io.generate import random_csr

    for A in (random_csr(500, 500, 4000, seed=2),      # > 64 diagonals
              random_csr(300, 400, 900, seed=3),       # not square
              _diag_matrix(2000, (0, 1500), seed=4, drop=0.99)):  # fill > 4
        assert jdia.diag_profile(A) is None
        assert tdia.diag_profile(_port_csr(A)) is None


def test_dia_plan_sums_duplicates_whatever_the_ring():
    A = _port_csr(_diag_matrix(500, (-1, 0, 1), seed=5, dups=50))
    vals, valid, _ = tdia.build_dia_plan(A, tdia.diag_profile(A)[0])
    dense = A.to_dense()  # sums duplicates
    for i, d in enumerate((-1, 0, 1)):
        r = np.arange(max(0, -d), min(500, 500 - d))
        np.testing.assert_array_equal(vals[i, r], dense[r, r + d])


CASES = {"plus_float": (jsr.PLUS_TIMES, tsr.PLUS_TIMES, False),
         "plus_int": (jsr.PLUS_TIMES, tsr.PLUS_TIMES, True),
         "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS, False),
         "max_times": (jsr.MAX_TIMES, tsr.MAX_TIMES, False)}


@pytest.mark.parametrize("path,offsets", [
    ("pallas", (-7000, -129, -1, 0, 1, 5, 7999)),
    ("xla", (-9000, -1, 0, 1, 12000))])
@pytest.mark.parametrize("case", list(CASES))
def test_k12_plain_matches_reference(case, path, offsets):
    jring, tring, ints = CASES[case]
    n = 20000
    A = _diag_matrix(n, offsets, seed=len(case), ints=ints)
    rng = np.random.default_rng(7)
    x = (rng.integers(-4, 5, n) if ints else rng.standard_normal(n)).astype(np.float32)
    diags, _ = jdia.diag_profile(A)
    vals, valid, dtup = jdia.build_dia_plan(A, diags)
    if path == "pallas":
        assert max(abs(d) for d in dtup) <= jdia.MAX_SHIFT
        want = jdia._dia_matvec_pallas(vals, valid, jnp.asarray(x), sr=jring,
                                       diags=dtup, n_rows=n, interpret=True)
    else:
        assert max(abs(d) for d in dtup) > jdia.MAX_SHIFT
        want = jdia._dia_matvec_xla(vals, valid, jnp.asarray(x), sr=jring,
                                    diags=dtup, n_rows=n)
    want = np.asarray(want)
    got = tdia._dia_pass(torch.from_numpy(np.array(vals)),
                         torch.from_numpy(np.array(valid)), torch.from_numpy(x),
                         torch.tensor(dtup, dtype=torch.int32), sr=tring).numpy()
    if case == "plus_float":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_dia_kind_matches_reference_and_oracle(ring):
    import spmv_tpu
    import spmv_tpu_torch

    jring = jsr.BUILTIN_SEMIRINGS[ring]
    tring = tsr.BUILTIN_SEMIRINGS[ring]
    A = _diag_matrix(6000, (-77, -1, 0, 1, 77), seed=9)
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    if ring == "or_and":
        x[np.random.default_rng(4).random(x.size) < 0.7] = 0.0
    want = np.asarray(spmv_tpu.spmv("dia", A, x, semiring=jring))
    got = spmv_tpu_torch.spmv("dia", _port_csr(A), torch.from_numpy(x),
                              semiring=tring).numpy()
    oracle = spmv_tpu_torch.spmv_ref_semiring(_port_csr(A), x, tring)
    if ring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, spmv_tpu_torch.spmv_ref(_port_csr(A), x, y_dtype=np.float64),
            rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)


def test_dia_kind_falls_back_to_stream_on_non_diagonal_matrices():
    import spmv_tpu_torch
    from spmv_tpu_torch.io.generate import random_csr

    A = random_csr(3000, 3000, 20000, seed=6)
    x = np.random.default_rng(5).standard_normal(A.n_cols).astype(np.float32)
    np.testing.assert_allclose(
        spmv_tpu_torch.spmv("dia", A, torch.from_numpy(x)).numpy(),
        spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
