"""`spmm` and K13 of the port on the CPU, against spmv_tpu and the
dense oracle, and the container methods it needs.

- `_plan_spmm_window` emits the reference's window plan bit for bit.
- K13's plain version equals the reference's Pallas kernel's product
  rows P (interpret mode) on finite X, bit for bit: both compute one
  product per output, the reference by a one-hot matrix product whose
  other terms are exact zeros.
- The cases of tests/test_spmm.py run through the port, against the
  dense oracle (float64) and, for `window` and `xla`, the reference.
- X holding inf in min-plus: the port gives the semiring oracle's
  values; the reference's one-hot product gives NaN there.
- The thresholds: past either cap the path raises PlanCapacityError
  before it builds anything large, and `auto` then takes `xla`.
- `CSR.transpose`, `astype` and `csr_from_dense` against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu import formats as jfmt
from spmv_tpu.io.generate import banded_csr, power_law_csr, random_csr
from spmv_tpu.kernels import spmm as jspmm
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch import formats as tfmt
from spmv_tpu_torch.kernels import spmm as tspmm
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)


def _port(A):
    return tfmt.CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                    np.asarray(A.Ax))


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _dense_ref(A, X):
    return A.to_dense().astype(np.float64) @ X.astype(np.float64)


def _X(A, B, seed):
    return np.random.default_rng(seed).standard_normal((A.n_cols, B)).astype(np.float32)


def _empty_rows():
    rng = np.random.default_rng(7)
    return jfmt.coo_to_csr(jfmt.COO(900, 700, rng.integers(0, 300, 2500).astype(np.int32),
                                    rng.integers(0, 700, 2500).astype(np.int32),
                                    rng.standard_normal(2500).astype(np.float32)))


PLAN_MATRICES = {
    "random": lambda: random_csr(600, 500, 5000, seed=8),
    "skewed": lambda: power_law_csr(800, 700, 8000, alpha=1.5, seed=9),
    "small_cols": lambda: random_csr(300, 90, 1500, seed=10),
    "empty_rows": _empty_rows,
}


@pytest.mark.parametrize("matrix", list(PLAN_MATRICES))
def test_window_plan_matches_reference(matrix):
    A = PLAN_MATRICES[matrix]()
    pj = jspmm._plan_spmm_window(A)
    pt = tspmm._plan_spmm_window(_port(A))
    assert pj["n_tiles"] == pt["n_tiles"]
    for k in ("q", "ax", "xb", "perm", "rows"):
        _eq(pj[k], pt[k], k)


def _pallas_k13(plan, Xblk, sr, generic):
    """The reference's K13 through pl.pallas_call in interpret mode, as
    _spmm_window_pass (spmv_tpu/kernels/spmm.py:195-218) runs it; its P."""
    sbt, n_tiles = jspmm.SBT_SPMM, plan["n_tiles"]

    def xwin_map(j):
        return lambda t, xb: (xb[t * sbt + j], 0)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_tiles // sbt,),
        in_specs=([pl.BlockSpec((sbt, 128), lambda t, xb: (t, 0))] * 2
                  + [pl.BlockSpec((128, 128), xwin_map(j)) for j in range(sbt)]),
        out_specs=pl.BlockSpec((sbt * 128, 128), lambda t, xb: (t, 0)))
    return np.asarray(pl.pallas_call(
        jspmm._spmm_window_kernel(sbt, sr, generic), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_tiles * 128, 128), jnp.float32),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True,
    )(jnp.asarray(plan["xb"]), jnp.asarray(plan["ax"].astype(np.float32)),
      jnp.asarray(plan["q"]), *([jnp.asarray(Xblk)] * sbt)))


def _padded_block(A, X, plan):
    rows_pad = 128 * max(int(plan["xb"].max(initial=0)) + 1, -(-A.n_cols // 128), 1)
    return np.pad(X, ((0, rows_pad - A.n_cols), (0, 128 - X.shape[1])))


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_k13_plain_matches_pallas(ring):
    jring, tring = getattr(jsr, ring.upper()), getattr(tsr, ring.upper())
    A = power_law_csr(800, 700, 8000, alpha=1.5, seed=9)
    plan = jspmm._plan_spmm_window(A)
    Xblk = _padded_block(A, _X(A, 128, 1), plan)
    want = _pallas_k13(plan, Xblk, jring, generic=ring != "plus_times")
    got = tspmm._spmm_window_pass(
        torch.from_numpy(Xblk), torch.from_numpy(plan["ax"].astype(np.float32)),
        torch.from_numpy(plan["q"]), torch.from_numpy(plan["xb"]), sr=tring).numpy()
    np.testing.assert_array_equal(got, want)


def test_k13_reads_a_strided_column_block():
    A = random_csr(300, 90, 1500, seed=10)
    plan = tspmm._plan_spmm_window(_port(A))
    Xw = torch.from_numpy(_padded_block(A, _X(A, 128, 2), plan)).repeat(1, 3)
    args = (torch.from_numpy(plan["ax"].astype(np.float32)), torch.from_numpy(plan["q"]),
            torch.from_numpy(plan["xb"]))
    blk = Xw[:, 128:256]
    assert not blk.is_contiguous()
    assert torch.equal(tspmm._spmm_window_pass(blk, *args, sr=tsr.PLUS_TIMES),
                       tspmm._spmm_window_pass(blk.contiguous(), *args, sr=tsr.PLUS_TIMES))


# the cases of tests/test_spmm.py: (name, matrix, B, method)
CASES = [
    ("stream_random", lambda: random_csr(600, 500, 5000, seed=1), 128, "stream"),
    ("stream_ragged_B", lambda: random_csr(400, 350, 3000, seed=3), 70, "stream"),
    ("stream_banded", lambda: banded_csr(1500, bandwidth=1, seed=4), 128, "stream"),
    ("stream_empty_rows", _empty_rows, 128, "stream"),
    ("xla", lambda: random_csr(1200, 1000, 10000, seed=5), 128, "xla"),
    ("xla_wide_B", lambda: random_csr(800, 700, 6000, seed=2), 256, "xla"),
    ("window_random", lambda: random_csr(600, 500, 5000, seed=8), 128, "window"),
    ("window_skewed", lambda: power_law_csr(800, 700, 8000, alpha=1.5, seed=9), 128,
     "window"),
    ("window_small_cols", lambda: random_csr(300, 90, 1500, seed=10), 128, "window"),
    ("window_ragged_70", lambda: random_csr(400, 350, 3000, seed=11), 70, "window"),
    ("window_ragged_200", lambda: random_csr(400, 350, 3000, seed=12), 200, "window"),
    ("window_B1", lambda: random_csr(500, 400, 4000, seed=13), 1, "window"),
    ("auto", lambda: random_csr(700, 600, 6000, seed=15), 128, "auto"),
]


@pytest.mark.parametrize("name,make,B,method", CASES, ids=[c[0] for c in CASES])
def test_spmm_cases_match_oracle_and_reference(name, make, B, method):
    A = make()
    X = _X(A, B, 0)
    Y = spmv_tpu_torch.spmm(_port(A), X, method=method)
    assert isinstance(Y, torch.Tensor) and tuple(Y.shape) == (A.n_rows, B)
    np.testing.assert_allclose(Y.numpy(), _dense_ref(A, X), rtol=2e-4, atol=1e-4)
    if method != "stream":  # the reference's stream path is 128x the work
        Yj = np.asarray(spmv_tpu.spmm(A, X, method=method))
        np.testing.assert_allclose(Y.numpy(), Yj, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["window", "stream", "xla"])
@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
def test_spmm_rings_match_semiring_oracle(method, ring):
    tring = getattr(tsr, ring.upper())
    A = _port(banded_csr(600, bandwidth=1, seed=6))
    X = _X(A, 128, 6)
    if ring == "or_and":
        X[np.random.default_rng(16).random(X.shape) < 0.6] = 0
    Y = spmv_tpu_torch.spmm(A, X, semiring=tring, method=method).numpy()
    np.testing.assert_array_equal(Y, spmv_tpu_torch.spmv_ref_semiring(A, X, tring))


def test_spmm_window_min_plus_matches_reference():
    A = banded_csr(600, bandwidth=1, seed=14)
    X = _X(A, 128, 14)
    Y = spmv_tpu_torch.spmm(_port(A), X, semiring=tsr.MIN_PLUS, method="window").numpy()
    np.testing.assert_array_equal(Y, np.asarray(spmv_tpu.spmm(A, X, semiring=jsr.MIN_PLUS,
                                                              method="window")))


def test_spmm_window_inf_in_X_matches_semiring_oracle():
    """Min-plus distances with unreached (inf) entries: the port reads X
    rows directly and matches the oracle; the reference's one-hot matrix
    product turns 0 * inf into NaN across the tile (ROADMAP §3)."""
    A = random_csr(400, 350, 3000, seed=17)
    X = np.abs(_X(A, 128, 17))
    X[np.random.default_rng(18).random(X.shape) < 0.3] = np.inf
    Y = spmv_tpu_torch.spmm(_port(A), X, semiring=tsr.MIN_PLUS, method="window").numpy()
    np.testing.assert_array_equal(Y, spmv_tpu_torch.spmv_ref_semiring(_port(A), X,
                                                                      tsr.MIN_PLUS))
    assert np.isinf(Y).any() and not np.isnan(Y).any()
    Yj = np.asarray(spmv_tpu.spmm(A, X, semiring=jsr.MIN_PLUS, method="window"))
    assert np.isnan(Yj).any()


def test_spmm_empty_and_shapes():
    A = tfmt.CSR(10, 8, np.zeros(11, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32))
    for method in ("window", "xla", "auto"):
        Y = spmv_tpu_torch.spmm(A, np.zeros((8, 5), np.float32), method=method)
        np.testing.assert_array_equal(Y.numpy(), np.zeros((10, 5)))
    Y = spmv_tpu_torch.spmm(A, np.zeros((8, 5), np.float32), semiring=tsr.MIN_PLUS,
                            method="window")
    assert torch.isinf(Y).all()
    B = _port(random_csr(50, 40, 200, seed=1))
    for bad in (np.zeros((41, 3), np.float32), np.zeros(40, np.float32)):
        with pytest.raises(ValueError, match="n_cols"):
            spmv_tpu_torch.spmm(B, bad)


def _big(nnz):
    """One row holding nnz nonzeros (all in column 0)."""
    return tfmt.CSR(1, 4, np.array([0, nnz], np.int64), np.zeros(nnz, np.int32),
                    np.ones(nnz, np.float32))


def test_spmm_thresholds(monkeypatch):
    """Over each cap the path refuses before building its plan; `auto`
    then runs `xla`."""
    def boom(A):
        raise AssertionError("built a plan past the cap")

    monkeypatch.setattr(tspmm, "_kron_expand", boom)
    monkeypatch.setattr(tspmm, "_plan_spmm_window", boom)
    over_stream = _big(64_000_000 // 128 + 1)
    X = np.ones((4, 1), np.float32)
    with pytest.raises(spmv_tpu_torch.PlanCapacityError, match="stream"):
        spmv_tpu_torch.spmm(over_stream, X, method="stream")
    over_window = _big(int(12e9 / (128 * 4 * 2.2)) + 1)
    with pytest.raises(spmv_tpu_torch.PlanCapacityError, match="window"):
        spmv_tpu_torch.spmm(over_window, X, method="window")
    Y = spmv_tpu_torch.spmm(over_window, X, method="auto")
    np.testing.assert_array_equal(Y.numpy(), np.full((1, 1), over_window.nnz, np.float32))
    # at the caps themselves the paths take the matrix
    assert 64_000_000 // 128 * 128 <= 64_000_000
    assert int(12e9 / (128 * 4 * 2.2)) * 128 * 4 * 2.2 <= 12e9


def test_kron_expand_matches_reference():
    A = random_csr(40, 30, 200, seed=0)
    Kj, Kt = jspmm._kron_expand(A), tspmm._kron_expand(_port(A))
    assert (Kj.n_rows, Kj.n_cols) == (Kt.n_rows, Kt.n_cols)
    for f in ("Ap", "Aj", "Ax"):
        _eq(getattr(Kj, f), getattr(Kt, f), f)


def test_csr_transpose_astype_from_dense_match_reference():
    A = power_law_csr(300, 200, 2000, seed=3)
    At = _port(A)
    for got, want in ((At.transpose(), A.transpose()),
                      (At.astype(value_dtype=np.float64, index_dtype=np.int64),
                       A.astype(value_dtype=np.float64, index_dtype=np.int64)),
                      (At.astype(offset_dtype=np.int64), A.astype(offset_dtype=np.int64))):
        assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
        for f in ("Ap", "Aj", "Ax"):
            _eq(getattr(want, f), getattr(got, f), f)
    np.testing.assert_array_equal(At.transpose().to_dense(), A.to_dense().T)
    d = np.where(np.random.default_rng(4).random((60, 45)) < 0.1,
                 np.random.default_rng(5).standard_normal((60, 45)), 0).astype(np.float32)
    want, got = jfmt.csr_from_dense(d), spmv_tpu_torch.csr_from_dense(d)
    for f in ("Ap", "Aj", "Ax"):
        _eq(getattr(want, f), getattr(got, f), f)
    np.testing.assert_array_equal(got.to_dense(), d)
