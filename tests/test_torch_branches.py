"""The stream pipeline's branches and rings end to end on the CPU
(plain versions of the kernels) against the NumPy oracles: the
no-reduction branch (K3/K4), generic rings (K7, K8), scan 'roll', and a
user-defined ring. Exact for min, max and or rings; rtol 2e-4 / atol
1e-5 for float32 sums (tests/test_stream.py's bound)."""

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.io.generate import power_law_csr, random_csr
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _positive(A, seed):
    rng = np.random.default_rng(seed)
    A = CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
            rng.uniform(0.1, 1.0, A.nnz).astype(np.float32))
    return A, rng.uniform(0.1, 1.0, A.n_cols).astype(np.float32)


@pytest.mark.parametrize("make", [
    lambda: random_csr(20000, 30000, 150000, seed=1),
    lambda: power_law_csr(16384, 16384, 90000, seed=11),
], ids=["no_reduction", "reduction"])
def test_min_plus_all_positive_leaks_no_zero(make):
    """With every weight and x positive, each min-plus row is positive or
    inf: a zero-filled junk slot reaching y would show as a 0. Every
    junk row holds the identity (inf) instead."""
    A, x = _positive(make(), 3)
    y = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x),
                            semiring=spmv_tpu_torch.MIN_PLUS).numpy()
    y_ref = spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.MIN_PLUS)
    np.testing.assert_array_equal(y, y_ref)
    assert (y > 0).all()


def test_stream_hot_columns_no_reduction():
    """tests/test_stream.py:30: half the nnz on 5 columns, uniform rows:
    the no-reduction branch with hot-column broadcast pages."""
    rng = np.random.default_rng(4)
    n, nnz = 20000, 120000
    rows = rng.integers(0, n, nnz)
    cols = np.where(rng.random(nnz) < 0.5, rng.integers(0, 5, nnz),
                    rng.integers(0, n, nnz))
    A = spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32)))
    x = _x(n, 4)
    y = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), spmv_tpu_torch.spmv_ref(
        A, x, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
    plan = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    assert plan.reduce is None and plan.hot_cols.shape[0] > 0


def test_stream_empty_rows_no_reduction():
    """tests/test_stream.py:55: uniform rows in the top 20000 of 50000;
    the empty rows and tail come out as the identity."""
    rng = np.random.default_rng(6)
    n = 50000
    rows = rng.integers(0, 20000, 80000)
    cols = rng.integers(0, n, 80000)
    A = spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(80000).astype(np.float32)))
    x = _x(n, 6)
    y = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref(
        A, x, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
    assert (y[20000:] == 0).all()
    ym = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x),
                             semiring=spmv_tpu_torch.MIN_PLUS).numpy()
    np.testing.assert_array_equal(
        ym, spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.MIN_PLUS))
    assert np.isinf(ym[20000:]).all()


def test_stream_reduce_matches_no_reduce():
    """tests/test_stream.py:82: the two gather branches on one matrix."""
    A = _port(power_law_csr(16384, 16384, 60000, alpha=1.5, seed=12))
    x = _x(A.n_cols, 12)
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    ys = {}
    for mode in ("on", "off"):
        ys[mode] = tstream._stream_spmv(
            A, torch.from_numpy(x), spmv_tpu_torch.PLUS_TIMES,
            tstream.StreamPolicy(kappa=4096, reduce=mode)).numpy()
        np.testing.assert_allclose(ys[mode], y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ys["on"], ys["off"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("make", [
    lambda: random_csr(4000, 4000, 30000, seed=7),
    lambda: power_law_csr(8192, 8192, 50000, seed=15),
], ids=["no_reduction", "reduction"])
def test_stream_scan_roll_and_or_and(make):
    """scan_strategy='roll' takes K8 for plus-times too; or-and runs the
    counting ring on either branch."""
    A = _port(make())
    x = _x(A.n_cols, 8)
    y = tstream._stream_spmv(A, torch.from_numpy(x), spmv_tpu_torch.PLUS_TIMES,
                             tstream.StreamPolicy(kappa=12288,
                                                  scan_strategy="roll"))
    np.testing.assert_allclose(y.numpy(), spmv_tpu_torch.spmv_ref(
        A, x, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
    x[np.random.default_rng(8).random(A.n_cols) < 0.6] = 0.0
    yo = spmv_tpu_torch.spmv("stream", A, x, semiring=spmv_tpu_torch.OR_AND)
    np.testing.assert_array_equal(
        yo.numpy(), spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.OR_AND))


MAX_PLUS = spmv_tpu_torch.Semiring(
    name="max_plus", initialize=lambda: float("-inf"),
    combine=lambda a, x: a + x, reduce=lambda acc, v: torch.maximum(acc, v))


@pytest.mark.parametrize("make", [
    lambda: random_csr(4000, 4000, 30000, seed=7),
    lambda: power_law_csr(8192, 8192, 50000, seed=15),
], ids=["no_reduction", "reduction"])
def test_stream_user_defined_ring_on_cpu(make):
    """A ring that is not built in runs on a CPU tensor through the plain
    versions, with its own callables; on the card it runs as the CUDA
    ring its callables trace to (ops/ring_codegen.py)."""
    from spmv_tpu_torch.ops.ring_codegen import ring_header

    A = _port(make())
    x = _x(A.n_cols, 9)
    y = spmv_tpu_torch.spmv("stream", A, x, semiring=MAX_PLUS)
    np.testing.assert_array_equal(
        y.numpy(), spmv_tpu_torch.spmv_ref_semiring(A, x, MAX_PLUS))
    h = ring_header(MAX_PLUS)
    assert "identity() { return __int_as_float(0xff800000); }" in h
    assert "__fadd_rn(a0, a1)" in h and "spmv_tmax(a0, a1)" in h


def test_ring_bodies_are_picked_by_identity_not_name():
    """The reference picks the prefix-difference bodies by ring NAME
    (stream.py:1318, :1610, :1767), so a user ring named "plus_times" or
    "or_and" would run the built-in's arithmetic instead of its own. The
    port matches the built-ins by object identity: such a ring runs its
    own callables (here a min ring under a borrowed name)."""
    A = _port(power_law_csr(8192, 8192, 50000, seed=15))
    x = _x(A.n_cols, 10)
    for name in ("plus_times", "or_and"):
        impostor = spmv_tpu_torch.Semiring(
            name=name, initialize=lambda: float("inf"),
            combine=lambda a, x: a + x,
            reduce=lambda acc, v: torch.minimum(acc, v))
        y = spmv_tpu_torch.spmv("stream", A, x, semiring=impostor)
        want = spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.MIN_PLUS)
        np.testing.assert_array_equal(y.numpy(), want)
        # the oracle too reduces by the ring's own callable
        np.testing.assert_array_equal(
            spmv_tpu_torch.spmv_ref_semiring(A, x, impostor), want)
