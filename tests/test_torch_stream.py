"""spmv_tpu_torch's 'stream' kind end to end on the CPU (plain versions
of the kernels) against spmv_tpu's 'stream' (Pallas interpret mode) and
the float64 oracle, at the tolerance the reference holds its stream
kind to (tests/test_stream.py)."""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu_torch import config
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import stream as tstream

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _check(A, x, semiring=None):
    """Port on CPU vs the reference kind and the oracle; returns y."""
    yt = spmv_tpu_torch.spmv("stream", _port(A), torch.from_numpy(x),
                             semiring=semiring)
    assert isinstance(yt, torch.Tensor) and yt.device.type == "cpu"
    assert yt.shape == (A.n_rows,) and yt.dtype == torch.float32
    assert torch.isfinite(yt).all()
    yj = np.asarray(spmv_tpu.spmv("stream", A, x, semiring=semiring))
    if semiring is None:
        y_ref = spmv_tpu_torch.spmv_ref(_port(A), x, y_dtype=np.float64)
        np.testing.assert_allclose(yt.numpy(), y_ref, rtol=RTOL, atol=ATOL)
        # the reference's float32 prefix differences carry rounding of
        # about the oracle tolerance themselves (the port's scan
        # accumulates in float64), so the two are compared at twice it
        np.testing.assert_allclose(yt.numpy(), yj, rtol=2 * RTOL,
                                   atol=2 * ATOL)
    else:
        y_ref = spmv_tpu_torch.spmv_ref_semiring(_port(A), x, semiring)
        np.testing.assert_array_equal(yt.numpy(), y_ref)
        np.testing.assert_array_equal(yt.numpy(), yj)
    return yt


@pytest.mark.parametrize("make", [
    lambda: power_law_csr(16384, 16384, 90000, seed=11),
    lambda: power_law_csr(16384, 20000, 120000, alpha=1.5, seed=2),
], ids=["power_law_90k", "power_law_120k_rect"])
def test_stream_power_law_matches_reference(make):
    A = make()
    _check(A, _x(A.n_cols, 0))


def test_stream_empty_rows_and_tail():
    # power-law rows in the top 20000 of 50000 rows, with a 1024-row gap
    # inside: empty rows and an empty tail must come out as 0
    rng = np.random.default_rng(6)
    n = 50000
    w = (1.0 + np.arange(20000)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(20000, size=80000, p=w / w.sum()).astype(np.int64)
    rows = np.where((rows >= 5000) & (rows < 6024), rows + 1024, rows)
    cols = rng.integers(0, n, 80000).astype(np.int64)
    A = spmv_tpu.coo_to_csr(spmv_tpu.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(80000).astype(np.float32)))
    y = _check(A, _x(n, 6)).numpy()
    assert (y[20000:] == 0).all() and (y[5000:6024] == 0).all()


def test_stream_hot_columns_with_reduction():
    """Power-law rows with a tenth of the nnz on 4 columns: the reduce
    branch with hot-column broadcast pages appended to the x table."""
    rng = np.random.default_rng(21)
    n, nnz = 32768, 200000
    w = (1.0 + np.arange(n)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(n, size=nnz, p=w / w.sum())
    cols = np.where(rng.random(nnz) < 0.1, rng.integers(0, 4, nnz),
                    rng.integers(0, n, nnz))
    A = spmv_tpu.coo_to_csr(spmv_tpu.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32)))
    At = _port(A)
    _check(A, _x(n, 21))
    plan = tstream.build_stream_plan(At, tstream.StreamPolicy(kappa=12288))
    assert plan.reduce is not None and plan.hot_cols.shape[0] > 0


def test_stream_or_and_matches_reference():
    A = power_law_csr(16384, 16384, 90000, seed=11)
    x = _x(A.n_cols, 3)
    x[np.random.default_rng(3).random(A.n_cols) < 0.7] = 0.0
    y = _check(A, x, semiring=spmv_tpu_torch.OR_AND)
    assert set(np.unique(y.numpy())) <= {0.0, 1.0}


def test_spmv_shim_and_y_dtype():
    A = power_law_csr(8192, 8192, 50000, seed=15)
    x = _x(A.n_cols, 15)
    y = spmv_tpu_torch.SpMV("stream", A.n_rows, A.n_cols, A.nnz,
                            np.asarray(A.Ap), np.asarray(A.Aj),
                            np.asarray(A.Ax), x)
    y_ref = spmv_tpu_torch.spmv_ref(_port(A), x, y_dtype=np.float64)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=ATOL)
    y64 = spmv_tpu_torch.spmv("stream", _port(A), x, y_dtype=torch.float64)
    assert y64.dtype == torch.float64


def test_stream_banded_execution(monkeypatch):
    """Past the planner's reach the pipeline runs in row bands; forced
    small bands exercise the cut, the concat and a hub row larger than
    the band budget (tests/test_stream.py:134)."""
    monkeypatch.setattr(tstream, "BAND_NNZ", 40000)
    A = _port(power_law_csr(1 << 16, 1 << 16, 120000, alpha=1.5, seed=1))
    x = _x(1 << 16, 0)
    y = tstream._stream_spmv(A, torch.from_numpy(x), spmv_tpu_torch.PLUS_TIMES,
                             tstream.StreamPolicy(kappa=4096))
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=1e-4)
    bands = [b for b in tstream._cut_bands(A, 40000) if b is not None]
    assert len(bands) >= 2


def test_stream_shuffle_rows_past_scan_rows():
    """A plan whose last shuffle pass pads its final tiles past the
    scan's F_pad (the scan reads only the first F_pad tiles)."""
    A = power_law_csr(1 << 16, 1 << 16, 300000, alpha=1.5, seed=42)
    x = _x(A.n_cols, 42)
    pol = tstream.StreamPolicy(kappa=2048)
    yt = tstream._stream_spmv(_port(A), torch.from_numpy(x),
                              spmv_tpu_torch.PLUS_TIMES, pol)
    plan = spmv_tpu_torch.plan_cache(_port(A), tstream.plan_cache_key(pol),
                                     lambda: tstream.build_stream_plan(_port(A), pol))
    assert plan.shuffle.out_rows > plan.scan["counts"].shape[0] * 128
    y_ref = spmv_tpu_torch.spmv_ref(_port(A), x, y_dtype=np.float64)
    np.testing.assert_allclose(yt.numpy(), y_ref, rtol=RTOL, atol=ATOL)
    yj = np.asarray(spmv_tpu.kernels.stream._stream_spmv(
        A, x, spmv_tpu.PLUS_TIMES, spmv_tpu.kernels.stream.StreamPolicy(kappa=2048)))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=2 * RTOL, atol=2 * ATOL)


def test_stream_without_remap_uses_transpose_glue():
    A = _port(power_law_csr(16384, 16384, 60000, seed=12))
    x = _x(A.n_cols, 12)
    pol = tstream.StreamPolicy(kappa=8192, remap=False)
    y = tstream._stream_spmv(A, torch.from_numpy(x), spmv_tpu_torch.PLUS_TIMES,
                             pol)
    plan = spmv_tpu_torch.plan_cache(A, tstream.plan_cache_key(pol), None)
    assert "xr1" not in plan.gather and plan.reduce is not None
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=ATOL)


def test_stream_plan_dir(tmp_path):
    A = _port(power_law_csr(8192, 8192, 40000, seed=9))
    x = _x(A.n_cols, 9)
    config.set_plan_dir(str(tmp_path))
    try:
        y1 = spmv_tpu_torch.spmv("stream", A, x)
        assert len(list(tmp_path.glob("stream-*.npz"))) == 1
        y2 = spmv_tpu_torch.spmv("stream", _port(A), x)  # new object: loads
    finally:
        config.set_plan_dir(None)
    assert torch.equal(y1, y2)


def test_unported_gather_branch_raises_naming_k3():
    A = random_csr(20000, 30000, 150000, seed=1)
    with pytest.raises(NotImplementedError, match="K3"):
        spmv_tpu_torch.spmv("stream", _port(A), _x(A.n_cols, 1))


def test_unported_gather_branch_raises_naming_k4():
    A = _port(power_law_csr(16384, 16384, 60000, seed=12))
    pol = tstream.StreamPolicy(kappa=6144, reduce="off")
    plan = tstream.build_stream_plan(A, pol)
    p0 = plan.shuffle.passes[0]
    kernel = "K3" if p0.sbt == 8 and p0.n_steps * 8 == plan.n_gather_tiles \
        else "K4"
    with pytest.raises(NotImplementedError, match=kernel):
        tstream._stream_spmv(A, torch.from_numpy(_x(A.n_cols, 2)),
                             spmv_tpu_torch.PLUS_TIMES, pol)


@pytest.mark.parametrize("ring", ["MIN_PLUS", "MAX_TIMES"])
def test_unported_rings_raise_naming_k7_k8(ring):
    A = power_law_csr(8192, 8192, 50000, seed=15)
    with pytest.raises(NotImplementedError, match="K7.*K8"):
        spmv_tpu_torch.spmv("stream", _port(A), _x(A.n_cols, 1),
                            semiring=getattr(spmv_tpu_torch, ring))


def test_bfloat16_raises_naming_k7_k8():
    A = _port(power_law_csr(8192, 8192, 50000, seed=15))
    with pytest.raises(NotImplementedError, match="K7/K8"):
        spmv_tpu_torch.spmv("stream", A, torch.ones(A.n_cols,
                                                     dtype=torch.bfloat16))


def test_tuning_policy_for_devices(capsys):
    from spmv_tpu_torch.ops import tuning

    assert tuning.detect_chip("cpu") == "cpu"
    assert tuning.policy_for(4, "cpu").kappa == 12288
    pol = tuning.policy_for(4, "h100")
    assert pol == tstream.StreamPolicy()
    assert "no measured tuning row" in capsys.readouterr().err
    tuning.policy_for(4, "h100")
    assert capsys.readouterr().err == ""  # the hint is printed once
    assert tuning.dispatch_fields(4, "h100") == {}
    tuning.set_active({"kappa": 8192})
    try:
        assert tuning.policy_for(4, "cpu").kappa == 8192
    finally:
        tuning.set_active(None)
