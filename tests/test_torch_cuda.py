"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the 'stream' kind on a CUDA tensor against the oracle.

Needs an NVIDIA GPU: every test here is marked `cuda` and skips without
one. It imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.ops.semiring import PLUS_TIMES

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["normal", "int"])
def case(request, cuda):
    A = power_law_csr(16384, 16384, 90000, seed=11)
    rng = np.random.default_rng(0)
    if request.param == "int":  # every sum exact in float32
        A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                               rng.integers(-4, 5, A.nnz).astype(np.float32))
        x = rng.integers(-4, 5, A.n_cols).astype(np.float32)
    else:
        x = rng.standard_normal(A.n_cols).astype(np.float32)
    plan = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    return request.param, A, plan.to(cuda), torch.from_numpy(x).to(cuda)


def _same(kind, got, want, exact=False):
    if exact or kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernels_match_plain_versions(case):
    kind, A, plan, x = case
    g, rd, sc = plan.gather, plan.reduce, plan.scan
    xnat = torch.nn.functional.pad(
        x, (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
    n_w = plan.x_rows_pad // 128
    before = tstream._xprep_pass.launches
    x2d = tstream._xprep_pass(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w)
    assert tstream._xprep_pass.launches == before + 1
    _same(kind, x2d, tstream._xprep_plain(xnat, g["g0"], g["xr1"], g["xr2"],
                                          g["xr3"], n_w=n_w), exact=True)

    kw = dict(sr=PLUS_TIMES, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
              out_rows=rd["out_rows"])
    args = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"])
    part = tstream._reduce_pass(*args, **kw)
    _same(kind, part, tstream._reduce_plain(*args, **kw))

    data = part
    for p, d in zip(plan.shuffle.passes, plan.shuffle_dev):
        skw = dict(n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                   rows_per_g=p.out_rows // p.K)
        sargs = (data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"])
        out = tshuffle._run_split(*sargs, gaps=d["gaps"], **skw)
        _same(kind, out, tshuffle._split_plain(*sargs, **skw), exact=True)
        data = out.reshape(p.out_rows, 128)

    F_pad = sc["counts"].shape[0]
    prod = torch.nn.functional.pad(data, (0, 0, 0, F_pad * 128 - data.shape[0]))
    keys = ("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1", "q2s2",
            "q2s3", "valid2", "counts")
    _same(kind, tstream._scan_pass(prod, *[sc[k] for k in keys], F_pad=F_pad),
          tstream._scan_diff_plain(prod, *[sc[k] for k in keys], F_pad=F_pad))
    torch.cuda.synchronize()


def test_stream_on_cuda_matches_oracle_and_counts_launches(case):
    kind, A, _, x = case
    y = spmv_tpu_torch.spmv("stream", A, x)  # builds and caches the plan
    counters = (tstream._xprep_pass, tstream._reduce_pass,
                tshuffle._run_split, tstream._scan_pass)
    for k in counters:
        k.launches = 0
    y = spmv_tpu_torch.spmv("stream", A, x)
    torch.cuda.synchronize()
    plan = spmv_tpu_torch.plan_cache(
        A, tstream.plan_cache_key(tstream.StreamPolicy()), None)
    assert [k.launches for k in counters] == \
        [1, 1, len(plan.shuffle.passes), 1]
    assert y.device.type == "cuda" and torch.isfinite(y).all()
    y_ref = spmv_tpu_torch.spmv_ref(A, x.cpu().numpy(), y_dtype=np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=RTOL, atol=ATOL)
    y_cpu = spmv_tpu_torch.spmv("stream", A, x.cpu())
    _same(kind, y.cpu(), y_cpu)


def _empty_rows():
    # power-law rows in the top 20000 of 50000 rows with a 1024-row gap
    rng = np.random.default_rng(6)
    w = (1.0 + np.arange(20000)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(20000, size=80000, p=w / w.sum())
    rows = np.where((rows >= 5000) & (rows < 6024), rows + 1024, rows)
    cols = rng.integers(0, 50000, 80000)
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        50000, 50000, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(80000).astype(np.float32)))


def _hot_columns():
    # power-law rows, a tenth of the nnz on 4 columns (broadcast pages)
    rng = np.random.default_rng(21)
    n, nnz = 32768, 200000
    w = (1.0 + np.arange(n)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(n, size=nnz, p=w / w.sum())
    cols = np.where(rng.random(nnz) < 0.1, rng.integers(0, 4, nnz),
                    rng.integers(0, n, nnz))
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32)))


EDGE_CASES = {
    "empty_rows": (_empty_rows, {}),
    "hot_columns": (_hot_columns, {}),
    # the last shuffle pass pads past the scan's F_pad
    "shuffle_rows_past_scan": (
        lambda: power_law_csr(1 << 16, 1 << 16, 300000, seed=42), {"kappa": 2048}),
    "no_remap": (lambda: power_law_csr(16384, 16384, 60000, seed=12),
                 {"kappa": 8192, "remap": False}),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_stream_edge_cases_on_cuda(cuda, name):
    make, policy = EDGE_CASES[name]
    A = make()
    x = np.random.default_rng(1).standard_normal(A.n_cols).astype(np.float32)
    pol = tstream.StreamPolicy(**policy)
    y = tstream._stream_spmv(A, torch.from_numpy(x).to(cuda), PLUS_TIMES, pol)
    y_cpu = tstream._stream_spmv(A, torch.from_numpy(x), PLUS_TIMES, pol)
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=RTOL, atol=ATOL)


def test_stream_or_and_and_bands_on_cuda(cuda, monkeypatch):
    A = power_law_csr(1 << 16, 1 << 16, 120000, alpha=1.5, seed=1)
    rng = np.random.default_rng(3)
    x = np.where(rng.random(A.n_cols) < 0.7, 0.0,
                 rng.standard_normal(A.n_cols)).astype(np.float32)
    y = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x).to(cuda),
                            semiring=spmv_tpu_torch.OR_AND)
    np.testing.assert_array_equal(
        y.cpu().numpy(), spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.OR_AND))
    monkeypatch.setattr(tstream, "BAND_NNZ", 40000)
    yb = tstream._stream_spmv(A, torch.from_numpy(x).to(cuda), PLUS_TIMES,
                              tstream.StreamPolicy(kappa=4096))
    np.testing.assert_allclose(
        yb.cpu().numpy(), spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64),
        rtol=2e-4, atol=1e-4)


def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((1024, 128), device=cuda)
    g0 = torch.zeros(8, dtype=torch.int32, device=cuda)
    r = torch.zeros((1024, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        tstream._xprep_pass(x, g0.long(), r, r, r, n_w=8)
    with pytest.raises(ValueError, match="on cpu"):
        tstream._xprep_pass(x, g0.cpu(), r, r, r, n_w=8)
    with pytest.raises(ValueError, match="contiguous"):
        tstream._xprep_pass(x, g0, r.t().contiguous().t(), r, r, n_w=8)
