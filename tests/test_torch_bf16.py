"""bfloat16 and float16 values on the port's stream path against the
reference's, on the CPU.

- `tests/test_kernels.py::test_bfloat16_values` ported: the reference's
  matrix and seed, bf16 A and x, on `xla`, `stream`, `merge` and
  `csr_vector`, each within 0.08 of the float32 oracle (max error over
  max(1, max|y|)), and within 0.02 of the reference's own y. The port
  sums in float32 and rounds where a kernel writes; the reference sums in
  bf16. Measured here: port 0.0017 from the oracle, reference 0.0105,
  the two 0.0116 apart on the stream kinds. `xla` folds its bf16
  products in float64 and rounds once (`segment_reduce_sorted`): its y
  equals that sum rounded, bit for bit, and lies no farther from the
  oracle than the reference's, which sums in bf16.
- bf16 min-plus and max-times on `stream`, both branches, equal the
  reference bit for bit: rounding is monotone, so rounding once at the
  write gives what rounding every partial gives.
- The plan of a bf16 matrix equals the reference's bit for bit (its Ax
  through a uint16 view), whether Ax is an ml_dtypes array or a torch
  tensor.
- The plain K1, K3, K4, K5, K7 and K8 in bf16 and f16 compute in float32
  and round at the write: each equals its float32 run on the widened
  inputs, rounded, bit for bit (the moves, K1 and K5, give the input's
  bits), and the reference's Pallas kernels in interpret mode agree bit
  for bit in min-plus.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.kernels import stream as jstream
from spmv_tpu_torch.formats import CSR, as_values, host_values
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import stream as tstream
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

BF16 = ml_dtypes.bfloat16


def _bits(y) -> np.ndarray:
    """A bf16 result's bit patterns, from a torch tensor or an array."""
    if isinstance(y, torch.Tensor):
        return y.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(y).view(np.uint16)


def _pair(A, Ax, as_tensor=False):
    """The reference's CSR with Ax in bf16 and the port's, Ax as the same
    ml_dtypes array or as a torch.bfloat16 tensor."""
    ax = np.asarray(Ax).astype(BF16)
    Aj = spmv_tpu.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, ax)
    port_ax = as_values(host_values(ax), torch.bfloat16) if as_tensor else ax
    return Aj, CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), port_ax)


@pytest.fixture(scope="module")
def bf16_case():
    """tests/test_kernels.py:test_bfloat16_values's matrix, x and oracle."""
    A = power_law_csr(3000, 3000, 24000, seed=1)
    x = np.random.default_rng(0).standard_normal(3000)
    return A, x, spmv_tpu.spmv_ref(A, x.astype(np.float32))


@pytest.mark.parametrize("kind", ["xla", "stream", "merge", "csr_vector"])
def test_bfloat16_values(bf16_case, kind):
    A, x, yref = bf16_case
    Aj, At = _pair(A, A.Ax)
    xb = x.astype(BF16)
    y = spmv_tpu_torch.spmv(kind, At, xb)
    assert y.dtype == torch.bfloat16 and y.shape == (A.n_rows,)
    yj = np.asarray(spmv_tpu.spmv(kind, Aj, xb)).astype(np.float32)
    scale = max(1.0, np.abs(yref).max())
    rel = np.abs(y.float().numpy() - yref).max() / scale
    assert rel < 0.08, rel
    if kind == "xla":
        prod = (torch.from_numpy(np.asarray(Aj.Ax).astype(np.float32)).bfloat16()
                * torch.from_numpy(xb.astype(np.float32)).bfloat16()[np.asarray(A.Aj)])
        sums = np.zeros(A.n_rows)
        np.add.at(sums, A.row_ids(), prod.double().numpy())
        np.testing.assert_array_equal(_bits(y), _bits(torch.from_numpy(sums).bfloat16()))
        assert rel <= np.abs(yj - yref).max() / scale
    else:
        assert np.abs(y.float().numpy() - yj).max() / scale < 0.02


@pytest.mark.parametrize("make", [
    lambda: power_law_csr(3000, 3000, 24000, seed=1),
    lambda: random_csr(2000, 2000, 8000, seed=7),
], ids=["reduction", "no_reduction"])
@pytest.mark.parametrize("ring", ["MIN_PLUS", "MAX_TIMES"])
def test_bfloat16_min_max_rings_equal_reference(make, ring):
    A = make()
    rng = np.random.default_rng(5)
    Aj, At = _pair(A, np.abs(np.asarray(A.Ax)) + 0.05, as_tensor=ring == "MAX_TIMES")
    x = np.abs(rng.standard_normal(A.n_cols)).astype(BF16)
    x[rng.random(A.n_cols) < 0.1] = np.inf if ring == "MIN_PLUS" else 0
    yj = spmv_tpu.spmv("stream", Aj, x, semiring=getattr(spmv_tpu, ring))
    yt = spmv_tpu_torch.spmv("stream", At, x, semiring=getattr(spmv_tpu_torch, ring))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(yt), _bits(yj))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["ml_dtypes", "torch"])
def test_bfloat16_plan_equals_reference(as_tensor):
    from test_torch_plan import assert_same_plan

    A = power_law_csr(3000, 3000, 24000, seed=1)
    Aj, At = _pair(A, A.Ax, as_tensor)
    pj = jstream.build_stream_plan(Aj, jstream.StreamPolicy())
    pt = tstream.build_stream_plan(At, tstream.StreamPolicy())
    assert pj.gather["Ax"].dtype == BF16 and pt.gather["Ax"].dtype == np.uint16
    pj.gather["Ax"] = pj.gather["Ax"].view(np.uint16)
    assert_same_plan(pj, pt)
    from spmv_tpu.utils import plancache as jpc
    from spmv_tpu_torch.utils import plancache as tpc

    assert tpc.plan_key(At, tstream.StreamPolicy()) == \
        jpc.plan_key(Aj, jstream.StreamPolicy())


def test_y_dtype_bfloat16_by_name_dtype_and_ml_dtypes():
    """`y_dtype` takes bfloat16 as torch.bfloat16, its name and the
    ml_dtypes dtype, as the reference's takes jnp.bfloat16."""
    A = random_csr(40, 40, 200, seed=1)
    At = CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))
    x = np.ones(40, np.float32)
    yj = spmv_tpu.spmv("merge", A, x, y_dtype=BF16)
    for y_dtype in (torch.bfloat16, "bfloat16", BF16, np.dtype(BF16)):
        y = spmv_tpu_torch.spmv("merge", At, x, y_dtype=y_dtype)
        assert y.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(y), _bits(yj))


# --- the plain versions: float32 compute, rounding at the write ---------

def _widened(args):
    return [a.float() if a.is_floating_point() else a for a in args]


def _same(got, want_f32, dtype):
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16), want_f32.to(dtype).view(torch.int16))


@pytest.fixture(scope="module")
def reduction_plan():
    A = power_law_csr(3000, 3000, 24000, seed=1)
    At = CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))
    plan = tstream.build_stream_plan(At, tstream.StreamPolicy(kappa=12288))
    assert plan.reduce is not None and "xr1" in plan.gather
    return A, plan.to("cpu")


@pytest.fixture(scope="module")
def gather_plan():
    A = random_csr(20000, 30000, 150000, seed=1)
    At = CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))
    plan = tstream.build_stream_plan(At, tstream.StreamPolicy())
    assert plan.reduce is None
    return A, plan.to("cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ring", ["PLUS_TIMES", "MIN_PLUS"])
def test_plain_k1_k7_k5_k8_round_at_the_write(reduction_plan, dtype, ring):
    A, plan = reduction_plan
    sr = getattr(tsr, ring)
    g, rd = plan.gather, plan.reduce
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        g["x_nat_rows"] * 128).astype(np.float32)).to(dtype)
    k1 = (x.reshape(-1, 128), g["g0"], g["xr1"], g["xr2"], g["xr3"])
    x2d = tstream._xprep_pass(*k1, n_w=plan.x_rows_pad // 128)
    _same(x2d, tstream._xprep_pass(*_widened(k1), n_w=plan.x_rows_pad // 128), dtype)
    ax = g["Ax"].to(dtype)
    gt, Qp = plan.n_gather_tiles, rd["Qp"]
    k7 = (x2d, ax, g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
    kw = dict(sr=sr, n_tiles=gt, Qp=Qp, out_rows=rd["out_rows"])
    part = tstream._reduce_pass(*k7, **kw)  # K7: not float32, so every ring
    _same(part, tstream._reduce_roll_pass(*_widened(k7), **kw), dtype)
    ident = float(sr.identity_for(dtype))
    p, d = plan.shuffle.passes[0], plan.shuffle_dev[0]
    k5 = (part, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"])
    k5kw = dict(n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                rows_per_g=p.out_rows // p.K, gaps=d["gaps"], fill=ident)
    moved = tshuffle._run_split(*k5, **k5kw)
    _same(moved, tshuffle._run_split(*_widened(k5), **k5kw), dtype)
    prod_fin = tshuffle.apply_shuffle(part, plan.shuffle.passes, plan.shuffle_dev,
                                      fill=ident)
    sc = plan.scan
    F_pad = sc["counts"].shape[0]
    prod_fin = torch.nn.functional.pad(
        prod_fin, (0, 0, 0, max(0, F_pad * 128 - prod_fin.shape[0])),
        value=ident)[:F_pad * 128].contiguous()
    k8 = (prod_fin, sc["relid"], sc["pm1"], sc["pm2"], sc["pm3"], sc["r2s1"],
          sc["r2s2"], sc["r2s3"], sc["valid2"])
    y = tstream._scan_roll_pass(*k8, sr=sr, F_pad=F_pad)
    _same(y, tstream._scan_roll_pass(*_widened(k8), sr=sr, F_pad=F_pad), dtype)
    # every scan is taken in float32 even where the pick is by dtype: K6
    # is float32 plus-times only
    assert torch.equal(tstream._scan_pass(
        *k8[:8], sc["q2s1"], sc["q2s2"], sc["q2s3"], sc["valid2"], sc["counts"],
        sr=sr, F_pad=F_pad).view(torch.int16), y.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ring", ["PLUS_TIMES", "MAX_TIMES"])
def test_plain_k4_k3_round_at_the_write(gather_plan, dtype, ring):
    A, plan = gather_plan
    sr = getattr(tsr, ring)
    g = plan.gather
    gt = plan.n_gather_tiles
    x2d = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (plan.x_rows_pad * 128, 128)).astype(np.float32)).to(dtype)
    k4 = (x2d, g["Ax"].to(dtype), g["q"], g["xb"])
    prod = tstream._gather_pass(*k4, sr=sr, n_tiles=gt)
    _same(prod, tstream._gather_pass(*_widened(k4), sr=sr, n_tiles=gt), dtype)
    p0, d0 = plan.shuffle.passes[0], plan.shuffle_dev[0]
    kw = dict(sr=sr, sbt=8, n_tiles=gt, K=p0.K, Q=p0.Q,
              rows_per_g=p0.out_rows // p0.K, gaps=d0["gaps"])
    sargs = (d0["s1"], d0["s2"], d0["s3"], d0["starts"], d0["pos"])
    w = tstream._gather_split_pass(*k4, *sargs, **kw)
    _same(w, tstream._gather_split_pass(*_widened(k4), *sargs, **kw), dtype)


def test_plain_bf16_kernels_equal_reference_in_min_plus(reduction_plan):
    """K1 and K7 in bf16 against the reference's Pallas kernels in
    interpret mode: min-plus, so bit for bit."""
    _, plan = reduction_plan
    g, rd = plan.gather, plan.reduce
    x = np.abs(np.random.default_rng(8).standard_normal(
        g["x_nat_rows"] * 128)).astype(BF16).reshape(-1, 128)
    host = [a.numpy() for a in (g["g0"], g["xr1"], g["xr2"], g["xr3"])]
    want1 = np.asarray(jstream._xprep_pass(x, *host, n_w=plan.x_rows_pad // 128,
                                           interpret=True))
    x2d = tstream._xprep_pass(as_values(host_values(x), torch.bfloat16), g["g0"],
                              g["xr1"], g["xr2"], g["xr3"], n_w=plan.x_rows_pad // 128)
    np.testing.assert_array_equal(_bits(x2d), _bits(want1))
    ax = np.abs(g["Ax"].numpy()).astype(BF16)
    gt, Qp = plan.n_gather_tiles, rd["Qp"]
    aux = [rd[k].numpy() for k in ("c1", "c2", "c3", "rs")]
    want7 = np.asarray(jstream._reduce_pass(
        want1, ax, g["q"].numpy(), g["xb"].numpy(), *aux, sr=spmv_tpu.MIN_PLUS,
        sbt=8, n_tiles=gt, Qp=Qp, out_rows=rd["out_rows"], interpret=True))
    got7 = tstream._reduce_pass(x2d, as_values(host_values(ax), torch.bfloat16),
                                g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"],
                                sr=tsr.MIN_PLUS, n_tiles=gt, Qp=Qp,
                                out_rows=rd["out_rows"])
    np.testing.assert_array_equal(_bits(got7)[:gt * Qp], _bits(want7)[:gt * Qp])
