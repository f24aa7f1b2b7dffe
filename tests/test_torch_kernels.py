"""Plain PyTorch versions of the four ported kernels (K1 x prep, K2
reduce, K5 split, K6 scan) against the reference's Pallas kernels in
interpret mode, on one small plan's own arrays.

K1 and K5 only move values, so they must match bit for bit. K2 and K6
add: on integer-valued data every sum is exact in float32 and they
must match bit for bit too; on normal data they are held to the
tolerance the reference holds its stream kind to (rtol 2e-4, atol 1e-5)
because the sums run in another order."""

import numpy as np
import pytest
import torch

from spmv_tpu.formats import CSR as JCSR
from spmv_tpu.io.generate import power_law_csr
from spmv_tpu.kernels import shuffle as jshuffle
from spmv_tpu.kernels import stream as jstream
from spmv_tpu.ops.routing import apply_routes_np
from spmv_tpu.ops.semiring import PLUS_TIMES as J_PLUS_TIMES
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.kernels.tile_ops import flat_cumsum_tiles, flat_iota, route3_batched
from spmv_tpu_torch.ops.routing import route_tiles
from spmv_tpu_torch.ops.semiring import PLUS_TIMES

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    """One small power-law matrix (the reduce + remap branch), its
    reference plan, and an integer-valued copy of it (values and x in
    [-4, 4]) with its own plan."""
    A = power_law_csr(16384, 16384, 90000, seed=11)
    rng = np.random.default_rng(0)
    A_int = JCSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                 rng.integers(-4, 5, A.nnz).astype(np.float32))
    pol = jstream.StreamPolicy(kappa=12288)
    out = {}
    for kind, M in (("normal", A), ("int", A_int)):
        x = (rng.standard_normal(A.n_cols) if kind == "normal"
             else rng.integers(-4, 5, A.n_cols)).astype(np.float32)
        out[kind] = (M, jstream.build_stream_plan(M, pol), x)
    return out


def _x2d_ref(plan, x, n_cols):
    g = plan.gather
    xnat = np.pad(x, (0, g["x_nat_rows"] * 128 - n_cols)).reshape(-1, 128)
    x2d = np.asarray(jstream._xprep_pass(
        xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"],
        n_w=plan.x_rows_pad // 128, interpret=True))
    return xnat, x2d


def test_route3_matches_apply_routes_np():
    rng = np.random.default_rng(1)
    nt = 3
    src = np.stack([rng.permutation(128 * 128).reshape(128, 128)
                    for _ in range(nt)]).astype(np.int32)
    src[0, ::3, ::5] = -1  # don't-care slots
    s1, s2, s3 = route_tiles(src, dedupe=False)
    v = rng.standard_normal((nt, 128, 128)).astype(np.float32)
    want = apply_routes_np(v, s1, s2, s3)
    got = route3_batched(T(v.reshape(-1, 128)), T(s1.reshape(-1, 128)),
                         T(s2.reshape(-1, 128)), T(s3.reshape(-1, 128)))
    np.testing.assert_array_equal(got.numpy().reshape(nt, 128, 128), want)
    live = src >= 0
    np.testing.assert_array_equal(
        want[live], np.take_along_axis(v.reshape(nt, -1),
                                       src.reshape(nt, -1).clip(0), 1
                                       ).reshape(nt, 128, 128)[live])


def test_flat_cumsum_and_iota():
    v = torch.arange(2 * 128 * 128, dtype=torch.float64).reshape(-1, 128)
    got = flat_cumsum_tiles(v)
    want = v.reshape(2, -1).cumsum(1).reshape(-1, 128)
    assert torch.equal(got, want)
    fi = flat_iota((128, 128))
    assert fi[3, 5].item() == 3 * 128 + 5 and fi.dtype == torch.int32


@pytest.mark.parametrize("kind", ["normal", "int"])
def test_xprep_plain_matches_reference(case, kind):
    A, plan, x = case[kind]
    g = plan.gather
    xnat, want = _x2d_ref(plan, x, A.n_cols)
    got = tstream._xprep_plain(T(xnat), T(g["g0"]), T(g["xr1"]), T(g["xr2"]),
                               T(g["xr3"]), n_w=plan.x_rows_pad // 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["normal", "int"])
def test_reduce_plain_matches_reference(case, kind):
    A, plan, x = case[kind]
    g, rd = plan.gather, plan.reduce
    gt, Qp = plan.n_gather_tiles, rd["Qp"]
    _, x2d = _x2d_ref(plan, x, A.n_cols)
    want = np.asarray(jstream._reduce_pass(
        x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], None,
        sr=J_PLUS_TIMES, sbt=8, n_tiles=gt, Qp=Qp, out_rows=rd["out_rows"],
        interpret=True))
    got = tstream._reduce_plain(
        T(x2d), T(g["Ax"]), T(g["q"]), T(g["xb"]), T(rd["c1"]), T(rd["c2"]),
        T(rd["c3"]), sr=PLUS_TIMES, n_tiles=gt, Qp=Qp,
        out_rows=rd["out_rows"]).numpy()
    # Flat index 0 of a tile that holds nnz is a sublane-first run (c3
    # bit 7 set), so it never reads a predecessor. Tiles without nnz are
    # all junk; there the reference reads its neighbour tile's last
    # value and the port takes 0, so those slots are left out.
    c3 = np.asarray(rd["c3"]).reshape(gt, 128, 128)
    live = (np.asarray(g["q"]).reshape(gt, -1) >= 0).any(axis=1)
    assert ((c3[:, 0, 0] >> 7) == 1)[live].all()
    keep = np.ones((gt, Qp * 128), bool)
    keep[~live, 0] = False
    keep = keep.reshape(-1, 128)
    assert (got[gt * Qp:] == 0).all()  # rows past gt*Qp are zero-filled
    w, g2 = want[:gt * Qp][keep], got[:gt * Qp][keep]
    if kind == "int":
        np.testing.assert_array_equal(g2, w)
    else:
        np.testing.assert_allclose(g2, w, rtol=RTOL, atol=ATOL)


def test_reduce_plain_or_and_counts(case):
    A, plan, x = case["int"]
    g, rd = plan.gather, plan.reduce
    gt, Qp = plan.n_gather_tiles, rd["Qp"]
    _, x2d = _x2d_ref(plan, x, A.n_cols)
    args = (T(x2d), T(g["Ax"]), T(g["q"]), T(g["xb"]), T(rd["c1"]),
            T(rd["c2"]), T(rd["c3"]))
    cnt = tstream._reduce_plain(*args, sr=tstream._OR_AND_COUNTING,
                                n_tiles=gt, Qp=Qp, out_rows=rd["out_rows"])
    # the counting combine is plus-times on the 0/1 indicators
    ind = ((args[0] != 0).float(), (args[1] != 0).float()) + args[2:]
    want = tstream._reduce_plain(*ind, sr=PLUS_TIMES, n_tiles=gt, Qp=Qp,
                                 out_rows=rd["out_rows"])
    assert torch.equal(cnt, want)
    with pytest.raises(NotImplementedError, match="K7"):
        from spmv_tpu_torch.ops.semiring import MIN_PLUS

        tstream._reduce_pass(*args, sr=MIN_PLUS, n_tiles=gt, Qp=Qp,
                             out_rows=rd["out_rows"])


@pytest.mark.parametrize("pass_i", [0, 1])
def test_split_plain_matches_reference(case, pass_i):
    _, plan, _ = case["normal"]
    p, d = plan.shuffle.passes[pass_i], plan.shuffle_dev[pass_i]
    data = np.random.default_rng(pass_i).standard_normal(
        (p.in_rows, 128)).astype(np.float32)
    kw = dict(n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
              rows_per_g=p.out_rows // p.K)
    want = np.asarray(jshuffle._run_split(
        data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"],
        interpret=True, **kw))
    got = tshuffle._split_plain(T(data), T(d["s1"]), T(d["s2"]), T(d["s3"]),
                                T(d["starts"]), T(d["pos"]), **kw).numpy()
    gaps = tshuffle.gap_rows(np.asarray(d["pos"]), p.sbt, p.Q,
                             p.out_rows // p.K)
    covered = np.ones(p.out_rows // p.K, bool)
    covered[gaps] = False
    np.testing.assert_array_equal(got[:, covered], want[:, covered])
    assert (got[:, ~covered] == 0).all()


def test_gap_rows():
    assert tshuffle.gap_rows(np.array([0, 2]), 2, 3, 20).tolist() == \
        [6, 7, 8, 9, 10, 11, 18, 19]


@pytest.mark.parametrize("kind", ["normal", "int"])
def test_scan_plain_matches_reference(case, kind):
    _, plan, _ = case[kind]
    sc = plan.scan
    F_pad = np.asarray(sc["counts"]).shape[0]
    rng = np.random.default_rng(5)
    prod = (rng.integers(-4, 5, (F_pad * 128, 128)) if kind == "int"
            else rng.standard_normal((F_pad * 128, 128))).astype(np.float32)
    keys = ("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1", "q2s2",
            "q2s3", "valid2", "counts")
    want = np.asarray(jstream._scan_pass(
        prod, sc["relid"], *[sc[k] for k in keys], sr=J_PLUS_TIMES,
        F_pad=F_pad, interpret=True))
    got = tstream._scan_diff_plain(T(prod), *[T(sc[k]) for k in keys],
                                   F_pad=F_pad).numpy()
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrappers_take_plain_version_on_cpu(case):
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    A, plan, x = case["int"]
    tp = tstream.build_stream_plan(
        tstream.CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                    np.asarray(A.Ax)), tstream.StreamPolicy(kappa=12288))
    dev = tp.to("cpu")
    counters = (tstream._xprep_pass, tstream._reduce_pass,
                tstream._scan_pass, tshuffle._run_split)
    before = [k.launches for k in counters]
    g = dev.gather
    xnat = torch.nn.functional.pad(
        T(x), (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
    got = tstream._xprep_pass(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"],
                              n_w=tp.x_rows_pad // 128)
    np.testing.assert_array_equal(got.numpy(), _x2d_ref(plan, x, A.n_cols)[1])
    assert [k.launches for k in counters] == before
    with pytest.raises(ValueError, match="device"):
        tstream._xprep_pass(xnat.to("meta"), g["g0"], g["xr1"], g["xr2"],
                            g["xr3"], n_w=tp.x_rows_pad // 128)
