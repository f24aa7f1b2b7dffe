"""Plain PyTorch versions of the generic-ring kernels (K3, K4, K7, K8)
and of their scan building blocks against the reference's Pallas
kernels in interpret mode, on small plans' own arrays.

Min and max rings, and integer-valued plus-times data, must match bit
for bit; plus-times sums on normal data run in another order and are
held to rtol 2e-4 / atol 1e-5. Rows a reference kernel leaves
unwritten are left out of the comparison; the port fills them with the
ring's identity, which is checked on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.kernels import pallas_utils as jpu
from spmv_tpu.kernels import shuffle as jshuffle
from spmv_tpu.kernels import stream as jstream
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.kernels.tile_ops import segmented_scan_lanes, segmented_scan_tile
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
RINGS = ("PLUS_TIMES", "MIN_PLUS", "MAX_TIMES")


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rings(name):
    return getattr(jsr, name), getattr(tsr, name)


def _check(got, want, name, kind="normal"):
    if name != "PLUS_TIMES" or kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _in_kernel(fn, *args):
    """Run a pallas_utils tile function inside a Pallas kernel (its
    rolls exist only there), in interpret mode."""
    def kernel(*refs):
        refs[-1][...] = fn(*[r[...] for r in refs[:-1]])

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(args[0].shape, args[0].dtype),
        interpret=True)(*args))


@pytest.mark.parametrize("ring", RINGS)
def test_segmented_scan_tile_matches_reference(ring):
    rng = np.random.default_rng(1)
    jr, tr = _rings(ring)
    v = rng.integers(-8, 9, (16, 128)).astype(np.float32)
    seg = np.sort(rng.integers(0, 40, 16 * 128)).reshape(16, 128).astype(np.int32)
    ident = float(jr.identity_for(np.float32))
    want = _in_kernel(lambda a, b: jpu.segmented_scan_tile(a, b, jr.reduce, ident),
                      v, seg)
    got = segmented_scan_tile(T(v), T(seg), tr.reduce).numpy()
    np.testing.assert_array_equal(got, want)
    # a batch of tiles scans each tile on its own
    two = segmented_scan_tile(T(np.stack([v, v])), T(np.stack([seg, seg])),
                              tr.reduce).numpy()
    np.testing.assert_array_equal(two[1], want)


@pytest.mark.parametrize("ring", RINGS)
def test_segmented_scan_lanes_matches_reference(ring):
    rng = np.random.default_rng(2)
    jr, tr = _rings(ring)
    v = rng.integers(-8, 9, (16, 128)).astype(np.float32)
    head = (rng.random((16, 128)) < 0.1).astype(np.int32)
    want = _in_kernel(lambda a, b: jpu.segmented_scan_lanes(a, b, jr.reduce),
                      v, head)
    got = segmented_scan_lanes(T(v), T(head), tr.reduce).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def random_case():
    """The no-reduction branch: random_csr(20000, 30000, 150000, seed=1)
    (tests/test_stream.py:18) and its reference plan."""
    A = random_csr(20000, 30000, 150000, seed=1)
    plan = jstream.build_stream_plan(A, jstream.StreamPolicy())
    assert plan.reduce is None and "xr1" not in plan.gather
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    xp = np.pad(x, (0, plan.x_rows_pad * 128 - A.n_cols))
    x2d = np.ascontiguousarray(
        xp.reshape(-1, 128, 128).transpose(0, 2, 1).reshape(-1, 128))
    return A, plan, x2d


@pytest.mark.parametrize("ring", RINGS)
def test_gather_and_gather_split_plain_match_reference(random_case, ring):
    """K4 and K3 on the same plan, and K3 == K4 + K5 pass 1."""
    _, plan, x2d = random_case
    jr, tr = _rings(ring)
    g = plan.gather
    gt = plan.n_gather_tiles
    want4 = np.asarray(jstream._gather_pass(
        x2d, g["Ax"], g["q"], g["xb"], sr=jr, sbt=8, n_tiles=gt,
        interpret=True))
    targs = (T(x2d), T(g["Ax"]), T(g["q"]), T(g["xb"]))
    prod = tstream._gather_plain(*targs, sr=tr, n_tiles=gt)
    np.testing.assert_array_equal(prod.numpy(), want4)

    p0, d0 = plan.shuffle.passes[0], plan.shuffle_dev[0]
    assert p0.sbt == 8 and p0.n_steps * 8 == gt  # the fused branch
    rows_per_g = p0.out_rows // p0.K
    want3 = np.asarray(jstream._gather_split_pass(
        x2d, g["Ax"], g["q"], g["xb"], d0["s1"], d0["s2"], d0["s3"],
        d0["starts"], d0["pos"], sr=jr, sbt=8, n_tiles=gt, K=p0.K, Q=p0.Q,
        rows_per_g=rows_per_g, interpret=True))
    sarg = [T(d0[k]) for k in ("s1", "s2", "s3", "starts", "pos")]
    gaps = tshuffle.gap_rows(np.asarray(d0["pos"]), 8, p0.Q, rows_per_g)
    got3 = tstream._gather_split_pass(
        *targs, *sarg, sr=tr, sbt=8, n_tiles=gt, K=p0.K, Q=p0.Q,
        rows_per_g=rows_per_g, gaps=T(gaps)).numpy()
    covered = np.ones(rows_per_g, bool)
    covered[gaps] = False
    np.testing.assert_array_equal(got3[:, covered], want3[:, covered])
    assert (got3[:, ~covered] == float(tr.identity_for(np.float32))).all()
    split = tshuffle._split_plain(
        prod, *sarg, n_steps=p0.n_steps, sbt=8, K=p0.K, Q=p0.Q,
        rows_per_g=rows_per_g, fill=float(tr.identity_for(np.float32)))
    np.testing.assert_array_equal(got3, split.numpy())
    want5 = np.asarray(jshuffle._run_split(
        want4, d0["s1"], d0["s2"], d0["s3"], d0["starts"], d0["pos"],
        n_steps=p0.n_steps, sbt=8, K=p0.K, Q=p0.Q, rows_per_g=rows_per_g,
        interpret=True))
    np.testing.assert_array_equal(want3[:, covered], want5[:, covered])


@pytest.fixture(scope="module")
def power_law_case():
    """The reduction branch with the lane remap: power_law_csr(8192,
    8192, 50000, seed=15) (tests/test_stream.py:122) and its plan."""
    A = power_law_csr(8192, 8192, 50000, seed=15)
    plan = jstream.build_stream_plan(A, jstream.StreamPolicy(kappa=12288))
    assert plan.reduce is not None and "xr1" in plan.gather
    x = np.random.default_rng(4).standard_normal(A.n_cols).astype(np.float32)
    g = plan.gather
    xnat = np.pad(x, (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
    x2d = np.asarray(jstream._xprep_pass(
        xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"],
        n_w=plan.x_rows_pad // 128, interpret=True))
    return A, plan, x2d


@pytest.mark.parametrize("ring", ["MIN_PLUS", "MAX_TIMES"])
def test_reduce_roll_plain_matches_reference(power_law_case, ring):
    """K7: the generic body of _reduce_pass."""
    _, plan, x2d = power_law_case
    jr, tr = _rings(ring)
    g, rd = plan.gather, plan.reduce
    gt, Qp = plan.n_gather_tiles, rd["Qp"]
    args = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"],
            rd["rs"])
    want = np.asarray(jstream._reduce_pass(
        *args, sr=jr, sbt=8, n_tiles=gt, Qp=Qp, out_rows=rd["out_rows"],
        interpret=True))
    got = tstream._reduce_pass(*[T(a) for a in args], sr=tr, n_tiles=gt,
                               Qp=Qp, out_rows=rd["out_rows"]).numpy()
    np.testing.assert_array_equal(got[:gt * Qp], want[:gt * Qp])
    assert (got[gt * Qp:] == float(tr.identity_for(np.float32))).all()


SCAN_KEYS = ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1",
             "q2s2", "q2s3", "valid2", "counts")


@pytest.mark.parametrize("ring,kind", [("MIN_PLUS", "normal"),
                                       ("PLUS_TIMES", "normal"),
                                       ("PLUS_TIMES", "int")])
def test_scan_roll_plain_matches_reference(power_law_case, ring, kind):
    """K8: min-plus picks it, plus-times takes it with strategy 'roll'."""
    _, plan, _ = power_law_case
    jr, tr = _rings(ring)
    sc = plan.scan
    F_pad = np.asarray(sc["counts"]).shape[0]
    rng = np.random.default_rng(6)
    prod = (rng.integers(-4, 5, (F_pad * 128, 128)) if kind == "int"
            else rng.standard_normal((F_pad * 128, 128))).astype(np.float32)
    want = np.asarray(jstream._scan_pass(
        prod, *[sc[k] for k in SCAN_KEYS], sr=jr, F_pad=F_pad,
        interpret=True, strategy="roll"))
    got = tstream._scan_pass(T(prod), *[T(sc[k]) for k in SCAN_KEYS], sr=tr,
                             F_pad=F_pad, strategy="roll").numpy()
    _check(got, want, ring, kind)
    # the keys a segment is cut by never fall within a tile
    rel = np.asarray(sc["relid"]).reshape(F_pad, -1).astype(np.int32) & 16383
    assert (np.diff(rel, axis=1) >= 0).all()


def test_scan_pass_picks_the_reference_body(power_law_case):
    """'auto' with plus-times and the counting ring takes K6, every other
    ring or 'roll' takes K8, as spmv_tpu/kernels/stream.py:1610."""
    _, plan, _ = power_law_case
    sc = plan.scan
    F_pad = np.asarray(sc["counts"]).shape[0]
    prod = T(np.random.default_rng(7).integers(
        0, 3, (F_pad * 128, 128)).astype(np.float32))
    args = [T(sc[k]) for k in SCAN_KEYS]
    diff = tstream._scan_diff_plain(prod, *args[1:], F_pad=F_pad)
    for sr in (tsr.PLUS_TIMES, tsr.OR_AND_COUNTING):
        assert torch.equal(tstream._scan_pass(prod, *args, sr=sr, F_pad=F_pad),
                           diff)
    roll = tstream._scan_pass(prod, *args, sr=tsr.PLUS_TIMES, F_pad=F_pad,
                              strategy="roll")
    # integer data: the roll body's float32 segmented sums are exact too,
    # but it fills absent rows with the identity and K6 with 0: both 0
    assert torch.equal(roll, diff)
