"""K7 as the card computes it, written here in NumPy, against its plain
version `_reduce_roll_plain`.

K7 (csrc/roll_kernels.cu:reduce_roll_kernel, on split_tile.cuh's body)
forms a gather tile's products a warp per 128-lane row, each lane taking
4 consecutive lanes with their run-start flags, and scans the row in
registers: the lane's 4 values in order, restarting at a flagged slot;
a warp scan of the 32 lanes' last partials (shfl_up by 1, 2, 4, 8, 16),
segmented by one ballot of the lanes in which a run starts: lane l takes
lane l - d's value while l - d >= s, s the last such lane <= l; then
lane - 1's inclusive value folded into the lane's slots before its
first flagged one. It then routes the scan by (c1, c2, c3 & 127) from
the staged stages and writes the first Qp routed rows of each tile.

The model below takes the same steps with the kernel's min and max
(ring.cuh: NaN propagates, a tie keeps the later operand), so the
chunking the card runs is checked here on the CPU against the plain
version's seven-step lane scan. Every ring K7 takes is exact, so they
must agree value for value, NaN where the plain version has NaN, on a
built plan and on made tiles whose run starts flag every lane, only
lane 0 or lanes at random, with ±inf and NaN in Ax and x.
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.kernels.tile_ops import segmented_scan_lanes
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND

LANES = 128
RINGS = {"min_plus": MIN_PLUS, "max_times": MAX_TIMES, "or_and": OR_AND}


def _min(a, b):
    """ring.cuh's spmv_min: a if a is NaN or a < b, else b."""
    return np.where(np.isnan(a) | (a < b), a, b)


def _max(a, b):
    return np.where(np.isnan(a) | (a > b), a, b)


# ring -> (identity, combine(a, x), reduce(earlier, later)) as ring.cuh has them
DEVICE = {
    "min_plus": (np.float32(np.inf), lambda a, x: a + x, _min),
    "max_times": (np.float32(0), lambda a, x: a * x, _max),
    "or_and": (np.float32(0), lambda a, x: ((a != 0) & (x != 0)).astype(np.float32),
               _max),
}


def _route(s1, s2, k, r):
    """csrc/route3.cuh's route_src_staged: the flat in-tile slot that
    route byte k delivers to a position of row r."""
    k = np.asarray(k, np.int64)
    r1 = s2.astype(np.int64)[k, r]
    return r1 * LANES + s1.astype(np.int64)[r1, k]


def k7_row_scan(v, flags, red):
    """The inclusive segmented scan of each 128-lane row of v (..., 128),
    restarting where flags is set, in K7's order."""
    v = v.reshape(*v.shape[:-1], 32, 4).astype(np.float32)
    f = flags.reshape(v.shape) != 0
    s = v.copy()
    for e in range(1, 4):  # the lane's 4 values in order, with restarts
        s[..., e] = np.where(f[..., e], s[..., e], red(s[..., e - 1], s[..., e]))
    sv, lane = s[..., 3].copy(), np.arange(32)
    start = np.where(f.any(-1), lane, -1)  # the ballot: a run starts in the lane
    last = np.maximum(np.maximum.accumulate(start, -1), 0)  # s of each lane
    d = 1
    while d < 32:  # every lane reads the values before the step
        n = np.concatenate([sv[..., :d], sv[..., :-d]], -1)  # lane - d's
        sv = np.where(lane - d >= last, red(n, sv), sv)
        d *= 2
    pv = np.concatenate([sv[..., :1], sv[..., :-1]], -1)[..., None]  # lane - 1's
    before_start = np.cumprod(~f, -1).astype(bool)  # slots before the first start
    fold = before_start & (np.arange(32) > 0)[:, None]
    return np.where(fold, red(pv, s), s).reshape(*v.shape[:-2], LANES)


@np.errstate(invalid="ignore", over="ignore")  # inf - inf and inf * 0 make NaN
def k7_model(x2d, ax, q, xb, c1, c2, c3, rs, n_tiles, Qp, out_rows, ring):
    ident, combine, red = DEVICE[ring]
    out = np.full((out_rows, LANES), ident, np.float32)
    tiles = lambda a: a.reshape(n_tiles, LANES, LANES)
    xw = x2d.reshape(-1, LANES, LANES)[xb]  # each tile's x window
    qi = tiles(q).astype(np.int64)
    xv = np.take_along_axis(xw, np.clip(qi, 0, None), 2)
    prod = np.where(qi >= 0, combine(tiles(ax), xv), ident).astype(np.float32)
    scan = k7_row_scan(prod, tiles(rs), red).reshape(n_tiles, -1)
    r = np.arange(Qp)[:, None]
    for t in range(n_tiles):
        k = tiles(c3)[t, :Qp].astype(np.int64) & 127
        out[t * Qp:(t + 1) * Qp] = scan[t][_route(tiles(c1)[t], tiles(c2)[t], k, r)]
    return out


def _same(got, want):
    """NaN where the plain version has NaN; elsewhere equal values (the
    rings are exact; -0 and +0 compare equal, as torch.equal has them)."""
    want = np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


# --- the segmented row scan alone

@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("flags", ["every", "lane0", "random", "none"])
def test_k7_row_scan_matches_the_plain_lane_scan(ring, flags):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((64, LANES)).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    v[rng.random(v.shape) < 0.02] = np.inf
    f = {"every": np.ones(v.shape), "lane0": np.eye(1, LANES).repeat(64, 0),
         "random": rng.random(v.shape) < 0.2, "none": np.zeros(v.shape)}[flags]
    f = f.astype(np.int8)
    want = segmented_scan_lanes(torch.from_numpy(v), torch.from_numpy(f),
                                RINGS[ring].reduce).numpy()
    _same(k7_row_scan(v, f, DEVICE[ring][2]), want)


# --- the whole of K7 on a built plan

@pytest.fixture(scope="module")
def plan():
    """A small power-law matrix on the reduction branch (K1 -> K7 -> K5
    -> K8 in the min, max and or rings) and its plan on the CPU."""
    A = power_law_csr(16384, 16384, 90000, seed=11)
    p = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    assert p.reduce is not None
    return A, p, p.to("cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("ring", list(RINGS))
def test_k7_model_matches_the_plain_version_on_a_plan(plan, ring):
    A, p, dp = plan
    rng = np.random.default_rng(5)
    g, rd = dp.gather, dp.reduce
    x = rng.standard_normal(A.n_cols).astype(np.float32)
    if ring == "or_and":
        x[rng.random(A.n_cols) < 0.7] = 0.0
    x2d = tstream._x_table(dp, torch.from_numpy(x), A.n_cols)
    args = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
    kw = dict(n_tiles=p.n_gather_tiles, Qp=rd["Qp"], out_rows=rd["out_rows"])
    want = tstream._reduce_roll_plain(*args, sr=RINGS[ring], **kw)
    got = k7_model(*[_np(a) for a in args], ring=ring, **kw)
    _same(got, want)
    assert (got[:p.n_gather_tiles * rd["Qp"]] != DEVICE[ring][0]).any()


# --- made tiles: run starts at every lane, only lane 0 or at random; a
# junk tile; ±inf and NaN in Ax and x

def _k7_made(n_tiles, Qp, flags, seed):
    rng = np.random.default_rng(seed)
    rows = n_tiles * LANES

    def special(a):
        u = rng.random(a.shape)
        a[u < 0.15] = 0.0
        a[(u >= 0.15) & (u < 0.16)] = np.inf
        a[(u >= 0.16) & (u < 0.17)] = -np.inf
        a[(u >= 0.17) & (u < 0.18)] = np.nan
        return a

    x2d = special(rng.standard_normal((3 * LANES, LANES)).astype(np.float32))
    ax = special(rng.standard_normal((rows, LANES)).astype(np.float32))
    q = rng.integers(0, LANES, (rows, LANES)).astype(np.int8)
    q[rng.random(q.shape) < 0.2] = -1
    q[:LANES] = -1  # tile 0: all junk
    xb = rng.integers(0, 3, n_tiles).astype(np.int32)
    c1, c2, c3 = (rng.integers(0, LANES, (rows, LANES)).astype(np.uint8) for _ in range(3))
    c3[rng.random(c3.shape) < 0.3] |= 128  # K2's flag bit, which K7 masks off
    rs = {"every": np.ones((rows, LANES)),
          "lane0": np.tile(np.eye(1, LANES), (rows, 1)),
          "random": rng.random((rows, LANES)) < 0.25}[flags].astype(np.int8)
    return x2d, ax, q, xb, c1, c2, c3, rs


@pytest.mark.parametrize("Qp", [1, 17, 64, 128])
@pytest.mark.parametrize("flags", ["every", "lane0", "random"])
@pytest.mark.parametrize("ring", list(RINGS))
def test_k7_model_on_made_tiles(Qp, flags, ring):
    n_tiles = 3
    arrays = _k7_made(n_tiles, Qp, flags, seed=Qp + len(flags))
    kw = dict(n_tiles=n_tiles, Qp=Qp, out_rows=n_tiles * Qp + 5)
    want = tstream._reduce_roll_plain(*[torch.from_numpy(a) for a in arrays],
                                      sr=RINGS[ring], **kw)
    got = k7_model(*arrays, ring=ring, **kw)
    _same(got, want)
    ident = DEVICE[ring][0]
    assert (got[:Qp] == ident).all()  # the junk tile
    assert (got[n_tiles * Qp:] == ident).all()
    assert np.isfinite(got).any()
