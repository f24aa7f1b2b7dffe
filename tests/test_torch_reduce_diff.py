"""K2 and K6 as the card computes them, written here in NumPy, against
their plain versions `_reduce_diff_plain` and `_scan_diff_plain`.

K2 (csrc/stream_kernels.cu:reduce_kernel, on split_tile.cuh's body)
forms a gather tile's products a warp per 128-lane row, each lane taking
4 consecutive lanes, and scans the row in registers: the lane's 4 values
in order, a warp inclusive scan of the 32 lane totals (shfl_up by 1, 2,
4, 8, 16), then the lane's exclusive prefix added to each of its values.
It then routes the prefixes C by (c1, c2, c3 & 127) and writes, for each
slot of the first Qp rows, C less its flat predecessor: the lane's
previous column, lane - 1's fourth by a shuffle, for lane 0 of row r >= 1
row r - 1's column 127 routed anew from its c3 byte, and 0 at flat index
0; a slot whose c3 byte has bit 7 set keeps its C.

K6 (csrc/stream_kernels.cu:scan_diff_kernel) scans a final tile's 16384
values in float64 with 1024 threads of 16 consecutive positions: each
thread in order, warp shuffles over the thread totals, warp 0 over the
32 warp totals, then each thread adds its exclusive prefix.

The models below take the same steps, so the chunking and the
predecessor rule the card runs are checked here on the CPU: bit for bit
on integer-valued data (every sum exact), within rtol 2e-4 / atol 1e-5
on normal data, on a built plan and on made patterns.
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.ops.semiring import OR_AND_COUNTING, PLUS_TIMES

RTOL, ATOL = 2e-4, 1e-5
LANES, TILE = 128, 16384
RINGS = {"plus_times": PLUS_TIMES, "or_and_counting": OR_AND_COUNTING}


def _route(s1, s2, k, r):
    """csrc/route3.cuh's route_src_staged: the flat in-tile slot that
    route byte k delivers to a position of row r."""
    k = np.asarray(k, np.int64)
    r1 = s2.astype(np.int64)[k, r]
    return r1 * LANES + s1.astype(np.int64)[r1, k]


def _warp_scan(t, op):
    """Inclusive Hillis-Steele scan over the last axis (32 lanes): shfl_up
    by 1, 2, 4, 8, 16, every lane reading the values before the step."""
    d = 1
    while d < 32:
        t = np.concatenate([t[..., :d], op(t[..., :-d], t[..., d:])], -1)
        d *= 2
    return t


def k2_row_scan(prod):
    """The inclusive prefix of each 128-lane row of prod (..., 128),
    float32, in K2's order."""
    v = prod.reshape(*prod.shape[:-1], 32, 4).astype(np.float32)
    s = v.copy()
    for e in range(1, 4):  # the lane's 4 values in order
        s[..., e] = s[..., e - 1] + v[..., e]
    t = _warp_scan(s[..., 3], np.add)
    ex = np.concatenate([np.zeros_like(t[..., :1]), t[..., :-1]], -1)
    lane = np.arange(32)
    s = np.where((lane > 0)[:, None], ex[..., None] + s, s)
    return s.reshape(prod.shape)


@np.errstate(invalid="ignore")  # inf - inf in rows with both infinities
def k2_tile(ax, q, xw, c1, c2, c3, Qp, ring):
    """One gather tile through K2: (Qp, 128) parts."""
    qi = q.astype(np.int64)
    xv = xw[np.arange(LANES)[:, None], np.clip(qi, 0, None)]
    prod = (((ax != 0) & (xv != 0)).astype(np.float32) if ring == "or_and_counting"
            else ax * xv)
    C = k2_row_scan(np.where(qi >= 0, prod, np.float32(0)))
    Cf = C.reshape(-1)
    k = c3.astype(np.int64)
    r = np.arange(Qp)[:, None]
    col = Cf[_route(c1, c2, k[:Qp] & 127, r)].reshape(Qp, 32, 4)  # (row, lane, e)
    pred = np.empty_like(col)
    pred[..., 1:] = col[..., :3]           # the lane's previous column
    pred[:, 1:, 0] = col[:, :-1, 3]        # lane - 1's fourth, by a shuffle
    prev_k = k[np.arange(Qp) - 1, 127] & 127  # lane 0: row r - 1's last byte
    pred[:, 0, 0] = np.where(np.arange(Qp) > 0,
                             Cf[_route(c1, c2, prev_k, np.arange(Qp) - 1)], 0)
    first = (k[:Qp] >> 7).reshape(Qp, 32, 4) > 0
    return np.where(first, col, col - pred).reshape(Qp, LANES)


def k2_model(x2d, ax, q, xb, c1, c2, c3, n_tiles, Qp, out_rows, ring):
    out = np.zeros((out_rows, LANES), np.float32)
    tiles = lambda a: a.reshape(n_tiles, LANES, LANES)
    xw = x2d.reshape(-1, LANES, LANES)
    for t in range(n_tiles):
        out[t * Qp:(t + 1) * Qp] = k2_tile(tiles(ax)[t], tiles(q)[t], xw[xb[t]],
                                           tiles(c1)[t], tiles(c2)[t], tiles(c3)[t],
                                           Qp, ring)
    return out


def k6_scan(v):
    """The inclusive float64 prefix of one tile's 16384 values, in K6's
    chunks."""
    vt = v.reshape(32, 32, 16).astype(np.float64)  # (warp, lane, position)
    loc = np.empty_like(vt)
    acc = np.zeros(vt.shape[:2])
    for e in range(16):  # each thread's positions, in order
        acc = acc + vt[..., e]
        loc[..., e] = acc
    incl = _warp_scan(acc, np.add)
    W = _warp_scan(incl[:, 31], np.add)  # warp 0 over the warp totals
    ex = np.concatenate([np.zeros((32, 1)), incl[:, :-1]], 1)
    off = ex + np.concatenate([[0.0], W[:-1]])[:, None]
    return (loc + off[..., None]).reshape(-1)


def k6_model(prod, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2, q2s3, valid2,
             counts, F):
    out = np.zeros((F * LANES, LANES), np.float32)
    p = np.arange(TILE)
    rows = np.arange(LANES)[:, None]
    for f in range(F):
        t = lambda a: a.reshape(F, LANES, LANES)[f]
        src = _route(t(pm1), t(pm2), t(pm3), rows).reshape(-1)
        v = np.where((p >= 1) & (p <= counts[f]), t(prod).reshape(-1)[src], 0.0)
        P = k6_scan(v)
        end = _route(t(r2s1), t(r2s2), t(r2s3), rows)
        prev = _route(t(q2s1), t(q2s2), t(q2s3), rows)
        out[f * LANES:(f + 1) * LANES] = np.where(
            t(valid2) > 0, (P[end] - P[prev]).astype(np.float32), 0)
    return out


def _same(got, want, exact):
    """NaN where the plain version has NaN; elsewhere equal values, or
    within rtol 2e-4 / atol 1e-5."""
    want = np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    if exact:
        np.testing.assert_array_equal(got[~nan], want[~nan])
    else:
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=RTOL, atol=ATOL)


# --- the row scan and the float64 chunked scan alone

@pytest.mark.parametrize("data", ["int", "normal"])
def test_k2_row_scan_matches_a_cumsum(data):
    rng = np.random.default_rng(3)
    v = (rng.integers(-4, 5, (64, LANES)) if data == "int"
         else rng.standard_normal((64, LANES))).astype(np.float32)
    want = torch.from_numpy(v).cumsum(1).numpy()
    _same(k2_row_scan(v), want, exact=data == "int")


@pytest.mark.parametrize("data", ["int", "normal"])
def test_k6_chunked_scan_matches_a_float64_cumsum(data):
    rng = np.random.default_rng(4)
    v = (rng.integers(-4, 5, TILE) if data == "int"
         else rng.standard_normal(TILE)).astype(np.float32)
    want = torch.from_numpy(v).cumsum(0, dtype=torch.float64).numpy()
    got = k6_scan(v)
    if data == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# --- the whole of K2 and K6 on a built plan

@pytest.fixture(scope="module")
def plan():
    """A small power-law matrix on the reduction branch (K2 -> K5 -> K6)
    and its plan on the CPU."""
    A = power_law_csr(16384, 16384, 90000, seed=11)
    p = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    assert p.reduce is not None
    return A, p, p.to("cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("data", ["int", "normal"])
def test_k2_model_matches_the_plain_version_on_a_plan(plan, ring, data):
    A, p, dp = plan
    rng = np.random.default_rng(5)
    g, rd = dp.gather, dp.reduce
    ints = data == "int"
    x = (rng.integers(-4, 5, A.n_cols) if ints else rng.standard_normal(A.n_cols))
    ax = (torch.from_numpy(rng.integers(-4, 5, tuple(g["Ax"].shape)).astype(np.float32))
          if ints else g["Ax"])
    x2d = tstream._x_table(dp, torch.from_numpy(x.astype(np.float32)), A.n_cols)
    args = (x2d, ax, g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"])
    kw = dict(n_tiles=p.n_gather_tiles, Qp=rd["Qp"], out_rows=rd["out_rows"])
    want = tstream._reduce_diff_plain(*args, sr=RINGS[ring], **kw)
    got = k2_model(*[_np(a) for a in args], ring=ring, **kw)
    _same(got, want, exact=ints or ring == "or_and_counting")
    assert (got != 0).any()


@pytest.mark.parametrize("data", ["int", "normal"])
def test_k6_model_matches_the_plain_version_on_a_plan(plan, data):
    _, p, dp = plan
    sc = dp.scan
    F = int(sc["counts"].shape[0])
    rng = np.random.default_rng(6)
    prod = (rng.integers(-4, 5, (F * LANES, LANES)) if data == "int"
            else rng.standard_normal((F * LANES, LANES))).astype(np.float32)
    keys = ("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1", "q2s2", "q2s3",
            "valid2", "counts")
    args = (torch.from_numpy(prod), *[sc[k] for k in keys])
    want = tstream._scan_diff_plain(*args, F_pad=F)
    got = k6_model(*[_np(a) for a in args], F=F)
    _same(got, want, exact=data == "int")
    assert (got != 0).any()


# --- made patterns: the predecessor rule, junk tiles, counts and valid2

def _k2_made(n_tiles, Qp, flags, seed):
    rng = np.random.default_rng(seed)
    rows = n_tiles * LANES
    x2d = rng.integers(-4, 5, (3 * LANES, LANES)).astype(np.float32)
    u = rng.random(x2d.shape)
    x2d[u < 0.002] = np.inf
    x2d[(u >= 0.002) & (u < 0.004)] = np.nan
    ax = rng.integers(-4, 5, (rows, LANES)).astype(np.float32)
    q = rng.integers(0, LANES, (rows, LANES)).astype(np.int8)
    q[rng.random(q.shape) < 0.2] = -1
    q[:LANES] = -1  # tile 0: all junk
    xb = rng.integers(0, 3, n_tiles).astype(np.int32)
    c1, c2, c3 = (rng.integers(0, LANES, (rows, LANES)).astype(np.uint8) for _ in range(3))
    if flags == "lane0":
        c3[:, 0] |= 128
    elif flags == "random":
        c3[rng.random(c3.shape) < 0.3] |= 128
    return x2d, ax, q, xb, c1, c2, c3


@pytest.mark.parametrize("Qp", [1, 17, 64])
@pytest.mark.parametrize("flags", ["lane0", "none", "random"])
def test_k2_predecessor_rule_on_made_tiles(Qp, flags):
    """Bit 7 at column 0 of every row, nowhere or at random; a junk
    tile; ±inf and NaN in x."""
    n_tiles = 3
    arrays = _k2_made(n_tiles, Qp, flags, seed=Qp)
    kw = dict(n_tiles=n_tiles, Qp=Qp, out_rows=n_tiles * Qp + 5)
    for ring in RINGS:
        want = tstream._reduce_diff_plain(*[torch.from_numpy(a) for a in arrays],
                                          sr=RINGS[ring], **kw)
        got = k2_model(*arrays, ring=ring, **kw)
        _same(got, want, exact=True)
        assert (got[:Qp] == 0).all()  # the junk tile
        assert (got[n_tiles * Qp:] == 0).all()


@pytest.mark.parametrize("valid", ["all0", "all1", "random"])
@pytest.mark.parametrize("data", ["int", "normal"])
def test_k6_model_on_made_tiles(valid, data):
    """counts 0, 1, 127, 128 and 16383, one a tile; valid2 all 0, all 1
    or at random; random route bytes."""
    counts = np.array([0, 1, 127, 128, 16383], np.int32)
    F = counts.size
    rng = np.random.default_rng(7)
    rows = F * LANES
    prod = (rng.integers(-4, 5, (rows, LANES)) if data == "int"
            else rng.standard_normal((rows, LANES))).astype(np.float32)
    routes = [rng.integers(0, LANES, (rows, LANES)).astype(np.uint8) for _ in range(9)]
    valid2 = {"all0": np.zeros((rows, LANES)), "all1": np.ones((rows, LANES)),
              "random": rng.random((rows, LANES)) < 0.6}[valid].astype(np.int8)
    arrays = (prod, *routes, valid2, counts)
    want = tstream._scan_diff_plain(*[torch.from_numpy(a) for a in arrays], F_pad=F)
    got = k6_model(*arrays, F=F)
    _same(got, want, exact=data == "int")
    assert (got[valid2 == 0] == 0).all()
    assert (got[:LANES] == 0).all()  # counts 0: every value dropped
