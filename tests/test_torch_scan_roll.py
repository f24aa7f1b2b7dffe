"""K8's segmented scan as the card computes it, written here in NumPy,
against the plain version's `segmented_scan_tile`, bit for bit.

K8 (csrc/roll_kernels.cu:scan_roll_kernel) scans one final tile of
16384 positions with 512 threads of 32 consecutive positions each: every
thread scans its positions in order, a warp scans its 32 threads'
(value, flag) aggregates by shuffles, warp 0 scans the 16 warps'
aggregates, and each thread folds its exclusive prefix into its values
before its first segment start. A segment starts where the key
(relid & 16383) differs from the previous position's; junk positions
(relid >= 16384) hold the ring's identity. The model below takes the
same steps, so the chunking the card runs is checked here on the CPU,
on keys whose segments start on and beside the thread and warp
boundaries. Min-plus and max-times are exact in any order, plus-times
on integer-valued data too. The whole kernel (its two routes, the junk
and valid2 masks) is held against `_scan_roll_plain` on a built plan.
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.kernels.tile_ops import segmented_scan_tile
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, PLUS_TIMES

TILE, THREADS, PER, LANES = 16384, 512, 32, 32
WARPS = THREADS // LANES
RINGS = {"min_plus": (MIN_PLUS, np.minimum), "max_times": (MAX_TIMES, np.maximum),
         "plus_times": (PLUS_TIMES, np.add)}


def _seg_combine(ev, ef, lv, lf, reduce):
    """ring.cuh's seg_combine: (earlier) then (later)."""
    return np.where(lf, lv, reduce(ev, lv)), lf | ef


def _warp_scan(v, f, reduce):
    """warp_seg_scan over the last axis (32 lanes): shfl_up by 1, 2, 4,
    8, 16, every lane reading the values before the step."""
    d = 1
    while d < LANES:
        nv, nf = _seg_combine(v[..., :-d], f[..., :-d], v[..., d:], f[..., d:], reduce)
        v = np.concatenate([v[..., :d], nv], -1)
        f = np.concatenate([f[..., :d], nf], -1)
        d *= 2
    return v, f


@np.errstate(invalid="ignore")  # inf + -inf in plus-times segments
def k8_scan(v, key, reduce, ident):
    """The inclusive segmented scan of one tile's 16384 values v keyed by
    key, in K8's chunks."""
    vt = v.reshape(THREADS, PER)
    head = (key != np.concatenate([[-1], key[:-1]])).reshape(THREADS, PER)
    loc = np.empty_like(vt)
    acc = vt[:, 0]
    for e in range(PER):  # each thread's own positions, in order
        acc = vt[:, 0] if e == 0 else np.where(head[:, e], vt[:, e], reduce(acc, vt[:, e]))
        loc[:, e] = acc
    any_head = head.any(1)
    first_head = np.where(any_head, head.argmax(1), PER)
    sv, sf = _warp_scan(acc.reshape(WARPS, LANES), any_head.reshape(WARPS, LANES), reduce)
    # warp 0 scans the warps' aggregates, lanes past the last warp idle
    wv = np.concatenate([sv[:, -1], np.full(LANES - WARPS, ident, np.float32)])
    wf = np.concatenate([sf[:, -1], np.zeros(LANES - WARPS, bool)])
    wv, wf = _warp_scan(wv, wf, reduce)
    # each thread's exclusive prefix: its warp's lanes before it, joined
    # to the warps before while no segment start lies between
    ev = np.concatenate([sv[:, :1], sv[:, :-1]], 1)
    ef = np.concatenate([sf[:, :1], sf[:, :-1]], 1)
    warp = np.arange(WARPS)[:, None]
    lane = np.arange(LANES)[None, :]
    before = np.concatenate([[ident], wv[:WARPS - 1]]).astype(np.float32)[:, None]
    prefix = np.where(lane > 0, np.where(ef | (warp == 0), ev, reduce(before, ev)), before)
    has_prefix = (lane > 0) | (warp > 0)
    fold = has_prefix.reshape(THREADS, 1) & (np.arange(PER)[None, :] < first_head[:, None])
    loc = np.where(fold, reduce(prefix.reshape(THREADS, 1), loc), loc)
    return loc.reshape(-1)


def _relid(name, seed=0):
    """One tile's relid of pattern `name`: keys that never decrease, junk
    flagged by +16384."""
    rng = np.random.default_rng(seed)
    p = np.arange(TILE)
    junk = np.zeros(TILE, bool)
    if name == "one_segment":
        key = np.full(TILE, 5)
        junk[0] = True
        junk[16000:] = True
    elif name == "every_position":
        key = p
    elif name == "all_junk":
        key = np.full(TILE, 7)
        junk[:] = True
    elif name == "runs":  # as a plan has them: runs of 1-40, junk at 0 and the tail
        ends = np.cumsum(rng.integers(1, 40, TILE))
        starts = np.zeros(TILE, bool)
        starts[ends[ends < TILE]] = True
        key = np.cumsum(starts)
        junk[0] = True
        junk[15000:] = True
    else:  # segment starts at every thread or warp boundary, or one beside it
        where, shift = name.rsplit("_", 1)
        width = {"threads": PER, "warps": PER * LANES}[where]
        key = np.cumsum((p - int(shift)) % width == 0)
    return (key + TILE * junk).astype(np.int16)


PATTERNS = ["one_segment", "every_position", "all_junk", "runs", "threads_0",
            "threads_-1", "threads_1", "warps_0", "warps_-1", "warps_1"]


def _values(ring, n, seed):
    """Normal values (integer-valued for plus-times) with ±inf."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-4, 5, n) if ring == "plus_times"
         else rng.standard_normal(n)).astype(np.float32)
    u = rng.random(n)
    v[u < 0.03] = np.inf
    v[(u >= 0.03) & (u < 0.06)] = -np.inf
    return v


def _assert_same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("name", PATTERNS)
def test_k8_scan_chunks_match_the_plain_scan(name, ring):
    sr, reduce = RINGS[ring]
    ident = np.float32(sr.identity_for(np.float32))
    relid = _relid(name).astype(np.int32)
    key = relid & (TILE - 1)
    assert (np.diff(key) >= 0).all()
    v = np.where(relid < TILE, _values(ring, TILE, seed=len(name)), ident).astype(np.float32)
    got = k8_scan(v, key, reduce, ident)
    want = segmented_scan_tile(torch.from_numpy(v).view(1, 128, 128),
                               torch.from_numpy(key).view(1, 128, 128), sr.reduce)
    _assert_same_bits(got, want.reshape(-1).numpy())
    if name.startswith(("threads", "warps")):
        assert len(np.unique(key)) > 10


def _route(s1, s2, s3):
    """The flat in-tile source of each output slot (csrc/route3.cuh's
    route_src_staged): r1 = s2[k, r], source r1 * 128 + s1[r1, k] with
    k = s3[r, c]."""
    k = s3.astype(np.int64)
    r = np.arange(128)[:, None]
    r1 = s2.astype(np.int64)[k, r]
    return r1 * 128 + s1.astype(np.int64)[r1, k]


@pytest.fixture(scope="module")
def roll_plan():
    A = power_law_csr(16384, 16384, 60000, seed=12)
    return tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=8192)).scan


@pytest.mark.parametrize("ring", list(RINGS))
def test_k8_model_matches_the_plain_version(roll_plan, ring):
    """The exact-rank route, the junk mask, the chunked scan, the END
    route and valid2, tile by tile, as K8 runs them."""
    sc = roll_plan
    sr, reduce = RINGS[ring]
    ident = np.float32(sr.identity_for(np.float32))
    F = sc["counts"].shape[0]
    prod = _values(ring, F * TILE, seed=1).reshape(F * 128, 128)
    keys = ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "valid2")
    tile = {k: np.asarray(sc[k]).reshape(F, 128, 128) for k in keys}
    got = np.empty((F, TILE), np.float32)
    for f in range(F):
        t = {k: a[f] for k, a in tile.items()}
        relid = t["relid"].reshape(-1).astype(np.int32)
        src = _route(t["pm1"], t["pm2"], t["pm3"]).reshape(-1)
        v = np.where(relid < TILE, prod.reshape(F, TILE)[f][src], ident).astype(np.float32)
        P = k8_scan(v, relid & (TILE - 1), reduce, ident)
        end = _route(t["r2s1"], t["r2s2"], t["r2s3"]).reshape(-1)
        got[f] = np.where(t["valid2"].reshape(-1) > 0, P[end], ident)
    want = tstream._scan_roll_plain(
        torch.from_numpy(prod), *[torch.from_numpy(np.asarray(sc[k])) for k in keys],
        sr=sr, F_pad=F)
    _assert_same_bits(got.reshape(-1), want.reshape(-1).numpy())
