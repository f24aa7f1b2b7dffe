"""Planned-permutation (shuffle) engine: route the elements of a flat
device array into a plan-chosen order.

Counterpart of `spmv_tpu/kernels/shuffle.py`. A known bijection (with
don't-care padding) is decomposed at plan time into **split passes**.
In each pass, every input (128,128) tile is permuted in-tile (3-stage
routing, ops/routing.py) into destination-group-sorted order, and each
of K groups' Q-row quota window per tile is copied to that group's
region of the output. Two or three passes reach the planner's sizes;
the consumer applies one final in-tile permutation for exact order.

Quota windows copy Q*128 contiguous elements starting at a chosen row,
so they carry *edge junk* (neighbouring groups' elements); the plan
simulates every pass exactly and treats those slots as junk downstream.
Only the final consumer masks junk (it knows the live slots).

The planner below is the reference's, copied: for the same input it
emits the same arrays, bit for bit (tests/test_torch_plan.py). The
device half is K5 (`_run_split`), a CUDA kernel beside its plain
PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.tile_ops import route3_batched
from spmv_tpu_torch.ops.routing import route_tiles

LANES = 128
TILE = LANES * LANES


@dataclasses.dataclass
class SplitPass:
    n_steps: int
    sbt: int  # input tiles per step
    K: int    # destination groups = output arrays
    Q: int    # quota rows per (tile, group)
    in_rows: int
    out_rows: int  # stitched output rows (concat of the K arrays)
    stitch: object  # always "concat": regions interleave round-robin
    s1: np.ndarray  # (n_steps*sbt*128, 128) u8 routing stages
    s2: np.ndarray
    s3: np.ndarray
    starts: np.ndarray  # (n_steps, sbt, K) i32 window start row
    pos: np.ndarray = None  # (n_steps,) i32 out block index per step


@dataclasses.dataclass
class ShufflePlan:
    passes: list
    in_rows: int
    out_rows: int
    # Ground truth from simulation: slot_of_dst[d] = final flat slot
    # holding the element whose requested destination was d (-1 if the
    # destination was never requested).
    slot_of_dst: np.ndarray


def _plan_split(cur: np.ndarray, grp: np.ndarray, n_groups: int,
                sbt: int, Q: int, stitch, out_flat_base,
                out_rows: Optional[int] = None,
                sort_payload: bool = True,
                level: int = 0, gmode: int = 0, radix: int = 1):
    """Plan one split pass and simulate its stitched output layout.

    cur: (slots,) int64 payload per input slot, -1 junk.
    grp: (slots,) destination group per slot (ignored where junk).
    out_flat_base(step, g, j) -> flat output element index of the start
    of the (step, group, tile-j) quota window in CONSUMER order. The
    per-group output arrays are laid out so that
    out_flat_base(step, g, j) == g*(out_rows/n_groups)*128 + local,
    with `local` identical across g (regions interleave round-robin).
    out_rows: total stitched output rows (may exceed the quota blocks'
    footprint — gap rows stay junk).
    """
    slots = cur.shape[0]
    assert slots % (sbt * TILE) == 0, "input must align to superblocks"
    n_tiles = slots // TILE
    n_steps = n_tiles // sbt
    blk_rows = sbt * Q
    if out_rows is None:
        out_rows = n_steps * n_groups * blk_rows
    assert out_rows % n_groups == 0

    starts = np.zeros((n_steps, sbt, n_groups), dtype=np.int32)
    if not callable(out_flat_base):
        B0 = out_flat_base  # (n_steps, n_groups, sbt) int64 base array
    else:
        B0 = np.empty((n_steps, n_groups, sbt), dtype=np.int64)
        for s_ in range(n_steps):
            for g_ in range(n_groups):
                for j_ in range(sbt):
                    B0[s_, g_, j_] = out_flat_base(s_, g_, j_)

    # Native fast path: per-tile counting sort in C (the whole
    # simulation is the planner's hot loop at 1e8 slots).
    try:
        from spmv_tpu_torch import native

        if native.available():
            grp_c = (np.ascontiguousarray(grp, np.int32)
                     if gmode == 0 else None)
            src_n, starts_n, new_cur_n = native.plan_split(
                cur, grp_c, n_groups,
                sbt, Q, B0, out_rows, sort_payload, level=level,
                gmode=gmode, radix=radix)
            rows_per_g = out_rows // n_groups
            base0s = B0[:, 0, 0]
            if (base0s % (blk_rows * LANES)).any():
                raise ValueError(
                    "region start not aligned to quota blocks")
            if (base0s + blk_rows * LANES > rows_per_g * LANES).any():
                raise ValueError("quota block exceeds the group region")
            pos_n = (base0s // (blk_rows * LANES)).astype(np.int32)
            p = SplitPass(
                n_steps=n_steps, sbt=sbt, K=n_groups, Q=Q,
                in_rows=slots // LANES, out_rows=out_rows,
                stitch=stitch, s1=src_n, s2=None, s3=None,
                starts=starts_n, pos=pos_n)
            return p, new_cur_n
    except NotImplementedError:
        pass

    # Per-tile processing: each tile's 16K-element sort + group walk
    # stays L2-resident, which measures ~2x faster end-to-end than a
    # fully vectorized global argsort over 1e8+ slots (profiled at
    # 100M nnz, round 2).
    if grp is None:  # derived-digit modes (native computes these in C)
        base = cur // TILE
        grp = (base // radix) % n_groups if gmode == 1 \
            else base // radix
        grp = np.where(cur >= 0, grp, 0)
    g_eff = np.where(cur >= 0, grp, n_groups)  # junk sorts last
    new_cur = np.full(out_rows * LANES, -1, dtype=np.int64)
    src = np.full((n_tiles, LANES, LANES), -1, dtype=np.int32)
    cur_t = cur.reshape(n_tiles, TILE)
    g_t = g_eff.reshape(n_tiles, TILE)
    pay_bits = max(int(cur.max(initial=0)) + 2, 2).bit_length()
    fuse_keys = n_groups < (1 << 14) and pay_bits < 48

    for t in range(n_tiles):
        if fuse_keys:
            # composite key + radix (kind='stable' on ints) beats
            # two-key lexsort per tile
            key = (g_t[t].astype(np.int64) << pay_bits) | (cur_t[t] + 1)
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((cur_t[t], g_t[t]))
        gs = g_t[t][order]
        n_live = int(np.searchsorted(gs, n_groups))
        src[t].reshape(-1)[:n_live] = order[:n_live]
        bounds = np.searchsorted(gs[:n_live], np.arange(n_groups + 1))
        step, j = divmod(t, sbt)
        for g in range(n_groups):
            b, e = int(bounds[g]), int(bounds[g + 1])
            c = e - b
            st = min(b // LANES, LANES - Q)
            if c and (b + c) > (st + Q) * LANES:
                raise ValueError(
                    f"split quota overflow: tile {t} group {g} count {c} "
                    f"exceeds a {Q}-row window at start {st}")
            starts[step, j, g] = st
            if c:
                base = int(B0[step, g, j])
                woff = b - st * LANES
                new_cur[base + woff:base + woff + c] = cur_t[t][order[b:e]]

    # per-step output block position within each group's array, in
    # blk_rows units (identical across groups by the layout contract)
    rows_per_g = out_rows // n_groups
    base0s = B0[:, 0, 0]
    if (base0s % (blk_rows * LANES)).any():
        raise ValueError("region start not aligned to quota blocks")
    if (base0s + blk_rows * LANES > rows_per_g * LANES).any():
        raise ValueError("quota block exceeds the group region")
    pos = (base0s // (blk_rows * LANES)).astype(np.int32)
    p = SplitPass(
        n_steps=n_steps, sbt=sbt, K=n_groups, Q=Q,
        in_rows=slots // LANES, out_rows=out_rows, stitch=stitch,
        s1=src, s2=None, s3=None, starts=starts, pos=pos)
    return p, new_cur


def plan_shuffle(dst_pos: np.ndarray, n_final_tiles: int, n_regions: int,
                 sbt: int = 8, q1: int = 8) -> ShufflePlan:
    """Plan a 2-pass shuffle (see plan_shuffle_multi for semantics)."""
    slots = dst_pos.shape[0]
    n_tiles_in = slots // TILE
    n_steps1 = n_tiles_in // sbt
    r1_tiles = (n_steps1 * sbt * q1) // LANES
    if r1_tiles * LANES != n_steps1 * sbt * q1:
        raise ValueError("geometry: pass-1 region is not tile-aligned")
    return plan_shuffle_multi(
        dst_pos, n_final_tiles,
        levels=[(int(n_regions), q1, r1_tiles)], sbt=sbt)


def plan_shuffle_multi(dst_pos: np.ndarray, n_final_tiles: int,
                       levels, sbt: int = 8, log=None) -> ShufflePlan:
    """Plan an N-pass shuffle.

    dst_pos: (in_rows*128,) int64; per input slot, the requested
    destination flat position over `n_final_tiles` (128,128) output
    tiles, or -1 for input junk. Destinations must be injective. The
    engine guarantees each destination TILE ends up holding exactly its
    elements; the within-tile slot arrangement is reported in
    `slot_of_dst` (consumers finish with one tile-perm).

    levels: list of (G_l, q_l, region_tiles_l) for every non-final
    pass; the final pass's quota q_last = 128 * sbt_steps... is derived
    from the last region size (region_tiles * q_last == 128). Final
    tiles are distributed over the level tree by MIXED-RADIX
    ROUND-ROBIN: level-l digit of tile f is (f // prod(G_1..G_{l-1}))
    % G_l, so runs of consecutive destination tiles (e.g. one heavy
    row's tiles) spread across regions instead of concentrating any
    region's quota windows. Raises ValueError on quota overflow or
    inconsistent geometry — callers search geometry and retry.
    """
    slots = dst_pos.shape[0]
    if slots % (sbt * TILE) != 0:
        raise ValueError("input slots must be a multiple of sbt*16384")
    F = int(n_final_tiles)
    if dst_pos.size and dst_pos.max() >= F * TILE:
        raise ValueError("dst_pos out of range")

    Gs = [int(g) for g, _, _ in levels]
    prodG = 1
    for g in Gs:
        prodG *= g
    g_size = -(-F // prodG)
    F_pad = prodG * g_size

    passes = []
    cur = dst_pos
    radix = 1          # prod of G_1..G_{l-1}
    nreg = 1           # number of parent regions of the current pass
    cur_region_tiles = slots // TILE  # tiles per parent region
    for (G, q, r_tiles) in levels:
        if cur_region_tiles % sbt:
            raise ValueError("parent region tiles must be a multiple of sbt")
        spp = cur_region_tiles // sbt  # steps per parent region
        blk = sbt * q * LANES
        need_rows = spp * sbt * q
        if need_rows > r_tiles * LANES:
            raise ValueError(
                f"region_tiles={r_tiles} too small for {need_rows} quota rows")
        # group id is defined on FINAL tiles; cur holds dst positions,
        # so it is the radix-digit of the destination tile (computed
        # per slot inside the split planner: gmode=1)
        region_elems = r_tiles * TILE
        nreg_out = nreg * G

        n_steps_p = cur.shape[0] // (sbt * TILE)
        steps = np.arange(n_steps_p, dtype=np.int64)
        parent, s_in = steps // spp, steps % spp
        B0 = ((np.arange(G, dtype=np.int64)[None, :, None] * nreg
               + parent[:, None, None]) * region_elems
              + (s_in * blk)[:, None, None]
              + (np.arange(sbt, dtype=np.int64) * q * LANES)[None, None, :])

        p, cur = _plan_split(cur, None, G, sbt, q, "concat", B0,
                             out_rows=nreg_out * r_tiles * LANES,
                             sort_payload=False, level=len(passes),
                             gmode=1, radix=radix)
        passes.append(p)
        radix *= G
        nreg = nreg_out
        cur_region_tiles = r_tiles

    # final pass: each parent region maps onto g_size final tiles
    if cur_region_tiles % sbt:
        raise ValueError("final region tiles must be a multiple of sbt")
    if LANES % cur_region_tiles:
        raise ValueError(
            f"final region tiles {cur_region_tiles} must divide 128")
    q_last = LANES // cur_region_tiles
    spp = cur_region_tiles // sbt
    blk = sbt * q_last * LANES

    n_steps_l = cur.shape[0] // (sbt * TILE)
    steps = np.arange(n_steps_l, dtype=np.int64)
    parent, s_in = steps // spp, steps % spp
    B0L = ((np.arange(g_size, dtype=np.int64)[None, :, None] * radix
            + parent[:, None, None]) * TILE
           + (s_in * blk)[:, None, None]
           + (np.arange(sbt, dtype=np.int64) * q_last * LANES)[None, None, :])

    p, fin = _plan_split(cur, None, g_size, sbt, q_last, "concat",
                         B0L, out_rows=F_pad * LANES, level=len(passes),
                         gmode=2, radix=radix)
    passes.append(p)

    try:
        from spmv_tpu_torch import native

        if native.available():
            slot_of_dst = native.scatter_slots(fin, F * TILE)
            fin = None
        else:
            raise NotImplementedError
    except NotImplementedError:
        slot_of_dst = np.full(F * TILE, -1, dtype=np.int64)
        liv = fin >= 0
        fl = fin[liv]
        keep = fl < F * TILE
        slot_of_dst[fl[keep]] = np.nonzero(liv)[0][keep]

    # All quotas fit: now pay for the per-tile 3-stage routing.
    # Split perms are injective per tile (sorted distinct sources) —
    # skip the dedup pass.
    if log:
        log(f"split sim done; routing "
            f"{sum(p.s1.shape[0] for p in passes)} tiles")
    for p in passes:
        s1, s2, s3 = route_tiles(p.s1, dedupe=False)
        p.s1 = s1.reshape(-1, LANES)
        p.s2 = s2.reshape(-1, LANES)
        p.s3 = s3.reshape(-1, LANES)
    return ShufflePlan(passes=passes, in_rows=slots // LANES,
                       out_rows=F_pad * LANES, slot_of_dst=slot_of_dst)


def plan_shuffle_auto(dst_pos: np.ndarray, n_final_tiles: int,
                      sbt: int = 8, log=None) -> ShufflePlan:
    """Discover a feasible shuffle geometry and plan it.

    Tries 2-pass geometries, then 3-pass; every quota level is checked
    exactly in closed form (bincounts over the destination digits)
    before a full plan is attempted, so failed geometries cost
    milliseconds instead of a full simulation. Raises ValueError when
    nothing fits (callers fall back or re-tile their input)."""
    slots = dst_pos.shape[0]
    pad_tiles = slots // TILE
    F = int(n_final_tiles)
    live = dst_pos >= 0
    # int32 work arrays: all search ids fit, and the feasibility
    # bincounts over ~1e8 elements run ~2x faster
    dt = (dst_pos[live] // TILE).astype(np.int32)
    st_t = np.repeat(np.arange(pad_tiles, dtype=np.int32),
                     TILE)[live]
    cap = lambda q: q * LANES - (LANES - 1)
    _log = log or (lambda m: None)
    last_err = None
    # Kappa hint for the caller: min violation ratio among failed
    # constraints that scale with final-tile fill (callers shrink
    # their tile capacity by this factor and retry, skipping the
    # kappas in between — see build_stream_plan).
    shrink_hint = [None]

    def _note_shrink(ratio):
        if ratio > 1 and (shrink_hint[0] is None
                          or ratio < shrink_hint[0]):
            shrink_hint[0] = float(ratio)

    try:
        from spmv_tpu_torch import native
        _nat = native if native.available() else None
    except Exception:
        _nat = None

    def _fits1(G, q1):
        if _nat is not None:
            mx = _nat.geom_key_max(st_t, dt, G, 1, G, True,
                                   pad_tiles * G)
        else:
            mx = int(np.bincount(st_t * G + (dt % G), minlength=1).max())
        return mx <= cap(q1)

    # ---- 2-pass ----
    small = pad_tiles <= 4096  # beyond ~60M nnz only 4-pass can spread
    for q1 in (8, 16) if small else ():
        region_tiles = (pad_tiles * q1) // LANES
        if region_tiles > LANES or LANES % region_tiles \
                or region_tiles % sbt:
            continue
        q2 = LANES // region_tiles
        # q1-only term of the pass-2 mid digit, hoisted out of the G
        # sweep (each in-loop nnz-length array op costs ~10 ms/G here)
        base_mid = ((st_t // sbt) * sbt * q1) // LANES
        for G in range(2, 65, 2):
            g_size = -(-F // G)
            if not _fits1(G, q1):
                continue
            # pass-2 exact count: (mid tile, local final index)
            mid = (dt % G) * region_tiles + base_mid
            c2 = np.bincount(mid * g_size + (dt // G), minlength=1)
            if int(c2.max()) > cap(q2):
                _note_shrink(int(c2.max()) / cap(q2))
                continue
            _log(f"2-pass attempt G={G} q1={q1}")
            try:
                return plan_shuffle(dst_pos, F, G, sbt=sbt, q1=q1)
            except ValueError as e:
                last_err = e

    # ---- 3-pass ----
    tile_live = np.bincount(st_t, minlength=pad_tiles)
    for q1, q2 in ((8, 8), (8, 16), (16, 8), (16, 16)) if small else ():
        r1 = -(-pad_tiles * q1 // LANES)
        r1 = -(-r1 // sbt) * sbt
        r2 = None
        for candr in (8, 16, 32, 64, 128):
            if candr * LANES >= r1 * q2 and LANES % candr == 0 \
                    and candr % sbt == 0:
                r2 = candr
                break
        if r2 is None:
            continue
        q3 = LANES // r2
        g1_0 = max(2, int(-(-tile_live.max() // cap(q1))))
        for G1 in range(g1_0, 65, 2):
            if not _fits1(G1, q1):
                continue
            g1v = dt % G1
            mid_id = g1v * r1 + ((st_t // sbt) * sbt * q1) // LANES
            c2b = int(np.bincount(mid_id, minlength=1).max())
            G2 = None
            for delta in (0, 2, 4, 8, 16):
                cand = max(2, -(-c2b // cap(q2))) + delta
                if cand > 64:
                    break
                if np.bincount(mid_id * cand + (dt // G1) % cand,
                               minlength=1).max() <= cap(q2):
                    G2 = cand
                    break
            if G2 is None:
                continue
            g3 = -(-F // (G1 * G2))
            if g3 > 64:
                continue
            # level-3 exact count
            g2v = (dt // G1) % G2
            k3 = dt // (G1 * G2)
            step2 = mid_id // sbt
            spp2 = r1 // sbt
            sub_id = ((g2v * G1 + step2 // spp2) * r2
                      + ((step2 % spp2) * sbt * q2) // LANES)
            c3 = np.bincount(sub_id * g3 + k3, minlength=1)
            ok3 = int(c3.max()) <= cap(q3)
            _log(f"3-pass q=({q1},{q2}) G=({G1},{G2},{g3}) "
                 f"r=({r1},{r2}) level3_ok={ok3}")
            if not ok3:
                _note_shrink(int(c3.max()) / cap(q3))
                break  # level-3 concentration barely depends on G1/G2
            try:
                return plan_shuffle_multi(
                    dst_pos, F, levels=[(G1, q1, r1), (G2, q2, r2)],
                    sbt=sbt, log=log)
            except ValueError as e:
                last_err = e
                _log(f"  -> plan failed: {e}")

    # ---- 4-pass (large inputs: >~60M nnz, where 3 levels cannot
    # spread the final-tile digits thin enough). q=8 at level 1 keeps
    # the first region small; q=16 at levels 2-3 doubles the quota
    # headroom against skewed digit counts. ----
    max_final_live = int(np.bincount(dt, minlength=1).max()) if dt.size \
        else 0
    for q1, q23 in ((8, 16), (16, 16), (8, 8)):
        r1 = -(-pad_tiles * q1 // LANES)
        r1 = -(-r1 // sbt) * sbt
        r2 = -(-r1 * q23 // LANES)
        r2 = -(-r2 // sbt) * sbt
        r3 = None
        for candr in (8, 16, 32, 64, 128):
            if candr * LANES >= r2 * q23 and LANES % candr == 0 \
                    and candr % sbt == 0:
                r3 = candr
                break
        if r3 is None:
            continue
        q4 = LANES // r3
        spp2, spp3 = r1 // sbt, r2 // sbt
        # Fast structural guard: a final tile's ranks land contiguously
        # in the last region's ~content tiles, so the level-4 per-tile
        # count is at least max_final_live / content3_tiles regardless
        # of the digit split. Skip quota combos that cannot fit (the
        # caller's kappa retry shrinks max_final_live).
        content3_tiles = max(spp3 * sbt * q23 // LANES, 1)
        est_l4 = max_final_live / content3_tiles
        if est_l4 > 0.8 * cap(q4):
            _log(f"4-pass q=({q1},{q23}): level-4 estimate "
                 f"{est_l4:.0f} vs cap {cap(q4)} — need smaller tiles")
            _note_shrink(est_l4 / (0.8 * cap(q4)))
            continue
        g1_0 = max(2, int(-(-tile_live.max() // cap(q1))))
        tried_g1 = 0
        for G1 in range(g1_0, 65, 2):
            if not _fits1(G1, q1):
                _log(f"4-pass q=({q1},{q23}) G1={G1}: level-1 overflow")
                continue
            tried_g1 += 1
            if tried_g1 > 2:
                break
            if _nat is not None:
                mid_id = _nat.geom_mid1(dt, st_t, G1, r1, q1, sbt)
            else:
                mid_id = ((dt % G1) * r1
                          + ((st_t // sbt) * sbt * q1) // LANES)
            for G2 in (8, 16, 24, 32, 48, 64):
                if _nat is not None:
                    c2m = _nat.geom_key_max(mid_id, dt, G2, G1, G2,
                                            True, G1 * r1 * G2)
                else:
                    g2v = (dt // G1) % G2
                    c2m = int(np.bincount(mid_id * G2 + g2v,
                                          minlength=1).max())
                if c2m > cap(q23):
                    _log(f"4-pass G1={G1} G2={G2}: level-2 max {c2m} "
                         f"> {cap(q23)}")
                    continue
                if _nat is not None:
                    sub2 = _nat.geom_sub_next(
                        dt, mid_id, G1, G2, G1, spp2, r2, q23, sbt, "2")
                else:
                    g2v = (dt // G1) % G2
                    step2 = mid_id // sbt
                    sub2 = ((g2v * G1 + step2 // spp2) * r2
                            + ((step2 % spp2) * sbt * q23) // LANES)
                for G3 in (8, 16, 24, 32, 48, 64):
                    g4 = -(-F // (G1 * G2 * G3))
                    if not (1 <= g4 <= 64):
                        continue
                    if _nat is not None:
                        c3m = _nat.geom_key_max(
                            sub2, dt, G3, G1 * G2, G3, True,
                            G1 * G2 * r2 * G3)
                    else:
                        g3v = (dt // (G1 * G2)) % G3
                        c3m = int(np.bincount(sub2 * G3 + g3v,
                                              minlength=1).max())
                    if c3m > cap(q23):
                        _log(f"4-pass G=({G1},{G2},{G3}): level-3 max "
                             f"{c3m} > {cap(q23)}")
                        continue
                    if _nat is not None:
                        sub3 = _nat.geom_sub_next(
                            dt, sub2, G1 * G2, G3, G1 * G2, spp3, r3,
                            q23, sbt, "3")
                        c4m = _nat.geom_key_max(
                            sub3, dt, g4, G1 * G2 * G3, g4, False,
                            G1 * G2 * G3 * r3 * g4)
                    else:
                        g3v = (dt // (G1 * G2)) % G3
                        step3 = sub2 // sbt
                        sub3 = ((g3v * (G1 * G2) + step3 // spp3) * r3
                                + ((step3 % spp3) * sbt * q23) // LANES)
                        k4 = dt // (G1 * G2 * G3)
                        c4m = int(np.bincount(sub3 * g4 + k4,
                                              minlength=1).max())
                    if c4m > cap(q4):
                        _log(f"4-pass G=({G1},{G2},{G3},{g4}): level-4 "
                             f"max {c4m} > {cap(q4)}")
                        _note_shrink(c4m / cap(q4))
                        continue
                    _log(f"4-pass attempt q=({q1},{q23}) "
                         f"G=({G1},{G2},{G3},{g4}) r=({r1},{r2},{r3})")
                    try:
                        return plan_shuffle_multi(
                            dst_pos, F,
                            levels=[(G1, q1, r1), (G2, q23, r2),
                                    (G3, q23, r3)],
                            sbt=sbt, log=log)
                    except ValueError as e:
                        last_err = e
                        _log(f"  -> plan failed: {e}")
    err = ValueError(f"no feasible shuffle geometry: {last_err}")
    err.shrink = shrink_hint[0]
    raise err


def _split_plain(data, s1, s2, s3, starts, pos, *, n_steps, sbt, K, Q,
                 rows_per_g):
    """Plain PyTorch version of K5 (any device): one split pass.

    data: (n_steps*sbt*128, 128); s1..s3: same shape, uint8; starts:
    (>= n_steps, >= sbt*K) int32, row t = step t, column j*K + k; pos:
    (n_steps,) int32. Returns (K, rows_per_g, 128); rows no quota
    window covers are 0."""
    dev = data.device
    routed = route3_batched(data, s1, s2, s3)
    st = starts[:n_steps, :sbt * K].long().view(n_steps, sbt, K, 1)
    t = torch.arange(n_steps, device=dev).view(n_steps, 1, 1, 1)
    j = torch.arange(sbt, device=dev).view(1, sbt, 1, 1)
    k = torch.arange(K, device=dev).view(1, 1, K, 1)
    r = torch.arange(Q, device=dev).view(1, 1, 1, Q)
    # rows of each step's stacked routed block (indexed as one block)
    src_row = (t * sbt + j) * LANES + st + r
    dst_row = pos.long().view(n_steps, 1, 1, 1) * (sbt * Q) + j * Q + r
    out = torch.zeros((K, rows_per_g, LANES), dtype=data.dtype, device=dev)
    out[k.expand_as(src_row), dst_row.expand_as(src_row)] = routed[src_row]
    return out


def gap_rows(pos: np.ndarray, sbt: int, Q: int, rows_per_g: int) -> np.ndarray:
    """Rows of each group's output that no step's quota block covers
    (the reference kernel leaves them unwritten; the port zeroes them)."""
    covered = np.zeros(rows_per_g, dtype=bool)
    blk = sbt * Q
    for p in np.asarray(pos, np.int64):
        covered[p * blk:(p + 1) * blk] = True
    return np.nonzero(~covered)[0].astype(np.int64)


def _run_split(data, s1, s2, s3, starts, pos, *, n_steps, sbt, K, Q,
               rows_per_g, gaps):
    """K5: one split pass, (n_steps*sbt*128, 128) -> (K, rows_per_g, 128).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the CUDA kernel (csrc/shuffle_kernels.cu) or raises.
    `gaps` are the output rows to zero, `gap_rows` of the plan, on
    data's device (`StreamPlan.to` makes them)."""
    if data.device.type == "cpu":
        return _split_plain(data, s1, s2, s3, starts, pos, n_steps=n_steps,
                            sbt=sbt, K=K, Q=Q, rows_per_g=rows_per_g)
    if data.device.type != "cuda":
        raise ValueError(f"_run_split: unsupported device {data.device}")
    dev = data.device
    rows = n_steps * sbt * LANES
    _cuda.expect(data, "data", torch.float32, (rows, LANES), dev)
    for name, s in (("s1", s1), ("s2", s2), ("s3", s3)):
        _cuda.expect(s, name, torch.uint8, (rows, LANES), dev)
    if starts.dim() != 2 or starts.shape[0] < n_steps or \
            starts.shape[1] < sbt * K:
        raise ValueError(f"starts: shape {tuple(starts.shape)} does not "
                         f"cover {n_steps} steps x {sbt * K} windows")
    _cuda.expect(starts, "starts", torch.int32, tuple(starts.shape), dev)
    _cuda.expect(pos, "pos", torch.int32, (n_steps,), dev)
    _cuda.expect(gaps, "gaps", torch.int64, (gaps.numel(),), dev)
    out = torch.empty((K, rows_per_g, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_split(
        _cuda.ptr(data), _cuda.ptr(s1), _cuda.ptr(s2), _cuda.ptr(s3),
        _cuda.ptr(starts), starts.shape[1], _cuda.ptr(pos), _cuda.ptr(out),
        n_steps, sbt, K, Q, rows_per_g, _cuda.stream(dev))
    _cuda.check(rc, "spmv_split")
    _run_split.launches += 1
    if gaps.numel():
        out.index_fill_(1, gaps, 0.0)
    return out


_run_split.launches = 0


def shuffle_device_arrays(plan: ShufflePlan) -> list:
    """Per-pass kernel arrays, as NumPy: the route stages, `starts`
    padded to an (8-row multiple, 128-lane multiple) int32 table (the
    reference's layout, kept so both packages hand their kernels the
    same arrays) and `pos`. `StreamPlan.to` uploads them."""
    out = []
    for p in plan.passes:
        n_steps, sbt, K = p.starts.shape
        w = -(-(sbt * K) // LANES) * LANES
        rows = -(-n_steps // 8) * 8
        st = np.zeros((rows, w), dtype=np.int32)
        st[:n_steps, : sbt * K] = p.starts.reshape(n_steps, sbt * K)
        out.append({"s1": p.s1, "s2": p.s2, "s3": p.s3, "starts": st,
                    "pos": p.pos})
    return out


def apply_shuffle(data: torch.Tensor, plan: ShufflePlan, dev: list):
    """Run all passes; data: (in_rows, 128) -> (out_rows, 128). `dev`
    is the per-pass arrays on data's device (StreamPlan.to); regions
    interleave round-robin, so the (K, rows_per_g) group-major output
    is already consumer order and each pass ends in a free reshape."""
    x = data
    for p, d in zip(plan.passes, dev):
        x = _run_split(x, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"],
                       n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                       rows_per_g=p.out_rows // p.K, gaps=d["gaps"]
                       ).reshape(p.out_rows, LANES)
    return x
