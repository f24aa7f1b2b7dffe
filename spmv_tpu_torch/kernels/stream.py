"""Stream-SpMV: y = A @ x for arbitrary CSR, through a plan-time routed
pipeline.

Counterpart of `spmv_tpu/kernels/stream.py`. All orders are decided at
plan time (host NumPy plus the native planner) and cached per matrix:

1. **x prep** (K1, `_xprep_pass`): per x window, 128 rows of natural x
   routed into a lane-remapped, transposed x table, so that each gather
   slot finds its x value in its own sublane; hot columns get broadcast
   pages appended (glue).
2. **Gather**, one of three branches, as the plan has it:
   - with early reduction (`_reduce_pass`): products in gather order,
     each (tile, sublane, row) run collapsed to one partial by a lane
     prefix and a planned route of the run ends: prefix differences
     for plus-times (K2), a segmented lane scan for other rings (K7);
   - without it, fused (K3, `_gather_split_pass`): products formed and
     routed straight into shuffle pass 1's quota windows;
   - without it, plain (K4, `_gather_pass`): products in gather order.
3. **Shuffle** (K5, kernels/shuffle.py): routes the partials from gather
   order into row-sorted final tiles (one kernel per split pass).
4. **Scan** (`_scan_pass`): per final tile, an exact-rank route, then
   one tile-wide prefix and END/PREV prefix routes for plus-times (K6),
   or a segmented scan and the END route for other rings or
   `scan_strategy="roll"` (K8), into the tile's y window.
5. **Window merge** (glue): overlapping y windows combine by one row
   gather plus per-depth fixups on distinct rows.

The planner is the reference's, copied: for the same matrix and policy
it emits the same arrays, bit for bit (tests/test_torch_plan.py), and
`build_stream_plan` returns NumPy only; `StreamPlan.to(device)` uploads.
Each kernel wrapper runs its plain PyTorch version on a CPU tensor and
launches its CUDA kernel (csrc/) on a CUDA tensor, or raises. Rows that
no kernel writes with data (junk) hold the ring's identity.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _time
from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch import config
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.shuffle import (
    TILE,
    ShufflePlan,
    _split_plain,
    apply_shuffle,
    gap_rows,
    plan_shuffle_auto,
    shuffle_device_arrays,
)
from spmv_tpu_torch.kernels.tile_ops import (
    LANES,
    flat_cumsum_tiles,
    flat_iota,
    route3_batched,
    segmented_scan_lanes,
    segmented_scan_tile,
)
from spmv_tpu_torch.ops.registry import (
    register,
    plan_cache,
    PlanCapacityError,
    resolve_val_dtype,
)
from spmv_tpu_torch.ops.routing import route_tiles
from spmv_tpu_torch.ops.semiring import (
    OR_AND,
    OR_AND_COUNTING,
    PLUS_TIMES,
    Semiring,
    device_ring_code,
)

BIN_ROWS = 16384  # max row span of one final tile = rel positions of
# one full (128,128) route tile
SBT_SCAN_MAX = 16  # plan-time scan-tile padding granule (final tiles
# are padded to a multiple of it)

# The reference planner's x-table budget, kept verbatim: it gates the
# lane remap and enters the layout cost model, so it shapes the plan.
# It is not an H100 measurement.
X_VMEM_MAX_BYTES = 6 << 20


@dataclasses.dataclass(frozen=True)
class StreamPolicy:
    kappa: int = 14336       # live nnz per final tile
    hot_threshold: int = 2048  # column count to qualify for replication
    gather_sbt: int = 8      # gather tiles per planner step
    scan_sbt: int = 8        # dispatch-time batching knob of the reference
    # scan; kept so policies and cache keys match (the port's scan
    # kernel runs one block per final tile whatever its value)
    scan_strategy: str = "auto"  # "auto" | "roll" (K8 for every ring)
    # early reduction: collapse same-row products into one partial per
    # (gather tile, sublane, row) run during the gather pass. "auto":
    # on when the plan-time run count shows >= REDUCE_MIN_FACTOR
    # duplication; "on" forces (raises if infeasible); "off" disables.
    reduce: str = "auto"
    # column -> sublane lane remap over variable-span x windows (K1
    # builds the remapped x table)
    remap: bool = True

    def structural_fields(self) -> dict:
        """Fields that shape the plan (= the plan-cache key)."""
        return {"kappa": self.kappa, "hot_threshold": self.hot_threshold,
                "gather_sbt": self.gather_sbt, "reduce": self.reduce,
                "remap": self.remap}


def check_x_windows(gather: dict) -> None:
    """Raise ValueError unless every x window of a lane-remapped plan,
    rows [g0[w], g0[w] + 128) of the natural x table, lies within its
    x_nat_rows rows. The planner sizes x_nat_rows so; K1 copies each
    window whole (csrc/stream_kernels.cu), and a plan read from a file
    is not rebuilt, so `StreamPlan.to` checks every plan it uploads."""
    if "g0" not in gather:
        return
    g0 = np.asarray(gather["g0"], dtype=np.int64)
    n = int(gather["x_nat_rows"])
    bad = np.flatnonzero((g0 < 0) | (g0 + LANES > n))
    if bad.size:
        w = int(bad[0])
        raise ValueError(f"x window {w}: rows [{g0[w]}, {g0[w] + LANES}) leave "
                         f"the natural x table's {n} rows")


def _upload(d: Optional[dict], device) -> Optional[dict]:
    if d is None:
        return None
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v) for k, v in d.items()}


@dataclasses.dataclass
class StreamPlan:
    n_gather_tiles: int
    n_final_tiles: int
    layers: int
    x_rows_pad: int          # rows of the x table before augmentation
    hot_cols: object         # (n_aug,) column replicated per aug lane
    gather: dict             # Ax, q, xb (+ xr1..3, g0, x_nat_rows)
    shuffle: ShufflePlan
    shuffle_dev: list        # per-pass kernel arrays
    scan: dict               # scan routes, counts, merge arrays
    n_y_blocks: int          # 128-row blocks of the merged y
    # early-reduction arrays (None = plain gather): c1/c2/c3 route
    # stages (first-run flag in c3 bit 7), rs run starts, Qp partial
    # quota rows per tile, out_rows of the junk-padded partial stream
    reduce: Optional[dict] = None

    def to(self, device) -> "StreamPlan":
        """The same plan with every array a tensor on `device` (dtypes
        kept: uint8 routes, int8 q/rs/valid2, int16 relid, int32
        indices). Each shuffle pass also gets `gaps`, the output rows
        that K5 (and K3 for pass 0) fill with the ring's identity. Raises
        ValueError on an x window that leaves the natural x table."""
        check_x_windows(self.gather)
        shuffle_dev = []
        for p, d in zip(self.shuffle.passes, self.shuffle_dev):
            dd = _upload(d, device)
            dd["gaps"] = torch.from_numpy(gap_rows(
                np.asarray(d["pos"]), p.sbt, p.Q, p.out_rows // p.K)).to(device)
            shuffle_dev.append(dd)
        return dataclasses.replace(
            self,
            hot_cols=torch.from_numpy(
                np.ascontiguousarray(self.hot_cols)).to(device),
            gather=_upload(self.gather, device),
            shuffle_dev=shuffle_dev,
            scan=_upload(self.scan, device),
            reduce=_upload(self.reduce, device))


# ---------------------------------------------------------------------------
# Plan construction (the reference planner, copied)
# ---------------------------------------------------------------------------

def _plan_gather(Aj: np.ndarray, policy: StreamPolicy, x_blocks_pad: int):
    """Assign each nnz to a gather slot.

    Returns (slot_src, slot_q, xb, hot_cols):
      slot_src: (T*16384,) int64 CSR rank per slot, -1 junk
      slot_q:   (T*16384,) int8 lane of the slot's x value within the
                tile's transposed x window, -1 junk (slot (s,l) holds
                a nnz with column ≡ s mod 128; q = (col // 128) % 128)
      xb:       (T,) int32 x window base per tile, in 128-row BLOCK units
                (cold: 16K-column window index; hot: an aug page past
                x_blocks_pad)
      hot_cols: (n_pages*128,) int64 column replicated into each aug lane
    """
    nnz = Aj.shape[0]
    counts = np.bincount(Aj, minlength=0)
    hot_mask_col = counts >= policy.hot_threshold
    is_hot = hot_mask_col[Aj]
    W = 128 * LANES  # columns per x window

    tiles_src, tiles_q, xb_list = [], [], []
    hot_cols: list = []

    # --- cold nnz: per 16K-column window, balanced lane fill ---
    cold_idx = np.nonzero(~is_hot)[0]
    cold_cols = Aj[cold_idx]
    order = np.argsort(cold_cols, kind="stable")
    cold_idx = cold_idx[order]
    cold_cols = cold_cols[order]
    win = cold_cols // W
    w_bounds = np.searchsorted(win, np.arange(0, (win[-1] + 2) if win.size else 1))
    for w in range(w_bounds.shape[0] - 1):
        b, e = int(w_bounds[w]), int(w_bounds[w + 1])
        if e <= b:
            continue
        idx = cold_idx[b:e]
        cols = cold_cols[b:e]
        subs = cols % LANES            # slot SUBLANE (fixed by column)
        qlanes = (cols // LANES) - w * LANES  # in [0, 128): window lane
        sub_cnt = np.bincount(subs, minlength=LANES)
        t_w = int(-(-sub_cnt.max() // LANES))
        # round-robin within each sublane across t_w tiles (vectorized):
        # the i-th entry of sublane s goes to tile i%t_w, lane i//t_w
        srcs = np.full((t_w, TILE), -1, dtype=np.int64)
        qs = np.full((t_w, TILE), -1, dtype=np.int8)
        sub_order = np.argsort(subs, kind="stable")
        ssorted = subs[sub_order]
        lb = np.searchsorted(ssorted, np.arange(LANES + 1))
        within = np.arange(ssorted.shape[0]) - lb[ssorted]
        ti = within % t_w
        lpos = within // t_w
        srcs[ti, ssorted * LANES + lpos] = idx[sub_order]
        qs[ti, ssorted * LANES + lpos] = qlanes[sub_order]
        for t_i in range(t_w):
            tiles_src.append(srcs[t_i])
            tiles_q.append(qs[t_i])
            xb_list.append(w)

    # --- hot nnz: packed tiles over augmented broadcast pages; each
    # hot tile owns one 128-row aug page (one row per distinct column,
    # the value broadcast across lanes) ---
    hot_idx = np.nonzero(is_hot)[0]
    if hot_idx.size:
        hcols = Aj[hot_idx]
        horder = np.argsort(hcols, kind="stable")
        hot_idx = hot_idx[horder]
        hcols = hcols[horder]
        p = 0
        n = hot_idx.shape[0]
        while p < n:
            src = np.full(TILE, -1, dtype=np.int64)
            qv = np.full(TILE, -1, dtype=np.int8)
            page = np.zeros(LANES, dtype=np.int64)
            nrows = 0
            filled = 0
            while p < n and filled < TILE and nrows < LANES:
                c = hcols[p]
                e = int(np.searchsorted(hcols, c, side="right"))
                take = min(e - p, TILE - filled)
                page[nrows] = c
                src[filled:filled + take] = hot_idx[p:p + take]
                qv[filled:filled + take] = nrows
                nrows += 1
                filled += take
                p += take
            tiles_src.append(src)
            tiles_q.append(qv)
            xb_list.append(x_blocks_pad + len(hot_cols) // LANES)
            hot_cols.extend(page.tolist())

    T = len(tiles_src)
    slot_src = (np.concatenate(tiles_src) if T else
                np.empty(0, np.int64))
    slot_q = (np.concatenate(tiles_q) if T else np.empty(0, np.int8))
    xb = np.asarray(xb_list, dtype=np.int32)
    assert slot_src[slot_src >= 0].size == nnz
    return slot_src, slot_q, xb, np.asarray(hot_cols, dtype=np.int64)


WINDOW_ALIGN = 8    # window starts align to 8 natural col groups (the
# (8,128) f32 sublane tile: dynamic slices of the resident natural x
# stay tile-aligned)
WINDOW_MARGIN = 256  # close-window slack for the snake deal's max-load
# overshoot over the window mean


def _plan_windows(gl: np.ndarray) -> np.ndarray:
    """Variable-span x windows over natural 128-column groups.

    Fixed 16K-column windows quantize slot fill at ceil(load/16384)
    tiles per window (~79% fill on the bench matrix — the real cause
    of the round-4 'col-mod-128 imbalance' headroom, measured round
    5). Greedy variable spans close each window where its load is
    about to cross a whole-tile multiple (or at the 128-group column
    capacity), so nearly every tile runs full. Returns the window
    start-group array g0 (n_w+1,), starts aligned to WINDOW_ALIGN.
    """
    G = gl.shape[0]
    bounds = [0]
    load = 0
    groups = 0
    for g in range(0, G, WINDOW_ALIGN):
        gload = int(gl[g:g + WINDOW_ALIGN].sum())
        if groups >= LANES or (
                load >= 2 * TILE - WINDOW_MARGIN
                and load + gload > -(-load // TILE) * TILE):
            bounds.append(g)
            load = 0
            groups = 0
        load += gload
        groups += WINDOW_ALIGN
    bounds.append(G)
    return np.asarray(bounds, dtype=np.int64)


def _assign_cols_balanced(uc: np.ndarray, cnt: np.ndarray,
                          win_of_col: np.ndarray, g0: np.ndarray,
                          n_w: int):
    """Balanced column->sublane assignment per x window.

    Columns of each window are sorted by descending nnz count and
    snake-dealt across the 128 sublanes (round k runs forward for even
    k, backward for odd), so per-sublane loads stay near the window
    mean instead of inheriting the col-mod-128 residue skew. Each
    sublane receives at most 128 columns (= its lane capacity in the
    remapped x row). Returns (sub_of_col, lane_of_col, xroute) where
    xroute[w, s, q] is the source position of the column assigned to
    slot (s, q) within the window's 128-group slice of the natural x
    layout (rows [g0[w], g0[w]+128) of x.reshape(-1, 128)), -1 for
    empty slots — the per-window 3-stage route that builds the
    remapped-transposed x table.
    """
    order = np.lexsort((-cnt, win_of_col))
    w_o = win_of_col[order]
    wstart = np.searchsorted(w_o, np.arange(n_w + 1))
    iwin = np.arange(uc.shape[0], dtype=np.int64) - wstart[w_o]
    k = iwin // LANES
    pos = iwin % LANES
    sub_o = np.where(k % 2 == 0, pos, LANES - 1 - pos)
    sub_of = np.empty(uc.shape[0], np.int64)
    lane_of = np.empty(uc.shape[0], np.int64)
    sub_of[order] = sub_o
    lane_of[order] = k
    src_local = ((uc // LANES - g0[win_of_col]) * LANES
                 + uc % LANES).astype(np.int32)
    assert (src_local >= 0).all() and (src_local < TILE).all()
    xr = np.full((n_w, LANES, LANES), -1, np.int32)
    xr[win_of_col, sub_of, lane_of] = src_local
    return sub_of, lane_of, xr


# The reference planner's constants, kept verbatim so both packages
# emit the same plans; they are not H100 measurements.
REDUCE_MIN_FACTOR = 1.5  # nnz per partial below which the pass-0
# early reduction is not taken
REDUCE_MAX_RUNS = 8192   # partials per tile: C/P occupy the two 64-row
# halves of one routed (128,128) tile


def _plan_gather_reduce(Aj: np.ndarray, row_ids: np.ndarray,
                        policy: StreamPolicy, x_blocks_pad: int):
    """Gather plan with early row-reduction.

    Same slot constraints as `_plan_gather` (cold slot sublane fixed by
    col mod 128 within its 16K-column x window; hot pages free-form)
    but each (tile, sublane) is filled CONTIGUOUSLY BY ROW instead of
    round-robin, so same-row products form lane RUNS. Pass 0 collapses
    each run to one partial: lane-prefix cumsum +
    one 3-stage route of the run-end prefixes to compact positions;
    the predecessor value is a flat shift of the routed stream (runs
    are emitted in sublane-major order, so run p's predecessor-end IS
    the value at p-1, with sublane-first runs masked to zero) — no
    second route, and the C route is injective (dedupe-free) with
    per-source-row degree <= 128 always.

    This is the plan-time analog of the merge walk's within-thread
    accumulation (ref: merge_based/agent_spmv_orig.cuh:340-384): the
    GPU reduces consecutive same-row items in registers; here the
    planner MAKES items lane-consecutive and one matmul reduces them.

    Returns None when reduction cannot fit (> REDUCE_MAX_RUNS runs in
    a tile) or would not pay (duplication < REDUCE_MIN_FACTOR).
    Otherwise returns (slot_src, slot_q, xb, hot_cols, red) with red =
    dict(src_route, firstmask, part_rows, tile_of_part, Qp).
    """
    nnz = Aj.shape[0]
    counts = np.bincount(Aj, minlength=0)
    hot_mask_col = counts >= policy.hot_threshold
    is_hot = hot_mask_col[Aj]
    W = 128 * LANES

    tiles_src: list = []
    tiles_q: list = []
    xb_list: list = []
    hot_cols: list = []

    # --- cold: per (window, sublane) bucket, sorted by row, cut into
    # contiguous 128-lane chunks across the window's tiles ---
    cold_idx = np.nonzero(~is_hot)[0]
    xroute = None
    g0_w = None
    x_nat_rows = 0
    if cold_idx.size:
        ccols = Aj[cold_idx]
        crows = row_ids[cold_idx]
        G = int(ccols.max() // LANES) + 1
        # the reference planner's gate for the remap (X_VMEM_MAX_BYTES,
        # kept for plan parity): huge tables keep the plain
        # col-mod-128 layout
        remap = (policy.remap
                 and (G + LANES) * LANES * 4 <= X_VMEM_MAX_BYTES)
        if remap:
            # Variable-span windows + balanced column->sublane deal.
            # Score fixed 16K-column windows against the greedy
            # load-quantized spans: variable spans win on sparse
            # column regions and sub-integer loads (bench matrix:
            # 256 -> ~204 gather tiles); fixed wins when its table fits
            # the X_VMEM_MAX_BYTES budget and variable's would not.
            gl = np.bincount(ccols // LANES, minlength=G)
            cs = np.concatenate([[0], np.cumsum(gl)])

            # the reference planner's layout cost model (per-tile and
            # per-byte constants of the reference design, kept verbatim
            # for plan parity; not H100 measurements)
            def _layout(bounds):
                loads = cs[bounds[1:]] - cs[bounds[:-1]]
                tiles = int((-(-loads // TILE)).sum())
                n_wl = int((loads > 0).sum())
                xbytes = -(-n_wl // 8) * 8 * TILE * 4
                if xbytes > X_VMEM_MAX_BYTES:
                    xbytes = tiles * TILE * 4
                return tiles * 530e-9 + xbytes / 636e9, loads

            bounds_f = np.unique(np.concatenate(
                [np.arange(0, G, LANES, dtype=np.int64), [G]]))
            bounds_v = _plan_windows(gl)
            sf, loads_f = _layout(bounds_f)
            sv, loads_v = _layout(bounds_v)
            bounds, loads = ((bounds_v, loads_v) if sv <= sf
                             else (bounds_f, loads_f))
            live_w = loads > 0
            n_w = int(live_w.sum())
            wid = np.where(live_w, np.cumsum(live_w) - 1, -1)
            win_of_group = np.repeat(wid, np.diff(bounds))
            g0_w = bounds[:-1][live_w].astype(np.int64)
            x_nat_rows = -(-(G + LANES) // 8) * 8
            uc, cnt = np.unique(ccols, return_counts=True)
            sub_of_col, lane_of_col, xroute = _assign_cols_balanced(
                uc, cnt, win_of_group[uc // LANES], g0_w, n_w)
            # dense col->assignment lookup (a searchsorted map here
            # measured ~20x slower than the direct table)
            sub_lut = np.empty(int(uc[-1]) + 1, np.int64)
            lane_lut = np.empty(int(uc[-1]) + 1, np.int64)
            sub_lut[uc] = sub_of_col
            lane_lut[uc] = lane_of_col
            win_all = win_of_group[ccols // LANES]
            sub_all = sub_lut[ccols]
            qlan_all = lane_lut[ccols].astype(np.int8)
        else:
            win_all = ccols // W
            sub_all = ccols % LANES
            qlan_all = ((ccols // LANES) % LANES).astype(np.int8)
        # single composite-key argsort ~2x a 4-key lexsort when the
        # ranges fit 64 bits: bucket (win*128+sub) | row | col. The
        # remap gate bounds cols (< 1.5M < 2^21) and buckets (< 2^20);
        # rows must fit 22 bits, else fall back to lexsort.
        bkey0 = win_all * LANES + sub_all
        if remap and int(crows.max(initial=0)) < (1 << 22):
            comp = (bkey0.astype(np.uint64) << np.uint64(43)) \
                | (crows.astype(np.uint64) << np.uint64(21)) \
                | ccols.astype(np.uint64)
            order = np.argsort(comp, kind="stable")
        else:
            order = np.lexsort((ccols, crows, sub_all, win_all))
        cold_idx = cold_idx[order]
        ccols = ccols[order]
        win = win_all[order]
        sub = sub_all[order]
        qlan = qlan_all[order]
        bkey = win * LANES + sub
        # bkey is already sorted (it occupies the top bits of both
        # sort branches' keys), so unique = boundary diff; np.unique
        # would re-sort the 3.3M-element array (~2 s at bench scale)
        chg = np.empty(bkey.shape[0], dtype=bool)
        chg[0] = True
        np.not_equal(bkey[1:], bkey[:-1], out=chg[1:])
        ustart = np.nonzero(chg)[0]
        ub = bkey[ustart]
        bidx = np.searchsorted(ub, bkey)
        pos = np.arange(bkey.shape[0]) - ustart[bidx]
        blen = np.diff(np.concatenate([ustart, [bkey.shape[0]]]))
        n_w = int(win[-1]) + 1
        maxlen = np.zeros(n_w, dtype=np.int64)
        np.maximum.at(maxlen, ub // LANES, blen)
        t_w = -(-maxlen // LANES)
        tile_base = np.concatenate([[0], np.cumsum(t_w)])
        # Per-bucket chunk->tile ROTATION: chunk i of bucket (w, s)
        # lands in tile (i + s*phi) % t_w[w] instead of tile i.
        # Sequential assignment piles every bucket's first chunk into
        # tile 0 of its window, so the per-tile RUN counts skew ~1.75x
        # over the mean — which alone forces the partial-stream quota
        # (Qp) up a whole padding class. The rotation decorrelates the
        # bucket phases; runs stay lane-contiguous per (tile, sublane).
        t_w_of = t_w[win]
        # The rotation phase is constant per (window, sublane) bucket:
        # compute it on the ~|buckets| array and gather, and fold the
        # second mod into one compare-subtract (chunk < t_w and
        # phi < t_w, so their sum needs at most one wrap). Vectorized
        # int64 `%` costs ~500 ns/element on this host — keeping both
        # mods off the nnz-length arrays is ~2.5 s at bench scale.
        phi_b = ((ub % LANES) * 2654435761) % np.maximum(
            t_w[ub // LANES], 1)
        s_rot = (pos // LANES) + phi_b[bidx]
        s_rot -= np.where(s_rot >= t_w_of, t_w_of, 0)
        tile_of = tile_base[win] + s_rot
        lane_of = pos & (LANES - 1)
        T_cold = int(tile_base[-1])
        src = np.full(T_cold * TILE, -1, dtype=np.int64)
        qv = np.full(T_cold * TILE, -1, dtype=np.int8)
        slot = tile_of * TILE + sub * LANES + lane_of
        src[slot] = cold_idx
        qv[slot] = qlan
        for t in range(T_cold):
            tiles_src.append(src[t * TILE:(t + 1) * TILE])
            tiles_q.append(qv[t * TILE:(t + 1) * TILE])
        xb_list.extend(np.repeat(np.arange(n_w), t_w).tolist())

    # --- hot: page packing as in _plan_gather, then each tile's
    # entries re-sorted by row and refilled sublane-major (hot slots
    # have no sublane constraint: q is the aug-page row per slot).
    # Aug pages sit after the cold table: with the remap layout the
    # cold table has one 128-row block per LIVE window. ---
    if xroute is not None:
        x_blocks_pad = -(-xroute.shape[0] // 8) * 8
    hot_idx = np.nonzero(is_hot)[0]
    if hot_idx.size:
        hcols = Aj[hot_idx]
        horder = np.argsort(hcols, kind="stable")
        hot_idx = hot_idx[horder]
        hcols = hcols[horder]
        p = 0
        n = hot_idx.shape[0]
        while p < n:
            ent_src: list = []
            ent_q: list = []
            page = np.zeros(LANES, dtype=np.int64)
            nrows = 0
            while p < n and len(ent_src) < TILE and nrows < LANES:
                c = hcols[p]
                e = int(np.searchsorted(hcols, c, side="right"))
                take = min(e - p, TILE - len(ent_src))
                page[nrows] = c
                ent_src.extend(hot_idx[p:p + take].tolist())
                ent_q.extend([nrows] * take)
                nrows += 1
                p += take
            es = np.asarray(ent_src, dtype=np.int64)
            eq = np.asarray(ent_q, dtype=np.int8)
            ro = np.argsort(row_ids[es], kind="stable")
            src = np.full(TILE, -1, dtype=np.int64)
            qv = np.full(TILE, -1, dtype=np.int8)
            src[:es.shape[0]] = es[ro]
            qv[:es.shape[0]] = eq[ro]
            tiles_src.append(src)
            tiles_q.append(qv)
            xb_list.append(x_blocks_pad + len(hot_cols) // LANES)
            hot_cols.extend(page.tolist())

    T = len(tiles_src)
    slot_src = (np.concatenate(tiles_src) if T else
                np.empty(0, np.int64))
    slot_q = (np.concatenate(tiles_q) if T else np.empty(0, np.int8))
    xb = np.asarray(xb_list, dtype=np.int32)
    assert slot_src[slot_src >= 0].size == nnz

    # --- run structure over (tile, sublane) lanes ---
    rows3 = np.where(slot_src >= 0,
                     row_ids[np.clip(slot_src, 0, None)],
                     -1).reshape(T, LANES, LANES)
    live = rows3 >= 0
    prev_row = np.full_like(rows3, -2)
    prev_row[:, :, 1:] = rows3[:, :, :-1]
    is_start = live & (rows3 != prev_row)
    t_i, s_i, l_i = np.nonzero(is_start)  # C order = emission order
    n_runs = t_i.shape[0]
    if n_runs == 0 or nnz / n_runs < REDUCE_MIN_FACTOR:
        return None
    R_t = np.bincount(t_i, minlength=T)
    if int(R_t.max()) > REDUCE_MAX_RUNS:
        return None

    # run end lane: next start's lane - 1 within the same (t, s),
    # else the sublane's last live lane (entries fill lanes from 0)
    live_len = live.sum(axis=2)  # (T, LANES)
    same_bucket = np.zeros(n_runs, dtype=bool)
    if n_runs > 1:
        same_bucket[:-1] = (t_i[1:] == t_i[:-1]) & (s_i[1:] == s_i[:-1])
    end_lane = np.where(
        same_bucket,
        np.concatenate([l_i[1:], [0]]) - 1,
        live_len[t_i, s_i] - 1)

    # compact dest position p = run index within its tile
    tile_start = np.concatenate([[0], np.cumsum(R_t)])
    p_of = np.arange(n_runs) - tile_start[t_i]
    src_route = np.full((T, LANES, LANES), -1, dtype=np.int32)
    src_route[t_i, p_of // LANES, p_of % LANES] = \
        (s_i * LANES + end_lane).astype(np.int32)
    firstmask = np.zeros((T, REDUCE_MAX_RUNS // LANES, LANES),
                         dtype=np.int8)
    fr = l_i == 0  # first run of its sublane
    firstmask[t_i[fr], p_of[fr] // LANES, p_of[fr] % LANES] = 1

    part_rows = rows3[t_i, s_i, l_i]  # row per partial, emission order
    red = {
        "src_route": src_route,
        "firstmask": firstmask,
        "runstart": is_start.astype(np.int8),  # generic-ring reduce
        "part_rows": part_rows,
        "tile_of_part": t_i,
        "p_of_part": p_of,
        "n_runs": n_runs,
        # x remap layout (None/absent when remap off): per-live-window
        # route tiles, window start groups, natural-x input rows
        "xroute": xroute,
        "g0": g0_w,
        "x_nat_rows": x_nat_rows,
    }
    return slot_src, slot_q, xb, np.asarray(hot_cols, dtype=np.int64), red


def _final_tile_walk(Ap: np.ndarray, row_ids: np.ndarray, kappa: int):
    """Cut the row-sorted nnz stream into final tiles: each takes up
    to `kappa` nnz and spans fewer than BIN_ROWS rows from its own
    128-aligned row base (its y window is a (BIN_ROWS/128, 128) block
    at that base). Tiles do NOT align to fixed bins — overlapping
    windows are merged outside the scan kernel — so tiles stay ~full
    instead of being cut at every 8192-row boundary (the round-2
    bin-aligned walk left tiles ~52% live on the bench matrix, which
    taxed every downstream pass by the same factor). Returns k_starts
    (F+1,), base (F,) int64, r_start (F,), lrow (F,)."""
    nnz = row_ids.shape[0]
    if nnz == 0:
        return (np.zeros(1, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    starts, bases = [], []
    s = 0
    while s < nnz:
        base = int(row_ids[s]) & ~(LANES - 1)
        lim = int(np.searchsorted(row_ids, base + BIN_ROWS, side="left"))
        starts.append(s)
        bases.append(base)
        s = min(s + kappa, lim)
    k_starts = np.asarray(starts + [nnz], dtype=np.int64)
    bases = np.asarray(bases, dtype=np.int64)
    r_starts = row_ids[k_starts[:-1]].astype(np.int32)
    lrows = row_ids[k_starts[1:] - 1].astype(np.int32)
    return k_starts, bases, r_starts, lrows


def _plan_scan(plan_sh: ShufflePlan, k_starts, bases, r_starts, lrows,
               row_ids):
    """Build per-final-tile scan streams (v3 exact-rank layout; mirror
    of native spmv_plan_scan3).

    The kernel first routes the tile's slots into EXACT RANK order
    (positions 1..m; position 0 is a reserved zero-prefix slot), which
    makes rel ids MONOTONE in position: every row is one contiguous
    run, so its total is S[e_r] - S[e_{r-1}] for a single tile-wide
    cumsum S, where e_r is the row's last position. Streams:

    - perm_src: exact-perm route source (slot of rank p-1 at position
      p); the junk mask is simply position in [1, m+1) with m the
      per-tile `counts` scalar — no per-slot mask stream.
    - src2e / src2p: END and PREV position per present rel, routed
      into the (BIN_ROWS-rel) y window; y = ends - prevs, masked by
      valid2 (absent rels). The generic roll path uses src2e only
      (its segmented scan restarts per rel).
    - relid (roll path only): rel id per exact position, junk-flagged
      (+16384) at position 0 and the tail.
    """
    F = k_starts.shape[0] - 1
    P = BIN_ROWS // LANES

    try:
        from spmv_tpu_torch import native

        if native.available():
            (perm_src, relid, src2e, src2p, valid2, counts) = \
                native.plan_scan(
                    np.asarray(k_starts, np.int64),
                    np.asarray(bases, np.int64),
                    plan_sh.slot_of_dst, np.asarray(row_ids, np.int64),
                    BIN_ROWS)
            return _scan_route_streams(perm_src, relid, src2e, src2p,
                                       valid2, counts)
    except NotImplementedError:
        pass
    perm_src = np.full((F, LANES, LANES), -1, dtype=np.int32)
    relid = np.zeros((F, TILE), dtype=np.int16)
    src2e = np.full((F, LANES, LANES), -1, dtype=np.int32)
    src2p = np.full((F, LANES, LANES), -1, dtype=np.int32)
    valid2 = np.zeros((F, P, LANES), dtype=np.int8)
    counts = np.zeros(F, dtype=np.int32)
    for f in range(F):
        a, b = int(k_starts[f]), int(k_starts[f + 1])
        m = b - a
        if m > TILE - 1:
            raise ValueError(f"scan capacity: {m} ranks in tile {f}")
        d = np.arange(a, b) - a + f * TILE
        slots = plan_sh.slot_of_dst[d]
        assert (slots >= 0).all()
        local = (slots - f * TILE).astype(np.int64)
        assert (local >= 0).all() and (local < TILE).all(), \
            "shuffle placed a rank outside its tile"
        rels = (row_ids[a:b] - bases[f]).astype(np.int64)
        assert (rels >= 0).all() and (rels < BIN_ROWS).all()
        assert (np.diff(rels) >= 0).all(), \
            "ranks not row-sorted within tile"
        counts[f] = m
        pos = 1 + np.arange(m)
        perm_src[f].reshape(-1)[pos] = local
        rl = relid[f]
        rl[0] = rels[0] + TILE
        rl[pos] = rels
        rl[m + 1:] = rels[-1] + TILE
        new_run = np.ones(m, dtype=bool)
        new_run[1:] = rels[1:] != rels[:-1]
        starts_i = np.nonzero(new_run)[0]
        run_rels = rels[starts_i]
        ends_pos = np.append(starts_i[1:], m)  # e_r = 1 + last idx
        s2e = src2e[f].reshape(-1)
        s2p = src2p[f].reshape(-1)
        s2e[run_rels] = ends_pos
        s2p[run_rels] = np.concatenate([[0], ends_pos[:-1]])
        valid2[f].reshape(-1)[run_rels] = 1
    return _scan_route_streams(perm_src, relid, src2e, src2p, valid2,
                               counts)


def _scan_route_streams(perm_src, relid, src2e, src2p, valid2, counts):
    """Shared tail of _plan_scan: 3-stage-route the stream sources.

    (A forward-filled END route that would let the kernel derive PREV
    by a flat shift was tried in round 5 and rejected: fill fan-out
    concentrates a sparse tile's run-end sources into S row 0 and
    blows the 128-edge-per-source-row route capacity. Two injective
    routes are the degree-safe form.)"""
    F = counts.shape[0]
    pm = route_tiles(perm_src.reshape(F, LANES, LANES), dedupe=False)
    r2e = route_tiles(src2e.reshape(F, LANES, LANES), dedupe=False)
    r2p = route_tiles(src2p.reshape(F, LANES, LANES), dedupe=False)
    return {
        "relid": relid,
        "pm1": pm[0], "pm2": pm[1], "pm3": pm[2],
        "r2s1": r2e[0], "r2s2": r2e[1], "r2s3": r2e[2],
        "q2s1": r2p[0], "q2s2": r2p[1], "q2s3": r2p[2],
        "valid2": valid2, "counts": counts,
    }


def build_stream_plan(A: CSR, policy: StreamPolicy) -> StreamPlan:
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = np.asarray(A.Ax)
    nnz = int(Ap[-1])
    row_ids = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                        Ap[1:] - Ap[:-1])
    # x2d is padded to whole 16K-column windows (128-row blocks);
    # with the lane remap the window count also rounds to the xprep
    # kernel's 8-window grid granule
    x_blocks_pad = -(-A.n_cols // (LANES * LANES))
    if policy.remap:
        x_blocks_pad = -(-x_blocks_pad // 8) * 8
    x_rows_pad = x_blocks_pad * LANES

    red = None
    if policy.reduce != "off":
        res = _plan_gather_reduce(Aj, row_ids, policy, x_blocks_pad)
        if res is None:
            if policy.reduce == "on":
                raise PlanCapacityError(
                    "reduce='on' but early reduction is infeasible or "
                    "unprofitable for this matrix (runs/tile > "
                    f"{REDUCE_MAX_RUNS} or duplication < "
                    f"{REDUCE_MIN_FACTOR})")
        else:
            slot_src, slot_q, xb, hot_cols, red = res
            if red.get("xroute") is not None:
                # remap layout: the x table holds one 128-row block
                # per LIVE window (+ aug pages), not per natural window
                x_blocks_pad = -(-red["xroute"].shape[0] // 8) * 8
                x_rows_pad = x_blocks_pad * LANES
    if red is None:
        slot_src, slot_q, xb, hot_cols = _plan_gather(
            Aj, policy, x_blocks_pad)
    n_gather_tiles = xb.shape[0]

    if n_gather_tiles > 16384:
        raise PlanCapacityError(
            f"matrix too large for the shuffle planner: {n_gather_tiles} "
            f"gather tiles > 16384 (~240M nnz); use kind "
            f"'merge_tiled'/'xla'")
    # pad gather tiles: with reduction, pass-0 tiles only need the
    # sbt=8 grid granule (x16 so tiles*Qp stays 128-row aligned); the
    # SHUFFLE input is then the (smaller) partial stream, padded to
    # the shuffle's own 128-tile granule below. Without reduction the
    # gather output IS the shuffle input.
    pad_tiles = (max(16, -(-n_gather_tiles // 16) * 16) if red is not None
                 else max(128, -(-n_gather_tiles // 128) * 128))
    padn = pad_tiles - n_gather_tiles
    if padn:
        slot_src = np.concatenate(
            [slot_src, np.full(padn * TILE, -1, np.int64)])
        slot_q = np.concatenate([slot_q, np.full(padn * TILE, -1, np.int8)])
        xb = np.concatenate([xb, np.zeros(padn, np.int32)])
        if red is not None:
            red["src_route"] = np.concatenate(
                [red["src_route"],
                 np.full((padn, LANES, LANES), -1, np.int32)])
            red["firstmask"] = np.concatenate(
                [red["firstmask"],
                 np.zeros((padn, REDUCE_MAX_RUNS // LANES, LANES),
                          np.int8)])
            red["runstart"] = np.concatenate(
                [red["runstart"],
                 np.zeros((padn, LANES, LANES), np.int8)])

    # Final-tile capacity, region geometry and pass-1 quota are chosen
    # together: smaller matrices need emptier final tiles (smaller
    # kappa) so pass-2 quota windows can hold each (mid tile, final
    # tile) share. A cheap exact count check prunes infeasible
    # combinations before the expensive full plan (which still
    # validates pass 2 exactly and raises on overflow).
    if red is not None:
        # Deal pass-0 tiles round-robin by descending partial count
        # across the grid steps: the partial stream is junk-padded and
        # per-tile counts vary, and the downstream pass-1 regions fill
        # by SOURCE STEP — without this, live partials cluster in the
        # early region content tiles and the final pass's per-flow
        # quota cap fails at any useful kappa (measured: shrink->1024).
        R_t = np.bincount(red["tile_of_part"], minlength=pad_tiles)
        order_t = np.argsort(-R_t, kind="stable")
        n_steps0 = pad_tiles // 8
        perm = np.empty(pad_tiles, np.int64)  # perm[new tile] = old
        new_pos = ((np.arange(pad_tiles) % n_steps0) * 8
                   + np.arange(pad_tiles) // n_steps0)
        perm[new_pos] = order_t
        slot_src = slot_src.reshape(pad_tiles, TILE)[perm].reshape(-1)
        slot_q = slot_q.reshape(pad_tiles, TILE)[perm].reshape(-1)
        xb = xb[perm]
        red["src_route"] = red["src_route"][perm]
        red["firstmask"] = red["firstmask"][perm]
        red["runstart"] = red["runstart"][perm]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(pad_tiles)
        red["tile_of_part"] = inv[red["tile_of_part"]]

        # the shuffled stream is the PARTIAL stream: one value per
        # (tile, sublane, row) run, at out slot tile*Qp*128 + p.
        # Qp grows past the needed quota so the stream FILLS its
        # padded tile space uniformly — packed-low quota blocks would
        # concentrate all live data in the first ~60% of the stream
        # and overload the downstream regions' early content tiles by
        # the same factor (measured: the per-flow quota cap then fails
        # at any kappa above ~6144).
        n_runs = red["n_runs"]
        Qp_need = max(8, -(-(int(red["p_of_part"].max()) + 1) // LANES
                           // 8) * 8)
        # v4: the smallest padded stream size the shuffle geometry
        # accepts is 64 tiles (2-pass q1=16 needs region_tiles to
        # divide 128); sizes double from there. Pick the smallest that
        # fits Qp_need, then RE-SPREAD the quota so live data fills
        # the padded space uniformly (a junk tail concentrates the
        # downstream per-flow quotas and collapses kappa — measured
        # both in round 3 and again with the v4 compact attempt).
        s_pad = 64
        while (s_pad * LANES // pad_tiles // 8) * 8 < Qp_need \
                and s_pad < pad_tiles * (REDUCE_MAX_RUNS // LANES) // LANES:
            s_pad *= 2
        Qp = min(REDUCE_MAX_RUNS // LANES,
                 max(Qp_need, (s_pad * LANES // pad_tiles // 8) * 8))
        stream_tiles = pad_tiles * Qp // LANES
        s_pad = max(s_pad, -(-stream_tiles // 8) * 8)
        # Rank ties within a row are PSEUDO-RANDOM over (tile, p):
        # tile-order ties would hand each final tile a few consecutive
        # source tiles' chunks (a heavy row's ~70-128 partials per
        # tile stay rank-consecutive), skewing the per-flow quota
        # counts ~1.9x over the mean. Hashed ties make every rank
        # range draw Poisson-uniformly from the whole stream.
        t_of = red["tile_of_part"]
        tie = ((t_of.astype(np.uint64) * np.uint64(2654435761)
                + red["p_of_part"].astype(np.uint64) * np.uint64(40503))
               & np.uint64(0xFFFFFFFF))
        order = np.lexsort((tie, red["part_rows"]))
        rows_ranked = red["part_rows"][order]
        rank_of_part = np.empty(n_runs, np.int64)
        rank_of_part[order] = np.arange(n_runs)
        outslot = red["tile_of_part"] * (Qp * LANES) + red["p_of_part"]
        rank_of_slot = np.full(s_pad * TILE, -1, np.int64)
        rank_of_slot[outslot] = rank_of_part
        n_items = n_runs
        red["Qp"] = Qp
        red["out_rows"] = s_pad * LANES
    else:
        rank_of_slot = slot_src  # CSR order IS row-sorted rank order
        rows_ranked = row_ids
        n_items = nnz
    live = rank_of_slot >= 0

    verbose = bool(os.environ.get("SPMV_TPU_PLAN_VERBOSE"))

    def _log(msg):
        if verbose:
            print(f"[stream-plan +{_time.perf_counter()-_t0:.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    _t0 = _time.perf_counter()
    last_err: Optional[Exception] = None
    plan_sh = None
    walk = None
    # With early reduction the final tiles fill from a 5-20x smaller
    # partial stream packed into FEW source tiles; the final split
    # pass's per-flow quota cap (~(q_last-1)*128 through 8 region
    # content tiles, 15368/tile total) cannot feed 14336-deep tiles,
    # so cap kappa at 12288 (80% of the 8-flow cap; the step-
    # interleaved rank ties above keep flows near the mean).
    kap0 = policy.kappa if red is None else min(policy.kappa, 12288)
    kappas = [k for k in (kap0, 12288, 10240, 8192, 6144, 4096,
                          3072, 2048, 1024, 512, 256)
              if k <= kap0]
    ki = 0
    while ki < len(kappas):
        kappa = kappas[ki]
        ki += 1
        k_starts, bases, r_starts, lrows = _final_tile_walk(
            Ap, rows_ranked, kappa)
        F = k_starts.shape[0] - 1
        if F == 0:
            raise ValueError("empty matrix; handled by caller")
        sizes = np.diff(k_starts)
        ftile_of_rank = np.repeat(
            np.arange(F, dtype=np.int64), sizes)
        dst_of_rank = (ftile_of_rank * TILE + np.arange(n_items)
                       - np.repeat(k_starts[:-1], sizes))
        dst_pos = np.full(rank_of_slot.shape[0], -1, dtype=np.int64)
        dst_pos[live] = dst_of_rank[rank_of_slot[live]]

        try:
            plan_sh = plan_shuffle_auto(
                dst_pos, F, sbt=8,
                log=(lambda m: _log(f"kappa={kappa} {m}")))
        except ValueError as e:
            last_err = e
            plan_sh = None
            # Failed constraints that scale with tile fill report the
            # violation ratio; jump straight to a kappa that can pass
            # instead of stepping through ones that provably cannot.
            shrink = getattr(e, "shrink", None)
            if shrink and shrink > 1:
                target = kappa / shrink
                while ki < len(kappas) - 1 and kappas[ki] > target:
                    _log(f"kappa={kappas[ki]} skipped "
                         f"(needs <= {target:.0f})")
                    ki += 1

        if plan_sh is not None:
            _log(f"kappa={kappa} shuffle planned; scan planning")
            try:
                scan = _plan_scan(plan_sh, k_starts, bases, r_starts,
                                  lrows, rows_ranked)
            except ValueError as e:  # scan capacity: too many chunks
                last_err = e
                _log(f"kappa={kappa} scan plan failed: {e}")
                plan_sh = None
                continue
            walk = (k_starts, bases, r_starts, lrows)
            break
    if plan_sh is None:
        raise PlanCapacityError(f"shuffle planning failed: {last_err}")
    k_starts, bases, r_starts, lrows = walk
    F = k_starts.shape[0] - 1


    # pad scan tiles to a multiple of SBT_SCAN_MAX: padded tiles carry
    # junk cid (masked to identity); merge_idx never references them.
    # Padding to the max granule (not policy.scan_sbt) makes one plan
    # serve every divisor scan_sbt — autotune sweeps without re-planning
    F_pad = -(-F // SBT_SCAN_MAX) * SBT_SCAN_MAX
    pf = F_pad - F

    def padt(a, fill):
        if pf == 0:
            return a
        pad_shape = (pf,) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])

    scan = {
        "relid": padt(scan["relid"], 16384),
        "pm1": padt(scan["pm1"], 0), "pm2": padt(scan["pm2"], 0),
        "pm3": padt(scan["pm3"], 0),
        "r2s1": padt(scan["r2s1"], 0), "r2s2": padt(scan["r2s2"], 0),
        "r2s3": padt(scan["r2s3"], 0),
        "q2s1": padt(scan["q2s1"], 0), "q2s2": padt(scan["q2s2"], 0),
        "q2s3": padt(scan["q2s3"], 0),
        "valid2": padt(scan["valid2"], 0),
        "counts": padt(scan["counts"], 0),
    }

    # merge plan (v3): ragged-concat pieces + per-depth fixups.
    # Each final tile's y window covers y2d blocks [lo_f, hi_f]; a
    # block's FIRST contributor row joins a contiguous slice piece of
    # the flat ycand array, uncovered blocks
    # become identity-fill pieces, and the rare extra contributors
    # (window overlaps at tile boundaries / hub rows; 26/8192 blocks
    # on the bench matrix) are applied afterwards as per-depth
    # distinct-row semiring fixups (the decoupled-lookback analog,
    # ref: merge_based/agent_segment_fixup.cuh).
    P = BIN_ROWS // LANES
    NBY = -(-A.n_rows // LANES)
    fb = (bases // LANES).astype(np.int64)
    lo = (r_starts.astype(np.int64) // LANES)
    hi = (lrows.astype(np.int64) // LANES)
    primary = np.full(NBY, -1, dtype=np.int64)  # ycand row per block
    extras: list = [[] for _ in range(NBY)]
    for f in range(F):
        for b2 in range(int(lo[f]), int(hi[f]) + 1):
            r = f * P + int(b2 - fb[f])
            if primary[b2] < 0:
                primary[b2] = r
            else:
                extras[b2].append(r)
    # uniform row-gather source (used instead of the ragged concat
    # when the piece count would degenerate into per-tile slivers)
    merge_src = np.where(primary >= 0, primary,
                         F_pad * P).astype(np.int32)
    # maximal pieces: consecutive blocks with consecutive primary rows
    m_kind: list = []  # 0 = ycand slice, 1 = identity fill
    m_a: list = []     # slice start row (kind 0) or 0
    m_len: list = []
    b2 = 0
    while b2 < NBY:
        if primary[b2] < 0:
            j = b2
            while j < NBY and primary[j] < 0:
                j += 1
            m_kind.append(1); m_a.append(0); m_len.append(j - b2)
        else:
            j = b2
            while (j + 1 < NBY and primary[j + 1] == primary[j] + 1):
                j += 1
            m_kind.append(0); m_a.append(int(primary[b2]))
            m_len.append(j - b2 + 1)
            j += 1
        b2 = j if m_kind[-1] == 1 else j
    depth = max((len(e) for e in extras), default=0)
    fix_levels = []
    for d in range(depth):
        outs = [b3 for b3 in range(NBY) if len(extras[b3]) > d]
        srcs = [extras[b3][d] for b3 in outs]
        fix_levels.append((np.asarray(outs, np.int32),
                           np.asarray(srcs, np.int32)))
    Ax_slots = np.where(slot_src >= 0, Ax[np.clip(slot_src, 0, nnz - 1)], 0)

    _log("host planning done")
    gather = {
        "Ax": Ax_slots.astype(Ax.dtype).reshape(-1, LANES),
        "q": slot_q.reshape(-1, LANES),
        "xb": xb,
    }
    if red is not None and red.get("xroute") is not None:
        xr = red["xroute"]
        n_w_live = xr.shape[0]
        pad_w = x_blocks_pad - n_w_live
        if pad_w:
            xr = np.concatenate(
                [xr, np.full((pad_w, LANES, LANES), -1, np.int32)])
        xr1, xr2, xr3 = route_tiles(xr, dedupe=False)
        g0p = np.zeros(x_blocks_pad, np.int32)
        g0p[:n_w_live] = red["g0"].astype(np.int32)
        gather["xr1"] = xr1.reshape(-1, LANES)
        gather["xr2"] = xr2.reshape(-1, LANES)
        gather["xr3"] = xr3.reshape(-1, LANES)
        gather["g0"] = g0p
        gather["x_nat_rows"] = int(red["x_nat_rows"])
    reduce = None
    if red is not None:
        c1, c2, c3 = route_tiles(red["src_route"], dedupe=False)
        # the sublane-first-run mask rides the high bit of the final
        # route stage (lane indexes use 7 bits)
        HR = REDUCE_MAX_RUNS // LANES
        c3 = c3.copy()
        c3[:, :HR, :] |= (red["firstmask"].astype(np.uint8) << 7)
        reduce = {
            "c1": c1.reshape(-1, LANES),
            "c2": c2.reshape(-1, LANES),
            "c3": c3.reshape(-1, LANES),
            "rs": red["runstart"].reshape(-1, LANES),
            "Qp": int(red["Qp"]),
            "out_rows": int(red["out_rows"]),
        }
    scan_arrays = {
        k: scan[k].reshape(-1, LANES)
        for k in ("relid", "pm1", "pm2", "pm3",
                  "r2s1", "r2s2", "r2s3",
                  "q2s1", "q2s2", "q2s3", "valid2")
    }
    scan_arrays.update({
        "counts": scan["counts"],
        "m_kind": np.asarray(m_kind, np.int32),
        "m_a": np.asarray(m_a, np.int32),
        "m_len": np.asarray(m_len, np.int32),
        "merge_src": merge_src,
        **{f"fx{d}_{h}": arr
           for d, pair in enumerate(fix_levels)
           for h, arr in zip(("out", "src"), pair)},
    })
    return StreamPlan(
        n_gather_tiles=pad_tiles, n_final_tiles=F, layers=1,
        x_rows_pad=x_rows_pad, hot_cols=hot_cols.astype(np.int32),
        gather=gather, shuffle=plan_sh,
        shuffle_dev=shuffle_device_arrays(plan_sh),
        scan=scan_arrays, n_y_blocks=NBY, reduce=reduce)


# ---------------------------------------------------------------------------
# Kernels: each wrapper runs its plain PyTorch version on a CPU tensor and
# launches its CUDA kernel (csrc/stream_kernels.cu) on a CUDA tensor, or
# raises; `<wrapper>.launches` counts kernel launches.
# ---------------------------------------------------------------------------

def _device_of(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _xprep_plain(xnat, g0, xr1, xr2, xr3, *, n_w):
    """Plain version of K1: for each window w, rows [g0[w], g0[w]+128)
    of the natural x table (x_nat_rows, 128), routed by xr*[w]."""
    rows = g0.long()[:, None] + torch.arange(LANES, device=xnat.device)
    return route3_batched(xnat[rows].reshape(n_w * LANES, LANES),
                          xr1, xr2, xr3)


def _xprep_pass(xnat, g0, xr1, xr2, xr3, *, n_w):
    """K1: the lane-remapped transposed x table, (n_w*128, 128)."""
    dev = _device_of(xnat, "_xprep_pass")
    if dev.type == "cpu":
        return _xprep_plain(xnat, g0, xr1, xr2, xr3, n_w=n_w)
    if xnat.dim() != 2 or xnat.shape[1] != LANES or xnat.shape[0] < LANES:
        raise ValueError(f"xnat: shape {tuple(xnat.shape)}, expected "
                         f"(>= 128, 128)")
    _cuda.expect(xnat, "xnat", torch.float32, tuple(xnat.shape), dev)
    _cuda.expect(g0, "g0", torch.int32, (n_w,), dev)
    for name, s in (("xr1", xr1), ("xr2", xr2), ("xr3", xr3)):
        _cuda.expect(s, name, torch.uint8, (n_w * LANES, LANES), dev)
    out = torch.empty((n_w * LANES, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_xprep(
        _cuda.ptr(xnat), _cuda.ptr(g0), _cuda.ptr(xr1), _cuda.ptr(xr2),
        _cuda.ptr(xr3), _cuda.ptr(out), n_w, _cuda.stream(dev))
    _cuda.check(rc, "spmv_xprep")
    _xprep_pass.launches += 1
    return out


_xprep_pass.launches = 0


def _identity(sr: Semiring, dtype: torch.dtype) -> float:
    return float(sr.identity_for(torch.empty(0, dtype=dtype).numpy().dtype))


def _is_diff_ring(sr: Semiring) -> bool:
    """Rings whose sums the prefix-difference bodies (K2, K6) carry:
    plus-times and the or-and counting ring, matched by identity."""
    return sr is PLUS_TIMES or sr is OR_AND_COUNTING


def _gather_plain(x2d, ax, q, xb, *, sr, n_tiles):
    """Plain version of K4: per gather tile t and slot (s, l),
    combine(Ax, x2d[xb[t]*128 + s, q]) in gather order, the ring's
    identity where q < 0 (q is clamped before it indexes)."""
    xw = x2d.reshape(-1, LANES, LANES)[xb.long()]
    q3 = q.reshape(n_tiles, LANES, LANES).long()
    xg = torch.gather(xw, 2, q3.clamp(min=0))
    prod = sr.combine(ax.reshape(n_tiles, LANES, LANES), xg)
    return torch.where(q3 >= 0, prod, _identity(sr, x2d.dtype)).reshape(-1, LANES)


def _check_gather_args(x2d, ax, q, xb, n_tiles, dev):
    rows = n_tiles * LANES
    if x2d.dim() != 2 or x2d.shape[1] != LANES or x2d.shape[0] % LANES:
        raise ValueError(f"x2d: shape {tuple(x2d.shape)}, expected whole "
                         f"(128,128) windows")
    _cuda.expect(x2d, "x2d", torch.float32, tuple(x2d.shape), dev)
    _cuda.expect(ax, "ax", torch.float32, (rows, LANES), dev)
    _cuda.expect(q, "q", torch.int8, (rows, LANES), dev)
    _cuda.expect(xb, "xb", torch.int32, (n_tiles,), dev)


def _gather_pass(x2d, ax, q, xb, *, sr, n_tiles):
    """K4: gather + products in gather order, (n_tiles*128, 128)."""
    dev = _device_of(x2d, "_gather_pass")
    if dev.type == "cpu":
        return _gather_plain(x2d, ax, q, xb, sr=sr, n_tiles=n_tiles)
    ring = device_ring_code(sr)
    _check_gather_args(x2d, ax, q, xb, n_tiles, dev)
    out = torch.empty((n_tiles * LANES, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_gather(
        _cuda.ptr(x2d), _cuda.ptr(ax), _cuda.ptr(q), _cuda.ptr(xb),
        _cuda.ptr(out), n_tiles, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_gather")
    _gather_pass.launches += 1
    return out


_gather_pass.launches = 0


def _gather_split_plain(x2d, ax, q, xb, s1, s2, s3, starts, pos, *, sr, sbt,
                        n_tiles, K, Q, rows_per_g):
    """Plain version of K3: K4's plain version followed by K5's, the
    rows no quota window covers holding the ring's identity."""
    prod = _gather_plain(x2d, ax, q, xb, sr=sr, n_tiles=n_tiles)
    return _split_plain(prod, s1, s2, s3, starts, pos, n_steps=n_tiles // sbt,
                        sbt=sbt, K=K, Q=Q, rows_per_g=rows_per_g,
                        fill=_identity(sr, x2d.dtype))


def _gather_split_pass(x2d, ax, q, xb, s1, s2, s3, starts, pos, *, sr, sbt,
                       n_tiles, K, Q, rows_per_g, gaps):
    """K3: gather + products fused with shuffle pass 1 ->
    (K, rows_per_g, 128). `gaps` are the rows no quota window covers
    (the pass's `gap_rows`); they get the ring's identity."""
    dev = _device_of(x2d, "_gather_split_pass")
    if dev.type == "cpu":
        return _gather_split_plain(x2d, ax, q, xb, s1, s2, s3, starts, pos,
                                   sr=sr, sbt=sbt, n_tiles=n_tiles, K=K, Q=Q,
                                   rows_per_g=rows_per_g)
    ring = device_ring_code(sr)
    n_steps = n_tiles // sbt
    if n_steps * sbt != n_tiles:
        raise ValueError(f"n_tiles={n_tiles} is not a multiple of sbt={sbt}")
    _check_gather_args(x2d, ax, q, xb, n_tiles, dev)
    for name, s in (("s1", s1), ("s2", s2), ("s3", s3)):
        _cuda.expect(s, name, torch.uint8, (n_tiles * LANES, LANES), dev)
    if starts.dim() != 2 or starts.shape[0] < n_steps or \
            starts.shape[1] < sbt * K:
        raise ValueError(f"starts: shape {tuple(starts.shape)} does not "
                         f"cover {n_steps} steps x {sbt * K} windows")
    _cuda.expect(starts, "starts", torch.int32, tuple(starts.shape), dev)
    _cuda.expect(pos, "pos", torch.int32, (n_steps,), dev)
    _cuda.expect(gaps, "gaps", torch.int64, (gaps.numel(),), dev)
    out = torch.empty((K, rows_per_g, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_gather_split(
        _cuda.ptr(x2d), _cuda.ptr(ax), _cuda.ptr(q), _cuda.ptr(xb),
        _cuda.ptr(s1), _cuda.ptr(s2), _cuda.ptr(s3), _cuda.ptr(starts),
        starts.shape[1], _cuda.ptr(pos), _cuda.ptr(out), n_steps, sbt, K, Q,
        rows_per_g, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_gather_split")
    _gather_split_pass.launches += 1
    if gaps.numel():
        out.index_fill_(1, gaps, _identity(sr, x2d.dtype))
    return out


_gather_split_pass.launches = 0


def _reduce_diff_plain(x2d, ax, q, xb, c1, c2, c3, *, sr, n_tiles, Qp,
                       out_rows):
    """Plain version of K2: per gather tile, products, an inclusive
    prefix along each 128-lane row, the C route of the run-end
    prefixes, and C[i] - C[i-1] in flat order (the predecessor zeroed
    where c3 bit 7 marks a sublane-first run; flat index 0 has none).
    The first Qp rows of each tile land at rows [t*Qp, (t+1)*Qp); rows
    past n_tiles*Qp are 0, the identity of both rings K2 carries."""
    gt = n_tiles
    prod = _gather_plain(x2d, ax, q, xb, sr=sr, n_tiles=n_tiles)
    S = prod.reshape(gt, LANES, LANES).cumsum(2).reshape(-1, LANES)
    c3i = c3.to(torch.int32)
    routed = route3_batched(S, c1, c2, c3i & 127)
    C = routed.reshape(gt, LANES, LANES)[:, :Qp].reshape(gt, Qp * LANES)
    first = (c3i >> 7).reshape(gt, LANES, LANES)[:, :Qp].reshape(gt, Qp * LANES)
    prev = torch.zeros_like(C)
    prev[:, 1:] = C[:, :-1]
    part = C - prev.masked_fill(first > 0, 0.0)
    out = torch.zeros((out_rows, LANES), dtype=x2d.dtype, device=x2d.device)
    out[:gt * Qp] = part.reshape(gt * Qp, LANES)
    return out


def _check_reduce_args(x2d, ax, q, xb, c1, c2, c3, n_tiles, Qp, out_rows,
                       dev):
    if not 0 < Qp <= REDUCE_MAX_RUNS // LANES or n_tiles * Qp > out_rows:
        raise ValueError(f"Qp={Qp}, out_rows={out_rows} do not fit "
                         f"{n_tiles} tiles")
    _check_gather_args(x2d, ax, q, xb, n_tiles, dev)
    for name, s in (("c1", c1), ("c2", c2), ("c3", c3)):
        _cuda.expect(s, name, torch.uint8, (n_tiles * LANES, LANES), dev)


def _reduce_diff_pass(x2d, ax, q, xb, c1, c2, c3, *, sr, n_tiles, Qp,
                      out_rows):
    """K2: gather + early row reduction, prefix-difference body (`sr` is
    PLUS_TIMES or the or-and counting ring) -> (out_rows, 128)."""
    if not _is_diff_ring(sr):
        raise ValueError(f"K2 carries plus-times and the or-and counting "
                         f"ring only, not {sr.name!r}; _reduce_pass picks K7")
    dev = _device_of(x2d, "_reduce_diff_pass")
    if dev.type == "cpu":
        return _reduce_diff_plain(x2d, ax, q, xb, c1, c2, c3, sr=sr,
                                  n_tiles=n_tiles, Qp=Qp, out_rows=out_rows)
    _check_reduce_args(x2d, ax, q, xb, c1, c2, c3, n_tiles, Qp, out_rows, dev)
    out = torch.empty((out_rows, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_reduce(
        _cuda.ptr(x2d), _cuda.ptr(ax), _cuda.ptr(q), _cuda.ptr(xb),
        _cuda.ptr(c1), _cuda.ptr(c2), _cuda.ptr(c3), _cuda.ptr(out),
        n_tiles, Qp, 1 if sr is OR_AND_COUNTING else 0, _cuda.stream(dev))
    _cuda.check(rc, "spmv_reduce")
    _reduce_diff_pass.launches += 1
    out[n_tiles * Qp:].zero_()  # rows the reference leaves unwritten
    return out


_reduce_diff_pass.launches = 0


def _reduce_roll_plain(x2d, ax, q, xb, c1, c2, c3, rs, *, sr, n_tiles, Qp,
                       out_rows):
    """Plain version of K7: per gather tile, products (the identity
    where q < 0), an inclusive segmented scan along each 128-lane row
    restarting where `rs` flags a run start, and the C route of the
    scan, whose value at each run end is the run's total. The first Qp
    rows of each tile land at rows [t*Qp, (t+1)*Qp); rows past
    n_tiles*Qp hold the ring's identity."""
    ident = _identity(sr, x2d.dtype)
    prod = _gather_plain(x2d, ax, q, xb, sr=sr, n_tiles=n_tiles)
    scan = segmented_scan_lanes(prod, rs, sr.reduce)
    routed = route3_batched(scan, c1, c2, c3.to(torch.int32) & 127)
    part = routed.reshape(n_tiles, LANES, LANES)[:, :Qp]
    out = torch.full((out_rows, LANES), ident, dtype=x2d.dtype,
                     device=x2d.device)
    out[:n_tiles * Qp] = part.reshape(n_tiles * Qp, LANES)
    return out


def _reduce_roll_pass(x2d, ax, q, xb, c1, c2, c3, rs, *, sr, n_tiles, Qp,
                      out_rows):
    """K7: gather + early row reduction, generic-ring body (segmented
    lane scan, no inverse) -> (out_rows, 128). On the card it takes the
    rings `_reduce_pass` sends it: min-plus, max-times and or-and."""
    dev = _device_of(x2d, "_reduce_roll_pass")
    if dev.type == "cpu":
        return _reduce_roll_plain(x2d, ax, q, xb, c1, c2, c3, rs, sr=sr,
                                  n_tiles=n_tiles, Qp=Qp, out_rows=out_rows)
    ring = device_ring_code(sr)
    if _is_diff_ring(sr):
        raise ValueError(f"K7 is built for the min, max and or-and rings, not "
                         f"{sr.name!r}; _reduce_pass picks K2 for it")
    _check_reduce_args(x2d, ax, q, xb, c1, c2, c3, n_tiles, Qp, out_rows, dev)
    _cuda.expect(rs, "rs", torch.int8, (n_tiles * LANES, LANES), dev)
    out = torch.empty((out_rows, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_reduce_roll(
        _cuda.ptr(x2d), _cuda.ptr(ax), _cuda.ptr(q), _cuda.ptr(xb),
        _cuda.ptr(c1), _cuda.ptr(c2), _cuda.ptr(c3), _cuda.ptr(rs),
        _cuda.ptr(out), n_tiles, Qp, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_reduce_roll")
    _reduce_roll_pass.launches += 1
    out[n_tiles * Qp:].fill_(_identity(sr, x2d.dtype))
    return out


_reduce_roll_pass.launches = 0


def _reduce_pass(x2d, ax, q, xb, c1, c2, c3, rs=None, *, sr, n_tiles, Qp,
                 out_rows):
    """Pass 0 of the reduced pipeline, as the reference picks its body
    (spmv_tpu/kernels/stream.py:1318): K2 for plus-times and the or-and
    counting ring, K7 (which reads the run starts `rs`) otherwise."""
    kw = dict(sr=sr, n_tiles=n_tiles, Qp=Qp, out_rows=out_rows)
    if _is_diff_ring(sr):
        return _reduce_diff_pass(x2d, ax, q, xb, c1, c2, c3, **kw)
    if rs is None:
        raise ValueError(f"_reduce_pass: ring {sr.name!r} needs the run "
                         f"starts rs")
    return _reduce_roll_pass(x2d, ax, q, xb, c1, c2, c3, rs, **kw)


def _scan_diff_plain(prod_fin, pm1, pm2, pm3, r2s1, r2s2, r2s3,
                     q2s1, q2s2, q2s3, valid2, counts, *, F_pad):
    """Plain version of K6: per final tile, the exact-rank route, the
    positions outside [1, counts[f]] zeroed, one flat inclusive prefix
    of the 16384 values (accumulated in float64, as the kernel does),
    the END and PREV prefix routes, and ends - prevs where valid2."""
    dev = prod_fin.device
    v = route3_batched(prod_fin, pm1, pm2, pm3)
    pos = flat_iota((LANES, LANES), dev).repeat(F_pad, 1)
    m = counts.long().repeat_interleave(LANES)[:, None]
    ve = torch.where((pos >= 1) & (pos <= m), v, torch.zeros_like(v))
    S = flat_cumsum_tiles(ve, dtype=torch.float64)
    ends = route3_batched(S, r2s1, r2s2, r2s3)
    prevs = route3_batched(S, q2s1, q2s2, q2s3)
    y = (ends - prevs).to(prod_fin.dtype)
    return torch.where(valid2 > 0, y, torch.zeros_like(y))


def _check_scan_args(prod_fin, routes, valid2, F_pad, dev):
    rows = F_pad * LANES
    _cuda.expect(prod_fin, "prod_fin", torch.float32, (rows, LANES), dev)
    for name, s in routes:
        _cuda.expect(s, name, torch.uint8, (rows, LANES), dev)
    _cuda.expect(valid2, "valid2", torch.int8, (rows, LANES), dev)


def _scan_diff_pass(prod_fin, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2,
                    q2s3, valid2, counts, *, F_pad):
    """K6: prefix-difference scan over final tiles, each writing its
    (128,128) y-candidate window to a flat (F_pad*128, 128) array."""
    dev = _device_of(prod_fin, "_scan_diff_pass")
    args = (prod_fin, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2, q2s3,
            valid2, counts)
    if dev.type == "cpu":
        return _scan_diff_plain(*args, F_pad=F_pad)
    _check_scan_args(prod_fin, zip(("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3",
                                    "q2s1", "q2s2", "q2s3"), args[1:10]),
                     valid2, F_pad, dev)
    _cuda.expect(counts, "counts", torch.int32, (F_pad,), dev)
    out = torch.empty((F_pad * LANES, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_scan_diff(*[_cuda.ptr(a) for a in args],
                                    _cuda.ptr(out), F_pad, _cuda.stream(dev))
    _cuda.check(rc, "spmv_scan_diff")
    _scan_diff_pass.launches += 1
    return out


_scan_diff_pass.launches = 0


def _scan_roll_plain(prod_fin, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3, valid2,
                     *, sr, F_pad):
    """Plain version of K8: per final tile, the exact-rank route, the
    identity where relid >= 16384 (junk), an inclusive segmented scan
    of the tile's 16384 values in row-major order keyed by
    relid & 16383, the END route, and the identity where not valid2."""
    ident = _identity(sr, prod_fin.dtype)
    rel = relid.to(torch.int32)
    v = route3_batched(prod_fin, pm1, pm2, pm3)
    v = torch.where(rel < TILE, v, ident)
    scan = segmented_scan_tile(v.reshape(F_pad, LANES, LANES),
                               (rel & (TILE - 1)).reshape(F_pad, LANES, LANES),
                               sr.reduce).reshape(-1, LANES)
    y = route3_batched(scan, r2s1, r2s2, r2s3)
    return torch.where(valid2 > 0, y, ident)


def _scan_roll_pass(prod_fin, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3, valid2,
                    *, sr, F_pad):
    """K8: generic-ring scan over final tiles (segmented, no inverse),
    each writing its y-candidate window to a flat (F_pad*128, 128)
    array."""
    dev = _device_of(prod_fin, "_scan_roll_pass")
    args = (prod_fin, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3, valid2)
    if dev.type == "cpu":
        return _scan_roll_plain(*args, sr=sr, F_pad=F_pad)
    ring = device_ring_code(sr)
    _check_scan_args(prod_fin, (("pm1", pm1), ("pm2", pm2), ("pm3", pm3),
                                ("r2s1", r2s1), ("r2s2", r2s2), ("r2s3", r2s3)),
                     valid2, F_pad, dev)
    _cuda.expect(relid, "relid", torch.int16, (F_pad * LANES, LANES), dev)
    out = torch.empty((F_pad * LANES, LANES), dtype=torch.float32, device=dev)
    rc = _cuda.lib().spmv_scan_roll(*[_cuda.ptr(a) for a in args],
                                    _cuda.ptr(out), F_pad, ring,
                                    _cuda.stream(dev))
    _cuda.check(rc, "spmv_scan_roll")
    _scan_roll_pass.launches += 1
    return out


_scan_roll_pass.launches = 0


def _scan_pass(prod_fin, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2,
               q2s3, valid2, counts, *, sr, F_pad, strategy="auto"):
    """Scan over final tiles, as the reference picks its body
    (spmv_tpu/kernels/stream.py:1610): K6 for strategy "auto" with
    plus-times or the or-and counting ring, K8 otherwise ("roll" takes
    K8 for plus-times too)."""
    if strategy == "auto" and _is_diff_ring(sr):
        return _scan_diff_pass(prod_fin, pm1, pm2, pm3, r2s1, r2s2, r2s3,
                               q2s1, q2s2, q2s3, valid2, counts, F_pad=F_pad)
    return _scan_roll_pass(prod_fin, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3,
                           valid2, sr=sr, F_pad=F_pad)


# ---------------------------------------------------------------------------
# Glue (plain torch, as the reference's was plain XLA)
# ---------------------------------------------------------------------------

def _merge_gather(ycand, merge_src, fix, sr: Semiring):
    """Assemble y from the per-tile y windows: one row gather from the
    flat window array (an identity row appended for blocks no tile
    touches), then per-depth fixups that fold the extra contributors
    (window overlaps at tile boundaries, hub rows) into distinct rows."""
    ident = float(sr.identity_for(np.float32))
    ycp = torch.cat([ycand, ycand.new_full((1, LANES), ident)])
    y2d = ycp.index_select(0, merge_src.long())
    for out_i, src_i in fix:
        out_i = out_i.long()
        upd = sr.reduce(y2d.index_select(0, out_i),
                        ycp.index_select(0, src_i.long()))
        y2d.index_copy_(0, out_i, upd)
    return y2d.reshape(-1)


def _x_table(plan: StreamPlan, xv: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The gather's x table for x = xv (plan on xv's device): K1 routes
    natural x into the remapped transposed layout; without the remap a
    plain per-window transpose (glue). Hot-column pages (each value
    broadcast down its lane) follow."""
    g = plan.gather
    if "xr1" in g:
        xnat = torch.nn.functional.pad(xv, (0, g["x_nat_rows"] * LANES - n_cols))
        x2d = _xprep_pass(xnat.reshape(-1, LANES), g["g0"], g["xr1"],
                          g["xr2"], g["xr3"], n_w=plan.x_rows_pad // LANES)
    else:
        xp = torch.nn.functional.pad(xv, (0, plan.x_rows_pad * LANES - n_cols))
        x2d = xp.reshape(-1, LANES, LANES).transpose(1, 2).reshape(-1, LANES)
    n_aug = int(plan.hot_cols.shape[0])
    if n_aug:
        hot_x = xv.index_select(0, plan.hot_cols)
        aug = hot_x.reshape(-1, 1, LANES).expand(
            n_aug // LANES, LANES, LANES).reshape(-1, LANES)
        x2d = torch.cat([x2d, aug], dim=0)
    return x2d.contiguous()


def plan_cache_key(policy: StreamPolicy) -> tuple:
    """In-memory plan-cache key: structural policy fields only."""
    return ("stream",) + tuple(sorted(policy.structural_fields().items()))


# Row-band execution past the shuffle planner's reach: one plan's
# gather stream caps at 16384 tiles (~240M nnz). Banding cuts the
# matrix into row-aligned slices of at most BAND_NNZ nonzeros, runs the
# whole pipeline per band (each with its own cached plan) and
# concatenates y; row-aligned cuts need no cross-band fixup.
BAND_NNZ = 180_000_000


def _cut_bands(A: CSR, band_nnz: int) -> list:
    """Row-aligned band CSRs of at most ~band_nnz nonzeros each."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    nnz = int(Ap[-1])
    n_bands = max(2, -(-nnz // band_nnz))
    targets = (np.arange(1, n_bands, dtype=np.int64) * nnz) // n_bands
    cuts = np.searchsorted(Ap, targets, side="left")
    bounds = np.concatenate([[0], cuts, [A.n_rows]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)
    Aj = np.asarray(A.Aj)
    Ax = np.asarray(A.Ax)
    bands = []
    for b in range(n_bands):
        r0, r1 = int(bounds[b]), int(bounds[b + 1])
        if r1 <= r0:
            bands.append(None)
            continue
        k0, k1 = int(Ap[r0]), int(Ap[r1])
        bands.append(CSR(r1 - r0, A.n_cols, (Ap[r0:r1 + 1] - k0),
                         Aj[k0:k1], Ax[k0:k1]))
    return bands


def _stream_spmv_banded(A: CSR, x, semiring: Semiring,
                        policy: StreamPolicy, band_nnz: int):
    # Bands are cached ON THE PARENT matrix: plan_cache keys on CSR
    # identity, so rebuilding bands per call would re-plan every band.
    bands = plan_cache(A, ("stream", "bands", band_nnz),
                       lambda: _cut_bands(A, band_nnz))
    ys = []
    for band in bands:
        if band is None:
            ys.append(x.new_empty((0,)))
            continue
        # band=False: a hub row larger than the band budget cannot be
        # cut at a row boundary; it runs through the planner anyway
        ys.append(_stream_spmv(band, x, semiring, policy, band=False))
    return torch.cat(ys)


def _stream_spmv(A: CSR, x: torch.Tensor, semiring: Semiring,
                 policy: StreamPolicy, band: bool = True) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    val_dtype = resolve_val_dtype(A, x)
    ident = float(semiring.identity_for(val_dtype))
    tdtype = torch.from_numpy(np.zeros(0, val_dtype)).dtype
    dev = x.device
    if A.nnz == 0 or A.n_cols == 0:
        return torch.full((A.n_rows,), ident, dtype=tdtype, device=dev)
    if band and A.nnz > BAND_NNZ:
        return _stream_spmv_banded(A, x, semiring, policy, BAND_NNZ)
    if semiring is OR_AND and tdtype == torch.float32:
        # Boolean ring on the plus-times kernels: counts of {0,1}
        # products, thresholded (exact while a row's count < 2^24)
        y_cnt = _stream_spmv(A, x, OR_AND_COUNTING, policy, band=band)
        return (y_cnt > 0).to(y_cnt.dtype)
    if tdtype != torch.float32:
        raise NotImplementedError(
            f"stream: {tdtype} values are not ported yet: the CUDA kernels are "
            f"instantiated for float32 only")

    def _build():
        pdir = config.plan_dir()
        if pdir:
            from spmv_tpu_torch.utils.plancache import stream_plan_cached

            return stream_plan_cached(A, policy, pdir)
        return build_stream_plan(A, policy)

    if SBT_SCAN_MAX % policy.scan_sbt != 0:
        raise ValueError(
            f"scan_sbt must divide {SBT_SCAN_MAX}; got {policy.scan_sbt}")
    key = plan_cache_key(policy)
    host_plan: StreamPlan = plan_cache(A, key, _build)
    plan: StreamPlan = plan_cache(A, key + (str(dev),),
                                  lambda: host_plan.to(dev))

    x2d = _x_table(plan, x.to(tdtype), A.n_cols)
    g = plan.gather

    # --- gather, by the plan's branch (the reference's :1827-1860)
    ax = g["Ax"].to(tdtype)
    gt = plan.n_gather_tiles
    passes, sdev = plan.shuffle.passes, plan.shuffle_dev
    p0 = passes[0]
    if plan.reduce is not None:
        rd = plan.reduce
        part = _reduce_pass(
            x2d, ax, g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"],
            sr=semiring, n_tiles=gt, Qp=rd["Qp"], out_rows=rd["out_rows"])
        prod_fin = apply_shuffle(part, passes, sdev, fill=ident)
    elif p0.sbt == 8 and p0.n_steps * 8 == gt:
        # fused gather + split 1: products never round-trip memory
        d0 = sdev[0]
        prod_fin = _gather_split_pass(
            x2d, ax, g["q"], g["xb"], d0["s1"], d0["s2"], d0["s3"],
            d0["starts"], d0["pos"], sr=semiring, sbt=8, n_tiles=gt, K=p0.K,
            Q=p0.Q, rows_per_g=p0.out_rows // p0.K, gaps=d0["gaps"]
        ).reshape(p0.out_rows, LANES)
        prod_fin = apply_shuffle(prod_fin, passes[1:], sdev[1:], fill=ident)
    else:
        prod = _gather_pass(x2d, ax, g["q"], g["xb"], sr=semiring, n_tiles=gt)
        prod_fin = apply_shuffle(prod, passes, sdev, fill=ident)
    sc = plan.scan
    F_pad = sc["counts"].shape[0]
    # the shuffle's own final-tile padding may give it more or fewer
    # rows than the scan's F_pad tiles; the scan reads exactly F_pad
    if prod_fin.shape[0] < F_pad * LANES:
        prod_fin = torch.nn.functional.pad(
            prod_fin, (0, 0, 0, F_pad * LANES - prod_fin.shape[0]),
            value=ident)
    prod_fin = prod_fin[:F_pad * LANES]
    ycand = _scan_pass(
        prod_fin.contiguous(), sc["relid"], sc["pm1"], sc["pm2"], sc["pm3"],
        sc["r2s1"], sc["r2s2"], sc["r2s3"], sc["q2s1"], sc["q2s2"],
        sc["q2s3"], sc["valid2"], sc["counts"], sr=semiring, F_pad=F_pad,
        strategy=policy.scan_strategy)

    fix = []
    while f"fx{len(fix)}_out" in sc:
        d = len(fix)
        fix.append((sc[f"fx{d}_out"], sc[f"fx{d}_src"]))
    y = _merge_gather(ycand, sc["merge_src"], fix, semiring)[: A.n_rows]
    # the oracle's acc = initialize() takes part in every row: fold it in
    return semiring.reduce(y, torch.full_like(y, ident))


def audit_plan(plan: StreamPlan, nnz: int, val_bytes: int = 4) -> dict:
    """Bytes-moved audit per pass of the reference pipeline (every
    stream it reads or writes), reduced to bytes/nnz. This is the
    reference design's byte model (its x table counts once when it fits
    the reference's on-chip budget); it is a plan property, not a
    measurement."""
    LB = LANES
    gt = plan.n_gather_tiles
    F_pad = int(plan.scan["counts"].shape[0])
    p0 = plan.shuffle.passes[0]
    fused01 = p0.sbt == 8 and p0.n_steps * 8 == gt
    x_rows = plan.x_rows_pad + int(plan.hot_cols.shape[0])
    x_bytes = x_rows * LB * val_bytes
    if x_bytes > X_VMEM_MAX_BYTES:
        x_bytes = gt * TILE * val_bytes
    passes = {}
    if "xr1" in plan.gather:
        # read natural x + 3 route streams, write the remapped table
        passes["xprep"] = plan.x_rows_pad * LB * (2 * val_bytes + 3)
    if plan.reduce is not None:
        # Ax + q + x + 3 route stages, writing Qp partial rows per tile
        passes["reduce"] = int(
            gt * TILE * (val_bytes + 1 + 3) + x_bytes
            + gt * plan.reduce["Qp"] * LANES * val_bytes)
    else:
        passes["gather"] = gt * TILE * (val_bytes + 1) + x_bytes \
            + (0 if fused01 else gt * TILE * val_bytes)
    for i, p in enumerate(plan.shuffle.passes):
        rows = p.n_steps * p.sbt * LB
        rw = val_bytes if (i == 0 and fused01) else 2 * val_bytes
        passes[f"split{i}"] = (rows * LB * (rw + 3) + p.starts.size * 4)
    # perm (3) + END/PREV routes (3+3) + valid2 (1)
    scan_aux = 3 + 3 + 3 + 1
    passes["scan"] = int(F_pad * TILE * (val_bytes + scan_aux)
                         + F_pad * BIN_ROWS * val_bytes)
    n_fix_rows = sum(int(plan.scan[k].shape[0])
                     for k in plan.scan if str(k).startswith("fx")) // 2
    passes["merge"] = int((2 * plan.n_y_blocks + 3 * n_fix_rows)
                          * LB * val_bytes)
    total = sum(passes.values())
    return {
        "per_pass_bytes": passes,
        "per_pass_bytes_per_nnz": {k: v / max(nnz, 1)
                                   for k, v in passes.items()},
        "total_bytes": total,
        "bytes_per_nnz": total / max(nnz, 1),
    }


@register("stream", supports_semiring=True,
          reference_analog="spmv_tpu kind 'stream' (gather + planned "
                           "shuffle + scan)")
def _stream(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Stream-SpMV: x prep, gather (with early reduction where the plan
    has it), planned shuffle, scan, window merge. The policy comes from the tuning layer for the
    device of x (ops/tuning.py)."""
    from spmv_tpu_torch.ops.tuning import detect_chip, policy_for

    width = np.dtype(np.asarray(A.Ax).dtype).itemsize
    return _stream_spmv(A, x, semiring, policy_for(width, detect_chip(x.device)))
