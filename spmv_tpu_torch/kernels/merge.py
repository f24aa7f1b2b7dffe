"""Merge-path SpMV: the merge kinds, and `merge_tiled` with its kernel K10.

Counterpart of `spmv_tpu/kernels/merge.py`. The reference runs `merge`,
`merge_stock` and `merge_genl` on the stream pipeline with its own
equal-nnz tile sizes (kappa), and falls back to the direct tiled path,
`merge_tiled`, past the stream planner's reach (:584-595). So does the
port, with a `FallbackWarning`.

`merge_tiled` runs on a merge plan: the host cuts the nonzeros greedily
into tiles of at most EN nonzeros (`nnz_per_tile`) spanning at most RW
rows (`rows_per_tile`); S = EN/128 and P = RW/128, and one group holds
sbt = 128/S tiles, a (128, 128) block of products. `build_merge_plan` is
the reference's, copied (NumPy plus the native tile walk): it emits the
same arrays, bit for bit, native on and off (tests/test_torch_merge_tiled.py),
as NumPy; `MergePlan.to(device)` uploads. The row-end positions (`pend`)
are only an input of the planned routes `pr1..pr3` and are not kept.

One call runs three phases:

A. the x read (glue, as it is XLA in the reference): the planned paged
   gather (K9, kernels/pgather.py) where the plan has one, else
   `x[aj]`; then `combine`, and the ring's identity beyond each tile's
   count;
B. K10 (`_merge_group_pass`, csrc/merge_kernels.cu): per group, an
   inclusive segmented scan of each tile's products by their row ids
   and the planned route of row-end values into the tiles' y windows;
   then the carry chain across tiles, which on the card is two block
   scans over the tiles (the last non-empty tile before each, and a
   segmented scan of the tiles' last-row values), not a walk;
C. y assembled by the ownership map: K9 by `pgather_y` over the flat
   y windows (empty rows get the identity back through `owner_valid`),
   else a take by `owner_idx` with one identity slot appended; then
   the identity folded into every row, as the oracle's
   acc = initialize() does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, as_values, host_values, value_dtype, widen16
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.pgather import build_paged_gather_plan, paged_gather
from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv
from spmv_tpu_torch.kernels.tile_ops import LANES, route3_batched, segmented_scan_tile
from spmv_tpu_torch.ops.registry import (PlanCapacityError, float_val_dtype, plan_cache,
                                         register, resolve_val_dtype, warn_fallback)
from spmv_tpu_torch.ops.routing import route_tiles
from spmv_tpu_torch.ops.semiring import (OR_AND_COUNTING, PLUS_TIMES, Semiring,
                                         device_ring_code)
from spmv_tpu_torch.ops.tuning import detect_chip, dispatch_fields


@dataclasses.dataclass(frozen=True)
class MergePolicy:
    """Tile shape of a merge plan: nonzeros (EN) and rows (RW) per tile,
    each a multiple of 128."""

    nnz_per_tile: int = 2048
    rows_per_tile: int = 1024

    def __post_init__(self):
        if self.nnz_per_tile % LANES or self.rows_per_tile % LANES:
            raise ValueError(f"nnz_per_tile and rows_per_tile must be multiples "
                             f"of {LANES}; got {self}")


# "stock" stands for the library defaults of cub_merge; "tuned" is the
# policy `merge_tiled` and the fallback of `merge`/`merge_genl` use.
STOCK_POLICY = MergePolicy(nnz_per_tile=1024, rows_per_tile=1024)
TUNED_POLICY = MergePolicy(nnz_per_tile=2048, rows_per_tile=1024)

_PLAN_ARRAYS = ("aj_tiles", "ax_tiles", "rel_tiles", "r_start", "lrow", "cnt",
                "owner_idx", "pr1", "pr2", "pr3", "owner_valid")


@dataclasses.dataclass
class MergePlan:
    """The merge schedule of one (matrix, policy). Arrays are NumPy from
    the planner and tensors after `.to(device)`."""

    policy: MergePolicy
    n_tiles: int      # T, padded to a whole number of groups
    aj_tiles: object  # (T, EN) int32 column indices, 0 past cnt
    ax_tiles: object  # (T, EN) values, 0 past cnt
    rel_tiles: object  # (T, S, 128) int32 local row ids (non-decreasing)
    r_start: object   # (T,) int32 first row of each tile (-2 on pad tiles)
    lrow: object      # (T,) int32 last row each tile touches (-2 on pad tiles)
    cnt: object       # (T,) int32 valid nonzeros of each tile
    owner_idx: object  # (n_rows,) int32 flat y-window slot, T_real*RW if empty
    pgather: object = None  # paged-gather plan of phase A (None: x[aj])
    pr1: object = None      # (T/sbt*128, 128) uint8 row-end routes per group;
    pr2: object = None      # liveness in bit 7 of pr3
    pr3: object = None
    pgather_y: object = None  # paged-gather plan of phase C (None: the take)
    owner_valid: object = None  # (n_rows,) bool, False on empty rows

    def to(self, device) -> "MergePlan":
        """The same plan with every array a tensor on `device`."""
        up = {f: torch.from_numpy(np.ascontiguousarray(getattr(self, f))).to(device)
              for f in _PLAN_ARRAYS if getattr(self, f) is not None}
        for f in ("pgather", "pgather_y"):
            if getattr(self, f) is not None:
                up[f] = getattr(self, f).to(device)
        return dataclasses.replace(self, **up)


def _pad_merge_tiles(aj, ax, rel, pend, r_start, lrow, cnt, sbt):
    """Pad the tile count to whole groups of sbt tiles, with at least one
    pad tile: the owner map's empty-row slot (T*RW) must land on
    identity output. Pad tiles are empty (cnt 0, pend -1, r_start and
    lrow -2, so no carry fold matches) and sit at the end."""
    T = aj.shape[0]
    T_pad = -(-(T + 1) // sbt) * sbt
    p = T_pad - T
    aj = np.concatenate([aj, np.zeros((p,) + aj.shape[1:], aj.dtype)])
    ax = np.concatenate([ax, np.zeros((p,) + ax.shape[1:], ax.dtype)])
    rel = np.concatenate([rel, np.zeros((p,) + rel.shape[1:], rel.dtype)])
    pend = np.concatenate([pend, np.full((p,) + pend.shape[1:], -1, pend.dtype)])
    r_start = np.concatenate([r_start, np.full(p, -2, r_start.dtype)])
    lrow = np.concatenate([lrow, np.full(p, -2, lrow.dtype)])
    cnt = np.concatenate([cnt, np.zeros(p, cnt.dtype)])
    return aj, ax, rel, pend, r_start, lrow, cnt, T_pad


def _pend_routes(pend: np.ndarray, cnt: np.ndarray, S: int, P: int, sbt: int):
    """Per-group route of each tile's row-end scan values into its y
    window: src[g, j*P*128 + pp] = j*S*128 + pend[g*sbt+j, pp]. Where
    spare rows exist (sbt*P + sbt <= 128) the route also drops each
    tile's last scan value (its last row's running total, the carry
    source) at row sbt*P + j, lane 0."""
    T_pad = pend.shape[0]
    Gn = T_pad // sbt
    pf = pend.reshape(Gn, sbt, P * LANES)
    src = np.full((Gn, LANES * LANES), -1, np.int32)
    for j in range(sbt):
        dst = np.arange(P * LANES) + j * P * LANES
        pv = pf[:, j, :]
        src[:, dst] = np.where(pv >= 0, pv + j * S * LANES, -1)
    if sbt * P + sbt <= LANES:
        cg = cnt.reshape(Gn, sbt).astype(np.int64)
        for j in range(sbt):
            src[:, (sbt * P + j) * LANES] = np.where(
                cg[:, j] > 0, j * S * LANES + cg[:, j] - 1, -1).astype(np.int32)
    s1, s2, s3 = route_tiles(src.reshape(Gn, LANES, LANES), dedupe=False)
    s3 = s3.copy()
    s3.reshape(Gn, -1)[...] |= ((src >= 0).astype(np.uint8) << 7)
    return s1.reshape(-1, LANES), s2.reshape(-1, LANES), s3.reshape(-1, LANES)


def _merge_pgather(aj_flat: np.ndarray, valid_flat: np.ndarray, n_cols: int,
                   val_bytes: int):
    """Paged-gather plan over the merge stream (dead slots -1)."""
    idx = np.where(valid_flat, aj_flat.astype(np.int64), -1)
    return build_paged_gather_plan(idx, n_cols, val_bytes)


def _check_int32_reach(T: int, RW: int) -> None:
    if T * RW + 1 > np.iinfo(np.int32).max:
        raise OverflowError("merge plan output exceeds int32 indexing")


def build_merge_plan(A: CSR, policy: MergePolicy) -> MergePlan:
    """Greedy merge-path split: each tile takes nonzeros until it holds
    EN of them or the next one lies RW rows or more past its first row."""
    EN, RW = policy.nnz_per_tile, policy.rows_per_tile
    S, P = EN // LANES, RW // LANES
    sbt = LANES // S
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    nnz = int(Ap[-1])
    n_rows = A.n_rows
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])

    # the native tile walk and fill when available (native/host.cpp
    # spmv_merge_fill); the NumPy path below emits the same arrays
    if nnz > 0:
        try:
            from spmv_tpu_torch import native

            if native.available():
                mt = native.merge_tiles(n_rows, Ap, row_ids, EN, RW)
                T = mt["n_tiles"]
                _check_int32_reach(T, RW)
                cnt = mt["cnt"].astype(np.int64)
                valid = np.arange(EN, dtype=np.int64)[None, :] < cnt[:, None]
                aj_tiles = np.where(valid, Aj[mt["flat_k"]], 0).astype(np.int32)
                ax_tiles = np.where(valid, Ax[mt["flat_k"]], 0).astype(Ax.dtype)
                (aj_tiles, ax_tiles, rel, pend, r_start, lrow, cnt_a,
                 T_pad) = _pad_merge_tiles(
                    aj_tiles, ax_tiles, mt["rel"].reshape(T, S, LANES),
                    mt["pend"].reshape(T, P, LANES), mt["r_start"], mt["lrow"],
                    mt["cnt"], sbt)
                valid_p = np.arange(EN)[None, :] < cnt_a.astype(np.int64)[:, None]
                pr1, pr2, pr3 = _pend_routes(pend, cnt_a, S, P, sbt)
                owner = mt["owner_idx"].astype(np.int64)
                return MergePlan(
                    policy=policy, n_tiles=T_pad, aj_tiles=aj_tiles,
                    ax_tiles=ax_tiles, rel_tiles=rel, r_start=r_start, lrow=lrow,
                    cnt=cnt_a, owner_idx=mt["owner_idx"],
                    pgather=_merge_pgather(aj_tiles.reshape(-1), valid_p.reshape(-1),
                                           A.n_cols, Ax.dtype.itemsize),
                    pr1=pr1, pr2=pr2, pr3=pr3,
                    pgather_y=build_paged_gather_plan(
                        np.where(owner != T * RW, owner, -1), T_pad * RW),
                    owner_valid=owner != T * RW)
        except (NotImplementedError, ValueError):
            pass

    # --- tile boundaries ---
    k_starts = []
    k = 0
    while k < nnz:
        r0 = int(row_ids[k])
        k_row_limit = Ap[min(r0 + RW, n_rows)]
        k_next = min(k + EN, int(k_row_limit), nnz)
        if k_next <= k:
            raise ValueError("merge tile walk failed to advance")
        k_starts.append(k)
        k = k_next
    T = len(k_starts)
    k_starts = np.asarray(k_starts + [nnz], dtype=np.int64)

    if T == 0:
        # empty matrix: no tiles; the owner map sends every row to slot 0
        zero_i32 = np.zeros((0,), np.int32)
        return MergePlan(
            policy=policy, n_tiles=0,
            aj_tiles=np.zeros((0, EN), np.int32),
            ax_tiles=np.zeros((0, EN), np.float32),
            rel_tiles=np.zeros((0, S, LANES), np.int32),
            r_start=zero_i32, lrow=zero_i32, cnt=zero_i32,
            owner_idx=np.zeros((n_rows,), np.int32))

    cnt = (k_starts[1:] - k_starts[:-1]).astype(np.int64)
    r_start = row_ids[k_starts[:-1]].astype(np.int64)
    lrow = row_ids[k_starts[1:] - 1].astype(np.int64)

    # --- padded per-tile nonzero arrays: tile t slot e -> k_starts[t]+e
    e_idx = np.arange(EN, dtype=np.int64)
    flat_k = np.minimum(k_starts[:-1, None] + e_idx[None, :], nnz - 1)
    valid = e_idx[None, :] < cnt[:, None]
    aj_tiles = np.where(valid, Aj[flat_k], 0).astype(np.int32)
    ax_tiles = np.where(valid, Ax[flat_k], 0).astype(Ax.dtype)
    rel = np.where(valid, row_ids[flat_k] - r_start[:, None], 0)
    # pad slots continue the last valid segment, so they never open a
    # new one (their product is the identity)
    last_rel = np.take_along_axis(rel, np.maximum(cnt - 1, 0)[:, None], axis=1)
    rel = np.where(valid, rel, last_rel).astype(np.int32)

    # --- per-tile row-end positions: for local row r of tile t (row
    # g = r_start[t]+r), the last in-tile position of row g, or -1
    r_idx = np.arange(RW, dtype=np.int64)
    g = r_start[:, None] + r_idx[None, :]
    g_clamped = np.minimum(g, n_rows - 1)
    seg_begin = np.maximum(Ap[g_clamped], k_starts[:-1, None])
    seg_end = np.minimum(Ap[g_clamped + 1], k_starts[1:, None])
    pend = seg_end - k_starts[:-1, None] - 1
    has_elems = (seg_end > seg_begin) & (g < n_rows)
    pend = np.where(has_elems, pend, -1).astype(np.int32)

    # --- ownership map: each row's flat output slot in the last tile
    # touching it; empty rows -> the identity pad slot T*RW
    owner = np.searchsorted(r_start, np.arange(n_rows), side="right") - 1
    owner = np.clip(owner, 0, T - 1)
    local = np.arange(n_rows) - r_start[owner]
    owner_valid = (local >= 0) & (local < RW) & (np.arange(n_rows) <= lrow[owner])
    owner_idx = np.where(owner_valid, owner * RW + local, T * RW).astype(np.int64)
    _check_int32_reach(T, RW)
    owner_idx = owner_idx.astype(np.int32)

    (aj_tiles, ax_tiles, rel_p, pend_p, r_start_p, lrow_p, cnt_p,
     T_pad) = _pad_merge_tiles(
        aj_tiles, ax_tiles, rel.reshape(T, S, LANES), pend.reshape(T, P, LANES),
        r_start.astype(np.int32), lrow.astype(np.int32), cnt.astype(np.int32), sbt)
    valid_p = np.arange(EN)[None, :] < cnt_p.astype(np.int64)[:, None]
    pr1, pr2, pr3 = _pend_routes(pend_p, cnt_p, S, P, sbt)
    return MergePlan(
        policy=policy, n_tiles=T_pad, aj_tiles=aj_tiles, ax_tiles=ax_tiles,
        rel_tiles=rel_p, r_start=r_start_p, lrow=lrow_p, cnt=cnt_p,
        owner_idx=owner_idx,
        pgather=_merge_pgather(aj_tiles.reshape(-1), valid_p.reshape(-1), A.n_cols,
                               Ax.dtype.itemsize if Ax.size else 4),
        pr1=pr1, pr2=pr2, pr3=pr3,
        pgather_y=build_paged_gather_plan(
            np.where(owner_valid, owner_idx.astype(np.int64), -1), T_pad * RW),
        owner_valid=owner_valid)


def _group_shape(S: int, P: int, T: int) -> int:
    """sbt, the tiles per group, after checking that the tile shape fits
    K10's (128, 128) group block."""
    if S < 1 or LANES % S:
        raise ValueError(f"S = nnz_per_tile/128 = {S} must divide {LANES}")
    sbt = LANES // S
    if P < 1 or sbt * P > LANES:
        raise ValueError(f"sbt*P = {sbt}*{P} y-window rows exceed one "
                         f"{LANES}-row group block")
    if T % sbt:
        raise ValueError(f"{T} tiles are not whole groups of {sbt}")
    return sbt


def _carry_walk(r_start, lrow, cnt, raw, *, sr):
    """The reference's carry chain (merge.py:394-423), tile by tile on
    the host: a tile folds the carry where carry_row == r_start; a
    non-empty tile then sets the carry to its last-row value `raw`,
    merged into the carry if the tile is one row continuing it; empty
    tiles pass it through. -> (the tiles that fold, the carry each folds
    in, as 0-d tensors)."""
    rs, lr, cn = (a.tolist() for a in (r_start.cpu(), lrow.cpu(), cnt.cpu()))
    raw_h = raw.cpu()
    ident = float(sr.identity_for(raw_h.dtype))
    carry_row, carry_val = -1, torch.tensor(ident, dtype=raw_h.dtype)
    fold_t, fold_v = [], []
    for t in range(len(rs)):
        fold = carry_row == rs[t]
        if fold:
            fold_t.append(t)
            fold_v.append(carry_val)
        if cn[t] > 0:
            one_row = fold and lr[t] == rs[t]
            carry_val = sr.reduce(carry_val, raw_h[t]) if one_row else raw_h[t]
            carry_row = lr[t]
    return fold_t, fold_v


def _merge_group_plain(prod, rel, pr1, pr2, pr3, r_start, lrow, cnt, *, sr, S, P):
    """Plain version of K10: the reference's `_merge_group_kernel` on all
    groups at once, then its carry chain tile by tile on the host.

    Per group, a segmented scan of the (128, 128) products by row ids
    offset per tile (`segmented_scan_tile`, Hillis-Steele, reduce(later,
    earlier)); the routed row-end values, the identity where the route
    is not live; then the carry chain (`_carry_walk`), each carry folded
    into its tile's first window element. A tile's last-row value is the
    route's spare row where sbt*P + sbt <= 128, else reduce(identity,
    scan at cnt - 1) (the reference's masked reduction of one live
    element, :413-415). A sum (plus-times, the or-and counting ring) is
    scanned and carried in float64, any other ring in float32, and y is
    rounded to prod's dtype once, as K10 does. -> (T*P, 128)."""
    T = r_start.shape[0]
    sbt = _group_shape(S, P, T)
    Gn, EN, RW = T // sbt, S * LANES, P * LANES
    dev = prod.device
    # a sum is scanned and carried in float64 and rounded once, as K10
    # does: a hub row's partial sums cross zero, where two float32 orders
    # differ by more than rtol 2e-4
    wide = sr is PLUS_TIMES or sr is OR_AND_COUNTING
    src = prod.double() if wide else widen16(prod)
    ident = float(sr.identity_for(src.dtype))
    tile_of_row = torch.arange(LANES, dtype=torch.int32, device=dev) // S
    seg = rel.view(Gn, LANES, LANES) + (tile_of_row * RW)[:, None]
    scan = segmented_scan_tile(src.view(Gn, LANES, LANES), seg, sr.reduce)
    s3 = pr3.to(torch.int32)
    routed = route3_batched(scan.reshape(-1, LANES), pr1, pr2, s3 & 127)
    routed = routed.view(Gn, LANES, LANES)
    live = (s3 >> 7).view(Gn, LANES, LANES) > 0
    yw = torch.where(live, routed, ident)
    y = yw[:, :sbt * P].contiguous().view(T, RW)
    if sbt * P + sbt <= LANES:
        raw = routed[:, sbt * P:sbt * P + sbt, 0].reshape(T)
    else:
        c = cnt.long()
        last = scan.reshape(T, EN).gather(1, (c - 1).clamp(min=0)[:, None])[:, 0]
        raw = torch.where(c > 0, sr.reduce(torch.full_like(last, ident), last), ident)

    fold_t, fold_v = _carry_walk(r_start, lrow, cnt, raw, sr=sr)
    if fold_t:
        idx = torch.tensor(fold_t, device=dev)
        y[idx, 0] = sr.reduce(torch.stack(fold_v).to(dev), y[idx, 0])
    return y.view(T * P, LANES).to(prod.dtype)


def _merge_group_pass(prod, rel, pr1, pr2, pr3, r_start, lrow, cnt, *, sr, S, P):
    """K10: the segmented scan, row-end route and carry chain of T tiles
    in groups of sbt = 128/S -> y windows (T*P, 128).

    prod and rel are (T*S, 128), float32, bfloat16 or float16 and int32;
    the routes (T/sbt*128, 128) uint8; r_start, lrow and cnt (T,) int32;
    y is in prod's dtype. Two launches, counted as one call: one CTA per
    group (the scan and the route), then one CTA scanning the carry
    chain. Plus-times sums in another order than the plain version
    (within rtol 2e-4 / atol 1e-5; bit for bit on integer-valued data);
    the other rings give its bits."""
    T = r_start.shape[0]
    sbt = _group_shape(S, P, T)
    if prod.device.type == "cpu":
        return _merge_group_plain(prod, rel, pr1, pr2, pr3, r_start, lrow, cnt,
                                  sr=sr, S=S, P=P)
    if prod.device.type != "cuda":
        raise ValueError(f"_merge_group_pass: unsupported device {prod.device}")
    lib, ring = device_ring_code(sr)
    dev = prod.device
    rows = T * S
    code = _cuda.value_code(prod, "K10 (merge_group)")
    _cuda.expect(prod, "prod", prod.dtype, (rows, LANES), dev)
    if prod.data_ptr() % (4 * prod.element_size()):  # read 4 values a thread at once
        raise ValueError(f"prod: not aligned to 4 values ({4 * prod.element_size()} bytes)")
    _cuda.expect(rel, "rel", torch.int32, (rows, LANES), dev)
    for name, t in (("pr1", pr1), ("pr2", pr2), ("pr3", pr3)):
        _cuda.expect(t, name, torch.uint8, (T // sbt * LANES, LANES), dev)
    for name, t in (("r_start", r_start), ("lrow", lrow), ("cnt", cnt)):
        _cuda.expect(t, name, torch.int32, (T,), dev)
    out = torch.empty((T * P, LANES), dtype=prod.dtype, device=dev)
    # scratch: each tile's last-row value and its first window element,
    # unrounded
    raw = torch.empty((2 * T,), dtype=torch.float64, device=dev)
    rc = lib.spmv_merge_group(
        _cuda.ptr(prod), _cuda.ptr(rel), _cuda.ptr(pr1), _cuda.ptr(pr2),
        _cuda.ptr(pr3), _cuda.ptr(r_start), _cuda.ptr(lrow), _cuda.ptr(cnt),
        _cuda.ptr(raw), _cuda.ptr(out), T, S, P, code, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_merge_group")
    _merge_group_pass.launches += 1
    return out


_merge_group_pass.launches = 0


def device_merge_plan(A: CSR, policy: MergePolicy, device) -> MergePlan:
    """The merge plan of (A, policy), built once on the host and uploaded
    once per device; both cached on A."""
    host = plan_cache(A, ("merge", policy), lambda: build_merge_plan(A, policy))
    return plan_cache(A, ("merge", policy, str(device)), lambda: host.to(device))


def merge_products(A: CSR, x: torch.Tensor, semiring: Semiring,
                   plan: MergePlan) -> torch.Tensor:
    """Phase A: the x read (K9 where the plan has a paged gather), the
    ring's combine, and its identity beyond each tile's count ->
    (T*S, 128)."""
    val_dtype = tdtype = float_val_dtype(A, x, "merge_tiled")
    T, EN = plan.aj_tiles.shape
    xv = x.to(tdtype)
    if plan.pgather is not None:
        xg = paged_gather(xv, plan.pgather).view(T, EN)
    else:
        xg = xv[plan.aj_tiles.long()]
    prod = semiring.combine(as_values(plan.ax_tiles, value_dtype(A.Ax)).to(tdtype), xg)
    ident = float(semiring.identity_for(val_dtype))
    e = torch.arange(EN, device=x.device)
    prod = torch.where(e[None, :] < plan.cnt[:, None], prod, ident)
    return prod.reshape(-1, LANES).contiguous()


def _merge_impl(A: CSR, x, semiring: Semiring, policy: MergePolicy) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    val_dtype = resolve_val_dtype(A, x)
    ident = float(semiring.identity_for(val_dtype))
    if A.nnz == 0 or A.n_cols == 0:
        return torch.full((A.n_rows,), ident, dtype=val_dtype, device=x.device)
    plan = device_merge_plan(A, policy, x.device)
    S, P = policy.nnz_per_tile // LANES, policy.rows_per_tile // LANES
    prod = merge_products(A, x, semiring, plan)
    y_tiles = _merge_group_pass(
        prod, plan.rel_tiles.view(-1, LANES), plan.pr1, plan.pr2, plan.pr3,
        plan.r_start, plan.lrow, plan.cnt, sr=semiring, S=S, P=P)
    # phase C; K9 reads natural order, so the windows go in flat
    if plan.pgather_y is not None:
        g = paged_gather(y_tiles.reshape(-1), plan.pgather_y)
        y = torch.where(plan.owner_valid, g, ident)
    else:
        y_flat = torch.cat([y_tiles.reshape(-1), y_tiles.new_full((1,), ident)])
        y = y_flat[plan.owner_idx.long()]
    return semiring.reduce(y, torch.full_like(y, ident))


# ---------------------------------------------------------------------------
# Registrations: `merge`, `merge_stock` and `merge_genl` on the stream
# pipeline, `merge_tiled` direct; the stream kinds fall back to
# `merge_tiled`'s path past the stream planner's reach.
# ---------------------------------------------------------------------------

def _stream_policy_for(nnz_per_tile: int, device) -> StreamPolicy:
    return StreamPolicy(kappa=nnz_per_tile,
                        **dispatch_fields(chip=detect_chip(device)))


def _merge_fast(A: CSR, x: torch.Tensor, semiring: Semiring, kappa: int,
                tiled_policy: MergePolicy) -> torch.Tensor:
    try:
        return _stream_spmv(A, x, semiring, _stream_policy_for(kappa, x.device))
    except PlanCapacityError as e:
        warn_fallback("merge", "tiled", e)
        return _merge_impl(A, x, semiring, tiled_policy)


@register("merge", supports_semiring=True,
          reference_analog="merge_based/* (dispatch_spmv_orig.cuh:533-769)")
def _merge(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV, tuned tile size, on the stream pipeline."""
    return _merge_fast(A, x, semiring, 14336, TUNED_POLICY)


@register("merge_stock", reference_analog="cub_merge.cuh:16-55",
          aliases=("cub_merge",), supports_semiring=True)
def _merge_stock(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV with the library-default (untuned) tile size: the
    same pipeline as `merge`, smaller equal-nnz tiles."""
    return _merge_fast(A, x, semiring, 8192, STOCK_POLICY)


@register("merge_genl", supports_semiring=True,
          reference_analog="merge_genl/* (merge_genl.cuh:41-80)")
def _merge_genl(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Semiring-generalized merge-path SpMV: plus-times takes the
    prefix-difference bodies (K2, K6), other rings the segmented-scan
    bodies (K7, K8); a user-defined ring runs on a CPU tensor."""
    return _merge_fast(A, x, semiring, 14336, TUNED_POLICY)


@register("merge_tiled", supports_semiring=True,
          reference_analog="merge_based/agent_spmv_orig.cuh:120-760 "
                           "(direct tiled walk; reach fallback)")
def _merge_tiled(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV, direct tiled execution: paged x gather (K9),
    segmented scan and carry chain (K10), ownership gather (K9). It has
    no planner size cap; the other merge kinds fall back here."""
    return _merge_impl(A, x, semiring, TUNED_POLICY)
