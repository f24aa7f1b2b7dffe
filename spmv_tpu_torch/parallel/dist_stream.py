"""Distributed SpMV with the stream pipeline on every shard.

Counterpart of `spmv_tpu/parallel/dist_stream.py`. The halo exchange is
the compact all-to-all of parallel/partition.py; on each shard the
plan-routed stream pipeline of kernels/stream.py runs: the gather with
early row reduction (K2 for plus-times, K7 for the other rings), one
K5 shuffle pass per level, the exact-rank scan (K6 or K8), then the
window merge. The x table is the plain per-window transpose (no lane
remap, so no K1), and a shard whose planner finds no early reduction
raises PlanCapacityError (so no K3 or K4); callers fall back to
`distribute_csr`.

The host half is the reference's, copied: `build_uniform_plans` forces
one geometry on every shard (common gather-tile count, partial quota
Qp, the largest shard's shuffle levels replayed on the others, common
final-tile count) and stacks every per-shard plan array along a leading
shard axis; for the same matrix, shard count and policy its arrays
equal the reference's bit for bit (tests/test_torch_parallel.py). The
reference needs one geometry because shard_map compiles one program;
the port keeps it so both packages run the same plans. On a local mesh
the shards run one after another (batching the stream kernels across
shards is later work).

What `matvec` returns, and how it replays one CUDA graph a call on the
card: as `distribute_csr`'s (parallel/dist_spmv.py).

Values: A's may be float32, bfloat16 or float16 (the stream kernels'
dtypes), carried by the planner as `formats.host_values` gives them. As
in the reference, x must be in A's dtype when that is a 2-byte one (the
reference's kernels refuse the mix; `matvec` raises ValueError naming
both dtypes before any launch); with float32 values a 2-byte x is
widened and y is float32. y is in the values' dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.formats import COO, CSR, as_values, coo_to_csr, host_values, value_dtype
from spmv_tpu_torch.kernels import stream as st
from spmv_tpu_torch.kernels.shuffle import (
    TILE,
    _run_split,
    gap_rows,
    plan_shuffle_auto,
    plan_shuffle_multi,
    shuffle_device_arrays,
)
from spmv_tpu_torch.kernels.tile_ops import LANES
from spmv_tpu_torch.ops.registry import PlanCapacityError, plan_cache
from spmv_tpu_torch.ops.routing import route_tiles
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring
from spmv_tpu_torch.parallel.bootstrap import ShardMesh, put_global
from spmv_tpu_torch.parallel.dist_spmv import _Distributed, _placement
from spmv_tpu_torch.parallel.partition import HaloPlan, build_halo_plan


def _local_csr(plan: HaloPlan, s: int, val_dtype) -> CSR:
    """Shard s's local matrix over the UNIFORM local column space
    [0, B) owned x block ++ [B, B + n*M) halo table."""
    R = plan.R
    rows = np.concatenate([plan.rows_self[s], plan.rows_halo[s]])
    cols = np.concatenate(
        [plan.cols_self[s],
         plan.cols_halo[s] + plan.B]).astype(np.int64)
    vals = np.concatenate([plan.vals_self[s], plan.vals_halo[s]])
    live = rows < R
    C = plan.B + plan.n_shards * plan.M
    coo = COO(R, C, rows[live].astype(np.int64), cols[live],
              vals[live].astype(val_dtype))
    return coo_to_csr(coo, offset_dtype=np.int64)


@dataclasses.dataclass
class UniformStreamPlans:
    """Stacked per-shard stream plans with one common geometry."""

    n: int
    pad_tiles: int
    x_rows_pad: int          # rows of each shard's padded x2d
    n_aug: int               # common hot-page rows (0 on most shards)
    F_pad: int
    Qp: int
    out_rows: int
    split_meta: list         # per pass: dict(n_steps, sbt, K, Q, out_rows)
    dev: dict                # stacked device arrays (leading shard axis)
    n_y_rows: int            # R (local y rows)


def _build_one(A: CSR, policy, F_common=None, levels=None, Qp=None,
               s_pad=None, pad_tiles=None):
    """One shard's plan pieces under (optionally) forced geometry.

    Mirrors build_stream_plan's flow but returns host arrays and the
    chosen geometry so the caller can force it on every shard. A None
    force means 'discover' (used for the reference shard)."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    nnz = int(Ap[-1])
    row_ids = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                        Ap[1:] - Ap[:-1])
    x_blocks_pad = -(-A.n_cols // (LANES * LANES))

    res = st._plan_gather_reduce(Aj, row_ids, policy, x_blocks_pad)
    if res is None:
        raise PlanCapacityError("dist_stream: early reduction "
                                "infeasible for a shard")
    slot_src, slot_q, xb, hot_cols, red = res
    n_tiles = xb.shape[0]
    want_tiles = pad_tiles if pad_tiles is not None else \
        max(16, -(-n_tiles // 16) * 16)
    if n_tiles > want_tiles:
        raise PlanCapacityError("dist_stream: shard exceeds common "
                                "gather tiles")
    padn = want_tiles - n_tiles
    if padn:
        slot_src = np.concatenate(
            [slot_src, np.full(padn * TILE, -1, np.int64)])
        slot_q = np.concatenate(
            [slot_q, np.full(padn * TILE, -1, np.int8)])
        xb = np.concatenate([xb, np.zeros(padn, np.int32)])
        red["src_route"] = np.concatenate(
            [red["src_route"],
             np.full((padn, LANES, LANES), -1, np.int32)])
        red["firstmask"] = np.concatenate(
            [red["firstmask"],
             np.zeros((padn, st.REDUCE_MAX_RUNS // LANES, LANES),
                      np.int8)])
        red["runstart"] = np.concatenate(
            [red["runstart"],
             np.zeros((padn, LANES, LANES), np.int8)])
    pad_tiles = want_tiles

    # deal tiles round-robin by partial count (as build_stream_plan)
    R_t = np.bincount(red["tile_of_part"], minlength=pad_tiles)
    order_t = np.argsort(-R_t, kind="stable")
    n_steps0 = pad_tiles // 8
    perm = np.empty(pad_tiles, np.int64)
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

    n_runs = red["n_runs"]
    Qp_need = max(8, -(-(int(red["p_of_part"].max()) + 1) // LANES
                       // 8) * 8)
    if Qp is None:
        s_pad_c = 64
        while (s_pad_c * LANES // pad_tiles // 8) * 8 < Qp_need \
                and s_pad_c < pad_tiles * 64 // LANES:
            s_pad_c *= 2
        Qp = min(st.REDUCE_MAX_RUNS // LANES,
                 max(Qp_need, (s_pad_c * LANES // pad_tiles // 8) * 8))
        s_pad = max(s_pad_c,
                    -(-(pad_tiles * Qp // LANES) // 8) * 8)
    elif Qp_need > Qp:
        raise PlanCapacityError("dist_stream: shard exceeds common Qp")

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
    live = rank_of_slot >= 0
    n_items = n_runs

    kap0 = min(policy.kappa, 12288) if F_common is None else F_common
    # F_common forces the walk geometry: a replaying shard retries the
    # kappas, largest first, until its final-tile count fits F_common
    kappas = [k for k in (kap0 if F_common is None else
                          min(policy.kappa, 12288),
                          12288, 10240, 8192, 6144, 4096, 3072, 2048,
                          1024, 512, 256)
              if isinstance(k, int)]
    last_err = None
    plan_sh = walk = None
    for kappa in kappas:
        k_starts, bases, r_starts, lrows = st._final_tile_walk(
            Ap, rows_ranked, kappa)
        F = k_starts.shape[0] - 1
        F_use = F_common if F_common is not None else F
        if F > F_use:
            continue  # smaller kappas only grow F; but first entries
            # may overshoot a forced F_common — keep trying larger?
        sizes = np.diff(k_starts)
        ftile_of_rank = np.repeat(np.arange(F, dtype=np.int64), sizes)
        dst_of_rank = (ftile_of_rank * TILE + np.arange(n_items)
                       - np.repeat(k_starts[:-1], sizes))
        dst_pos = np.full(rank_of_slot.shape[0], -1, dtype=np.int64)
        dst_pos[live] = dst_of_rank[rank_of_slot[live]]
        try:
            if levels is None:
                plan_sh = plan_shuffle_auto(dst_pos, F_use, sbt=8)
            else:
                plan_sh = plan_shuffle_multi(dst_pos, F_use,
                                             levels=levels, sbt=8)
        except ValueError as e:
            last_err = e
            continue
        walk = (k_starts, bases, r_starts, lrows)
        break
    if plan_sh is None:
        raise PlanCapacityError(f"dist_stream shuffle: {last_err}")
    k_starts, bases, r_starts, lrows = walk
    F = k_starts.shape[0] - 1
    F_use = F_common if F_common is not None else F
    if levels is None:
        # recover the level geometry for replay on other shards
        lv = []
        for p in plan_sh.passes[:-1]:
            region_tiles = (p.out_rows // p.K) // LANES
            lv.append((p.K, p.Q, region_tiles))
        levels = lv

    scan = st._plan_scan(plan_sh, k_starts, bases, r_starts, lrows,
                         rows_ranked)

    F_pad = -(-F_use // st.SBT_SCAN_MAX) * st.SBT_SCAN_MAX
    pf = F_pad - F

    def padt(a, fill):
        if pf == 0:
            return a
        return np.concatenate(
            [a, np.full((pf,) + a.shape[1:], fill, a.dtype)])

    scan = {k: padt(scan[k], 16384 if k == "relid" else 0)
            for k in scan}

    # uniform merge: per y2d row (R/128 blocks * 128? no — per y2d
    # 128-lane row), the FIRST contributing ycand row, plus fixup
    # pairs for extras (padded to a common count by the caller)
    NBY = -(-A.n_rows // LANES)
    fb = (bases // LANES).astype(np.int64)
    lo = (r_starts.astype(np.int64) // LANES)
    hi = (lrows.astype(np.int64) // LANES)
    merge_src = np.full(NBY, F_pad * LANES, dtype=np.int32)  # pad row
    extras = []
    for f in range(F):
        for b2 in range(int(lo[f]), int(hi[f]) + 1):
            r = f * LANES + int(b2 - fb[f])
            if merge_src[b2] == F_pad * LANES:
                merge_src[b2] = r
            else:
                extras.append((b2, r))

    c1, c2, c3 = route_tiles(red["src_route"], dedupe=False)
    HR = st.REDUCE_MAX_RUNS // LANES
    c3 = c3.copy()
    c3[:, :HR, :] |= (red["firstmask"].astype(np.uint8) << 7)

    Ax_slots = np.where(slot_src >= 0,
                        Ax[np.clip(slot_src, 0, max(nnz - 1, 0))], 0)
    split_meta = [dict(n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                       out_rows=p.out_rows)
                  for p in plan_sh.passes]
    host = {
        "Ax": Ax_slots.astype(Ax.dtype).reshape(-1, LANES),
        "q": slot_q.reshape(-1, LANES),
        "xb": xb,
        "c1": c1.reshape(-1, LANES), "c2": c2.reshape(-1, LANES),
        "c3": c3.reshape(-1, LANES),
        # run-start bits for the generic-semiring reduce pass (the
        # roll-scan variant; plus_times/f32 ignores them)
        "rs": red["runstart"].reshape(-1, LANES),
        "merge_src": merge_src,
        **{f"scan_{k}": (scan[k].reshape(-1, LANES)
                         if scan[k].ndim > 1 else scan[k])
           for k in scan},
    }
    for i, d in enumerate(shuffle_device_arrays(plan_sh)):
        host.update({f"sp{i}_{k}": v for k, v in d.items()})
    geom = dict(pad_tiles=pad_tiles, Qp=Qp, s_pad=s_pad,
                out_rows=s_pad * LANES, F=F_use, F_pad=F_pad,
                levels=levels, split_meta=split_meta,
                x_blocks_pad=x_blocks_pad,
                n_aug=int(hot_cols.shape[0]))
    return host, extras, hot_cols, geom


def build_uniform_plans(A: CSR, plan: HaloPlan,
                        policy=None) -> UniformStreamPlans:
    n = plan.n_shards
    val_dtype = host_values(A.Ax).dtype  # bfloat16 as uint16
    if policy is None:
        from spmv_tpu_torch.ops.tuning import policy_for

        policy = policy_for(np.dtype(val_dtype).itemsize)
    # shard-local x tables are built with the plain transpose; the
    # single-device lane remap does not apply here
    policy = dataclasses.replace(policy, remap=False)
    locals_ = [_local_csr(plan, s, val_dtype) for s in range(n)]
    # The reference shard discovers the common geometry; the others
    # replay it. Feasibility under a replayed geometry is NOT monotone
    # in shard load (quota windows are per (tile, group) flow), so on
    # a replay failure the failing shard becomes the next reference —
    # in practice the most skewed shard binds and this converges in
    # one or two attempts. Exhausting the attempts raises
    # PlanCapacityError and callers fall back to distribute_csr.
    # prepass: common gather-tile count and partial quota from every
    # shard's structure (a lighter shard can still need MORE tiles or
    # a deeper quota than the heaviest one)
    tiles_need, qp_need = 1, 8
    for c in locals_:
        Ap_ = np.asarray(c.Ap, np.int64)
        Aj_ = np.asarray(c.Aj, np.int64)
        rid = np.repeat(np.arange(c.n_rows, dtype=np.int64),
                        Ap_[1:] - Ap_[:-1])
        res = st._plan_gather_reduce(
            Aj_, rid, policy, -(-c.n_cols // (LANES * LANES)))
        if res is None:
            raise PlanCapacityError(
                "dist_stream: early reduction infeasible for a shard")
        _, _, xb_, _, red_ = res
        tiles_need = max(tiles_need, xb_.shape[0])
        qp_need = max(qp_need,
                      -(-(int(red_["p_of_part"].max()) + 1) // LANES
                        // 8) * 8)
    pad_tiles_c = max(16, -(-tiles_need // 16) * 16)
    s_pad_c = 64
    while (s_pad_c * LANES // pad_tiles_c // 8) * 8 < qp_need \
            and s_pad_c < pad_tiles_c * 64 // LANES:
        s_pad_c *= 2
    Qp_c = min(st.REDUCE_MAX_RUNS // LANES,
               max(qp_need, (s_pad_c * LANES // pad_tiles_c // 8) * 8))
    s_pad_c = max(s_pad_c, -(-(pad_tiles_c * Qp_c // LANES) // 8) * 8)

    tried: set = set()
    ref = int(np.argmax([c.nnz for c in locals_]))
    shards = extras = hotcols = geom = None
    for _attempt in range(min(n, 4)):
        tried.add(ref)
        h_ref, ex_ref, hc_ref, geom = _build_one(
            locals_[ref], policy, Qp=Qp_c, s_pad=s_pad_c,
            pad_tiles=pad_tiles_c)
        shards = [None] * n
        extras = [None] * n
        hotcols = [None] * n
        shards[ref], extras[ref], hotcols[ref] = h_ref, ex_ref, hc_ref
        failed = None
        for s in range(n):
            if s == ref:
                continue
            try:
                shards[s], extras[s], hotcols[s], _ = _build_one(
                    locals_[s], policy, F_common=geom["F"],
                    levels=geom["levels"], Qp=geom["Qp"],
                    s_pad=geom["s_pad"],
                    pad_tiles=geom["pad_tiles"])
            except PlanCapacityError:
                failed = s
                break
        if failed is None:
            break
        if failed in tried:
            raise PlanCapacityError(
                "dist_stream: no common shuffle geometry across shards")
        ref = failed
    else:
        raise PlanCapacityError(
            "dist_stream: no common shuffle geometry across shards")

    # common hot-page count
    n_aug = max(max(int(h.shape[0]) for h in hotcols), 0)
    n_aug = -(-n_aug // LANES) * LANES if n_aug else 0
    hot_stack = np.zeros((n, max(n_aug, 1)), np.int32)
    for s in range(n):
        hc = hotcols[s]
        if hc.size:
            hot_stack[s, :hc.size] = hc.astype(np.int32)

    # Fixups grouped BY DEPTH per y block (as stream.py's fix_levels):
    # a flat scatter computes every update from the OLD y2d, so two
    # extras hitting the same 128-row block would silently drop all but
    # one contribution. One scatter per depth keeps
    # indices within each scatter distinct; depths apply sequentially.
    per_depth: list = []  # per shard: list of depth -> [(b2, r)]
    for s in range(n):
        seen: dict = {}
        levels: list = []
        for b2, r in extras[s]:
            dpt = seen.get(b2, 0)
            seen[b2] = dpt + 1
            if dpt == len(levels):
                levels.append([])
            levels[dpt].append((b2, r))
        per_depth.append(levels)
    n_depth = max((len(lv) for lv in per_depth), default=0)
    n_fix = max((max((len(d) for d in lv), default=0)
                 for lv in per_depth), default=0)
    NBY = shards[0]["merge_src"].shape[0]
    fix_out = np.full((n, max(n_depth, 1), max(n_fix, 1)), NBY,
                      np.int32)  # oob = drop
    fix_src = np.zeros((n, max(n_depth, 1), max(n_fix, 1)), np.int32)
    for s in range(n):
        for dpt, lvl in enumerate(per_depth[s]):
            for i, (b2, r) in enumerate(lvl):
                fix_out[s, dpt, i] = b2
                fix_src[s, dpt, i] = r

    dev = {k: np.stack([shards[s][k] for s in range(n)])
           for k in shards[0]}
    dev["hot_cols"] = hot_stack
    dev["fix_out"] = fix_out
    dev["fix_src"] = fix_src
    return UniformStreamPlans(
        n=n, pad_tiles=geom["pad_tiles"],
        x_rows_pad=geom["x_blocks_pad"] * LANES,
        n_aug=n_aug, F_pad=geom["F_pad"], Qp=geom["Qp"],
        out_rows=geom["out_rows"], split_meta=geom["split_meta"],
        dev=dev, n_y_rows=plan.R)



@dataclasses.dataclass
class DistributedStreamSpMV(_Distributed):
    """Stream-pipeline distributed SpMV over a shard mesh (every
    built-in ring on the card; any ring on the CPU)."""

    uni: UniformStreamPlans
    gaps: list                # per held shard, per pass: K5's gap rows
    merge_fix: list           # per held shard: window-merge fixups per depth
    own_off: list             # per held shard: owned window offset

    def matvec(self, x, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
        """y = A (x) x; x as for `DistributedSpMV.matvec`. Returns the
        global y on a local mesh, this rank's owned rows on a
        process-group mesh; on the card, one graph replay after the first
        call of its key (parallel/dist_spmv.py:_Distributed._replay)."""
        return self._replay(x, semiring, None, lambda v: self._matvec_eager(v, semiring))

    def _matvec_eager(self, x, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
        """`matvec`'s body, every launch and collective enqueued here."""
        xs = self._compute_x(x)
        d = self.dev
        identity = float(semiring.identity_for(xs.dtype))
        x_loc, x2d_all = self._x_tables(xs)
        L = x_loc.shape[0]
        R_out = self.plan.R_out
        pad = torch.full((R_out,), identity, dtype=xs.dtype, device=xs.device)
        y_own, first = [], []
        for l in range(L):
            y = _shard_stream(self, l, x2d_all[l], x_loc[l], semiring, identity)
            first.append(y[:1])
            # the owned rows are a contiguous window of local y whose
            # offset may be negative (owned rows before the first
            # touched one): pad both sides so the slice never clamps
            yp = torch.cat([pad, y, pad])
            off = self.own_off[l] + R_out
            y_own.append(torch.where(d["own_valid"][l], yp[off:off + R_out], identity))
        y_own = torch.stack(y_own)
        # the oracle's acc = initialize() takes part in every row
        y = self._finish(y_own, torch.cat(first), semiring, identity)
        return semiring.reduce(y, torch.full_like(y, identity))

    def _compute_x(self, x) -> torch.Tensor:
        """The held shards' x blocks in the values' dtype: a 2-byte x
        widened for float32 values; any other mix raises ValueError, as
        the reference's kernels refuse it."""
        xs = self._sharded(x)
        vdt = self.dev["Ax"].dtype
        if xs.dtype == vdt:
            return xs
        if vdt != torch.float32:
            raise ValueError(f"distribute_stream: x of dtype {xs.dtype} with {vdt} "
                             f"values; the stream kernels take x in the values' "
                             f"dtype")
        return xs.float()

    def _x_tables(self, xs):
        """Each held shard's local column space, [0, B) owned x ++
        [B, B + n*M) halo table, and its transposed x table, one (128, 128)
        window per 16384 columns."""
        x_loc = torch.cat([xs, self._exchange(xs)], 1)
        xp = torch.nn.functional.pad(x_loc, (0, self.uni.x_rows_pad * LANES - x_loc.shape[1]))
        L = x_loc.shape[0]
        return x_loc, xp.view(L, -1, LANES, LANES).transpose(2, 3).reshape(L, -1, LANES)

    def reduce_inputs(self, x, l: int = 0) -> tuple:
        """The tensors held shard l's K2 (or K7) call reads on x, as
        `matvec` passes them: (x2d, Ax, q, xb, c1, c2, c3, rs). Exchanges
        the halo like `matvec`, so every rank of a process group calls it."""
        x_loc, x2d_all = self._x_tables(self._compute_x(x))
        return _reduce_inputs(self, l, x2d_all[l], x_loc[l])


def _reduce_inputs(dist, l, x2d, x_loc):
    """Held shard l's K2/K7 inputs: its x table with its hot pages, and
    its gather and reduce arrays."""
    u, d = dist.uni, dist.dev
    if u.n_aug:
        hot_x = x_loc.index_select(0, d["hot_cols"][l])
        aug = hot_x.view(-1, 1, LANES).expand(u.n_aug // LANES, LANES, LANES)
        x2d = torch.cat([x2d, aug.reshape(-1, LANES)])
    return (x2d.contiguous(),) + tuple(d[k][l] for k in ("Ax", "q", "xb", "c1", "c2",
                                                         "c3", "rs"))


def _shard_stream(dist, l, x2d, x_loc, sr, identity):
    """The stream pipeline of held shard l -> its local y (R,): K2 or K7
    on the x table with its hot pages, K5 per shuffle pass, K6 or K8,
    the window merge (glue)."""
    u, d = dist.uni, dist.dev
    cur = st._reduce_pass(*_reduce_inputs(dist, l, x2d, x_loc), sr=sr,
                          n_tiles=u.pad_tiles, Qp=u.Qp, out_rows=u.out_rows)
    for i, m in enumerate(u.split_meta):
        cur = _run_split(
            cur, d[f"sp{i}_s1"][l], d[f"sp{i}_s2"][l], d[f"sp{i}_s3"][l],
            d[f"sp{i}_starts"][l], d[f"sp{i}_pos"][l], n_steps=m["n_steps"],
            sbt=m["sbt"], K=m["K"], Q=m["Q"], rows_per_g=m["out_rows"] // m["K"],
            gaps=dist.gaps[l][i], fill=identity).reshape(m["out_rows"], LANES)
    rows = u.F_pad * LANES
    if cur.shape[0] < rows:
        cur = torch.nn.functional.pad(cur, (0, 0, 0, rows - cur.shape[0]),
                                      value=identity)
    ycand = st._scan_pass(
        cur[:rows].contiguous(), *[d[f"scan_{k}"][l] for k in (
            "relid", "pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1",
            "q2s2", "q2s3", "valid2", "counts")], sr=sr, F_pad=u.F_pad)
    return st._merge_gather(ycand, d["merge_src"][l], dist.merge_fix[l], sr)[:dist.plan.R]


def _host_plans(A: CSR, n: int, balance: str, policy):
    plan = build_halo_plan(A, n, balance=balance)
    return plan, build_uniform_plans(A, plan, policy=policy)


def distribute_stream(A: CSR, mesh: ShardMesh, axis: str = "shards",
                      balance: str = "nnz",
                      policy=None) -> DistributedStreamSpMV:
    """Plan the stream-pipeline distributed SpMV (host NumPy, cached on
    A per shard count, balance and policy) and place the held shards'
    arrays on the mesh's device. Raises PlanCapacityError when a shard
    cannot fit the common geometry: callers fall back to
    `distribute_csr`."""
    n = mesh.n_shards
    if policy is None:
        from spmv_tpu_torch.ops.tuning import detect_chip, policy_for

        policy = policy_for(host_values(A.Ax).dtype.itemsize,
                            chip=detect_chip(mesh.device))
    plan, uni = plan_cache(A, ("dist_stream", n, balance, policy),
                           lambda: _host_plans(A, n, balance, policy))
    dev = {k: put_global(v, mesh) for k, v in uni.dev.items()
           if k not in ("fix_out", "fix_src")}
    dev["Ax"] = as_values(dev["Ax"], value_dtype(A.Ax))  # bfloat16's bits
    dev["own_valid"] = put_global(plan.idx_own >= 0, mesh)
    # owned window: idx_own is contiguous wherever valid (global row
    # own_starts+j lives at local slot own_starts+j-ftr), so one offset
    # per shard and the validity mask replace an R_out-wide gather
    gaps, merge_fix, own_off = [], [], []
    NBY = uni.dev["merge_src"].shape[1]
    for s in mesh.shard_ids:
        gaps.append([torch.from_numpy(gap_rows(
            uni.dev[f"sp{i}_pos"][s], m["sbt"], m["Q"],
            m["out_rows"] // m["K"])).to(mesh.device)
            for i, m in enumerate(uni.split_meta)])
        # the merge fixups of shard s per depth, padding (out == NBY) cut
        depths = []
        for fo, fs in zip(uni.dev["fix_out"][s], uni.dev["fix_src"][s]):
            live = fo < NBY
            if live.any():
                depths.append(tuple(torch.from_numpy(a[live].astype(np.int64))
                                    .to(mesh.device) for a in (fo, fs)))
        merge_fix.append(depths)
        v = np.nonzero(plan.idx_own[s] >= 0)[0]
        own_off.append(int(plan.idx_own[s][v[0]] - v[0]) if v.size else 0)
    return DistributedStreamSpMV(
        mesh=mesh, axis=axis, plan=plan, n_rows=A.n_rows, n_cols=A.n_cols,
        dev=dev, **_placement(plan, mesh, A.n_rows), uni=uni, gaps=gaps,
        merge_fix=merge_fix, own_off=own_off)
