"""K16's order written in NumPy (csrc/fold_kernels.cu), for the tests.

`k16_model` folds sorted segments as the kernel does.

B = 1 (fold_rows_kernel): tiles of THREADS x ITEMS consecutive elements.
In a tile each thread folds its ITEMS in order, a run from each
in-tile boundary; a warp scan of the threads' partials by shuffles d = 1,
..., 16; the warps' totals scanned the same way (d = 1, 2, 4); a thread's
first run, from before it, is the partial that runs into the thread
reduced with the run's own fold. Each tile publishes the partial of its
last segment and whether a segment starts in it; tile 32g + 31 publishes
group g's aggregate, a warp scan over the group's 32 tile records. The
tile where a segment that began earlier ends folds, one warp, its
predecessor's record, then the tiles of that record's group before it,
then whole groups' aggregates 32 a step, until a record holds the
segment's start, combining the steps earlier-first; the segment's value
is that carry reduced with the tile's own fold. y holds the identity
before the fold (the launcher's fill), and the model checks that every
segment is written exactly once.

B > 1 (fold_cols_kernel): chunks of ROWS consecutive rows, one column a
thread, each column's rows in order; a segment that is neither the
chunk's first nor its last is written; the first's and last's partials go
to a carry pair (the second neutral where the chunk holds one segment),
which the next level folds the same way until one chunk holds them all.

Sums of floating values in float64, min and max by torch.minimum's and
torch.maximum's rules in float32; integer sums wrap in the value's width;
the identity folded in before each segment's first element; y rounded
float64 -> float32 -> value dtype. int8, uint8, int16 and bool fold as
int32 and are narrowed back, as the wrapper does. It imports no JAX, so
the card's tests can hold K16 to it too.
"""

import numpy as np
import torch

THREADS, ITEMS, ROWS = 256, 8, 256  # FOLD_THREADS, FOLD_ITEMS, FOLD_ROWS
WARP = 32
LANES = 32  # FOLD_GROUP: tiles a group aggregate folds, records a look-back step reads
CODES = {"plus_times": 0, "min_plus": 1, "max_times": 2, "or_and": 3, "or_and_counting": 4}
NARROW = (torch.int8, torch.uint8, torch.int16, torch.bool)
NONE = np.iinfo(np.int64).min  # FOLD_NONE: no element there


def fold_ops(code: int, dtype=torch.float32):
    """(accumulator dtype, reduce(earlier, later), neutral item) of ring
    `code` on values of `dtype` (floating, int32 or int64)."""
    if not dtype.is_floating_point:
        info = np.iinfo(np.int64 if dtype == torch.int64 else np.int32)
        if code in (0, 4):
            return np.int64, (lambda e, l: e + l), 0
        if code == 1:
            return np.int64, (lambda e, l: np.where(l < e, l, e)), info.max
        return np.int64, (lambda e, l: np.where(l > e, l, e)), info.min
    if code in (0, 4):
        return np.float64, (lambda e, l: e + l), -0.0
    if code == 1:
        return np.float32, (lambda e, l: np.where((l != l) | (l < e), l, e)), np.inf
    return np.float32, (lambda e, l: np.where((l != l) | (l > e), l, e)), -np.inf


def _scan(v, f, ops, width):
    """The kernel's warp_scan: an inclusive segmented scan over the last
    axis by shuffles d = 1, 2, ... < width, earlier operand first."""
    acc_t, red, null = ops
    lane = np.arange(v.shape[-1])
    for d in (1, 2, 4, 8, 16, 32, 64):
        if d >= width:
            break
        ov, of = np.full_like(v, null), np.zeros_like(f)
        ov[..., d:], of[..., d:] = v[..., :-d], f[..., :-d]
        nv, nf = np.where(f, v, red(ov, v)), f | of
        v, f = np.where(lane >= d, nv, v).astype(acc_t), np.where(lane >= d, nf, f)
    return v, f


def _last(v, f):
    return v[..., -1], f[..., -1]


def _rows_fold(v, s, n_seg, ident, ops, threads, items, lanes):
    """fold_rows_kernel -> (y written as (rows, values), the rows each
    write covers)."""
    acc_t, red, null = ops
    n, T = v.size, threads * items
    nt = -(-n // T)
    pad = nt * T - n
    valid = (np.arange(nt * T) < n).reshape(nt, T)
    V = np.concatenate([v, np.full(pad, null, acc_t)]).reshape(nt, T)
    S = np.concatenate([s, np.full(pad, NONE, np.int64)]).reshape(nt, T)
    PID = np.concatenate([[NONE], s[:-1], np.full(pad, NONE, np.int64)]).reshape(nt, T)
    NID = np.concatenate([s[1:], np.full(pad + 1, NONE, np.int64)]).reshape(nt, T)
    k = np.arange(T)[None, :]
    head = valid & (S != PID)
    bnd = head | (valid & (k == 0))
    V = np.where(head, red(acc_t(ident), V), V).astype(acc_t)
    V3, B3, ok3 = (a.reshape(nt, threads, items) for a in (V, bnd, valid))
    # each thread's partial from its last in-tile boundary
    av, af = np.full((nt, threads), null, acc_t), np.zeros((nt, threads), bool)
    for i in range(items):
        x, b, ok = V3[..., i], B3[..., i], ok3[..., i]
        av = np.where(ok, np.where(b, x, red(av, x)), av).astype(acc_t)
        af = np.where(ok, b | af, af)
    # the warp scan, then warp 0's scan of the warps' totals
    W = threads // WARP
    iv, fv = _scan(av.reshape(nt, W, WARP), af.reshape(nt, W, WARP), ops, WARP)
    wv, wf = _scan(iv[..., -1].copy(), fv[..., -1].copy(), ops, W)
    pv, pf = np.full((nt, W), null, acc_t), np.zeros((nt, W), bool)
    pv[:, 1:], pf[:, 1:] = wv[:, :-1], wf[:, :-1]
    lane = np.arange(WARP)
    ev, ef = np.full_like(iv, null), np.zeros_like(fv)
    ev[..., 1:], ef[..., 1:] = iv[..., :-1], fv[..., :-1]
    pre = np.where(lane > 0, np.where(ef, ev, red(pv[..., None], ev)), pv[..., None])
    # each thread's runs: one from a boundary in it is its own fold; its
    # first run, from before it, is that partial reduced with its own fold
    pre = pre.astype(acc_t).reshape(nt, threads)
    cur = np.full((nt, threads), null, acc_t)
    seen = np.zeros((nt, threads), bool)
    ACC = np.empty((nt, threads, items), acc_t)
    for i in range(items):
        x, b = V3[..., i], B3[..., i]
        cur = np.where(b, x, red(cur, x)).astype(acc_t)
        seen = seen | b
        ACC[..., i] = np.where(seen, cur, red(pre, cur))
    ACC = ACC.reshape(nt, T)
    # the tiles' records, the full groups' aggregates
    rec_v, rec_f = wv[:, -1].copy(), head.any(axis=1)
    ng = nt // lanes
    grp_v, grp_f = _last(*_scan(rec_v[:ng * lanes].reshape(ng, lanes),
                                rec_f[:ng * lanes].reshape(ng, lanes), ops, WARP))
    # the look-back of each tile whose first segment began earlier and ends in it
    end = valid & (S != NID)
    s0, head0 = S[:, 0], head[:, 0]
    needs = ~head0 & (end & (S == s0[:, None])).any(axis=1)
    carry = np.full(nt, null, acc_t)

    def window(rv, rf, idx, ok):
        wv_, wf_ = np.full(lanes, null, acc_t), np.zeros(lanes, bool)
        wv_[ok], wf_[ok] = rv[idx[ok]], rf[idx[ok]]
        return _last(*_scan(wv_, wf_, ops, WARP))

    for t in np.nonzero(needs)[0]:
        cv, cf = rec_v[t - 1], bool(rec_f[t - 1])
        gb = (t - 1) - (t - 1) % lanes
        if not cf and t - 1 > gb:
            j = gb + np.arange(lanes)
            xv, xf = window(rec_v, rec_f, j, j < t - 1)
            cv, cf = red(acc_t(xv), acc_t(cv)), bool(xf)
        g = (t - 1) // lanes - 1
        while not cf and g >= 0:
            kk = g - lanes + 1 + np.arange(lanes)
            xv, xf = window(grp_v, grp_f, kk, kk >= 0)
            cv, cf = red(acc_t(xv), acc_t(cv)), bool(xf)
            g -= lanes
        carry[t] = cv
    c, kk = np.nonzero(end)
    es, ea = S[c, kk], ACC[c, kk]
    late = ~head0[c] & (es == s0[c])
    ea = np.where(late, red(carry[c], ea), ea).astype(acc_t)
    # each segment is written once, where it ends (y holds the identity
    # before the fold)
    named = (es >= 0) & (es < n_seg)
    assert np.unique(es[named]).size == named.sum(), "a segment is written twice"
    return es[named], ea[named]


def _cols_level(v, s, first, ident, ops, rows):
    """One level of fold_cols_kernel (v (m, B)) -> (S, valid, end, ACC)."""
    acc_t, red, null = ops
    m, B = v.shape
    nc = -(-m // rows)
    valid = (np.arange(nc * rows) < m).reshape(nc, rows)
    V = np.concatenate([v, np.full((nc * rows - m, B), null, acc_t)]).reshape(nc, rows, B)
    S = np.concatenate([s, np.full(nc * rows - m, -2, np.int64)]).reshape(nc, rows)
    prev = np.concatenate([[-1], s[rows - 1::rows][:nc - 1]]) if first else np.full(nc, -1)
    before = np.concatenate([prev[:, None], S[:, :-1]], axis=1)
    bnd = (np.arange(rows) == 0)[None, :] | (S != before)
    nxt_valid = np.concatenate([valid[:, 1:], np.zeros((nc, 1), bool)], axis=1)
    nxt = np.concatenate([S[:, 1:], S[:, -1:]], axis=1)
    end = valid & (~nxt_valid | (nxt != S))
    head = bnd & ((np.arange(rows) > 0)[None, :] | (prev[:, None] != S))
    acc = np.full((nc, B), null, acc_t)
    ACC = np.empty((nc, rows, B), acc_t)
    for r in range(rows):
        x = V[:, r]
        if first:
            x = np.where(head[:, r, None], red(acc_t(ident), x), x)
        acc = np.where(valid[:, r, None], np.where(bnd[:, r, None], x, red(acc, x)),
                       acc).astype(acc_t)
        ACC[:, r] = acc
    return S, valid, end, ACC


def _cols_fold(v, s, n_seg, ident, ops, rows):
    """fold_cols_kernel and its carry levels -> (rows, values) written."""
    acc_t, _, null = ops
    first, rs, vs = True, [], []
    while True:
        S, valid, end, ACC = _cols_level(v, s, first, ident, ops, rows)
        nc = S.shape[0]
        first_id = S[:, 0]
        last_id = S[np.arange(nc), valid.sum(1) - 1]
        c, k = np.nonzero(end)
        es, ea = S[c, k], ACC[c, k]
        carried = (nc > 1) & ((es == first_id[c]) | (es == last_id[c]))
        w = ~carried & (es >= 0) & (es < n_seg)
        rs.append(es[w])
        vs.append(ea[w])
        if nc == 1:
            return np.concatenate(rs), np.concatenate(vs)
        cv = np.full((2 * nc,) + v.shape[1:], null, acc_t)
        cs = np.repeat(first_id, 2)
        fst = carried & (es == first_id[c])
        cv[2 * c[fst]] = ea[fst]
        lst = carried & (es != first_id[c])
        cv[2 * c[lst] + 1], cs[2 * c[lst] + 1] = ea[lst], es[lst]
        v, s, first = cv, cs, False


def k16_model(vals: torch.Tensor, seg: torch.Tensor, n_segments: int, code: int,
              identity: float, perm=None, threads=THREADS, items=ITEMS, rows=ROWS,
              lanes=LANES) -> torch.Tensor:
    """K16 on CPU tensors, in its order: vals (n,) or (n, B) in float32,
    bfloat16, float16 or an integer dtype (row i is perm[i] where given),
    seg (n,) sorted -> (n_segments,) + vals.shape[1:] in vals' dtype.
    `threads`, `items`, `rows` and `lanes` model other tile, chunk and
    group sizes."""
    if vals.dtype in NARROW:
        ident = int(torch.full((), float(identity), dtype=vals.dtype))
        return k16_model(vals.to(torch.int32), seg, n_segments, code, ident, perm, threads,
                         items, rows, lanes).to(vals.dtype)
    ops = fold_ops(code, vals.dtype)
    acc_t = ops[0]
    if vals.dtype.is_floating_point:
        v = vals.float().numpy().astype(acc_t)
        ident = float(torch.tensor(identity, dtype=vals.dtype))
        y = np.full((n_segments,) + v.shape[1:], ident, np.float32)
    else:
        v = vals.numpy().astype(acc_t)
        ident = int(torch.full((), float(identity), dtype=vals.dtype))
        y = np.full((n_segments,) + v.shape[1:], ident, np.int64)
    if perm is not None:
        v = v[np.asarray(perm, np.int64)]
    s = np.asarray(seg, np.int64)
    if n_segments and s.size and not (v.ndim == 2 and v.shape[1] == 0):
        if v.ndim == 1:
            es, ea = _rows_fold(v, s, n_segments, ident, ops, threads, items, lanes)
        else:
            es, ea = _cols_fold(v, s, n_segments, ident, ops, rows)
        y[es] = ea.astype(y.dtype)
    return torch.from_numpy(y).to(vals.dtype)
