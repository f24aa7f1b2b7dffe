"""K16's order written in NumPy (csrc/fold_kernels.cu), for the tests.

`k16_model` folds sorted segments as the kernel does: at each level,
chunks of THREADS x ITEMS consecutive elements (B = 1; each thread's ITEMS
in order, a warp scan of the threads' partials by shuffles d = 1, ..., 16,
the warps' totals folded in warp order, then each thread's elements again
from the partial that runs into them) or of ROWS consecutive rows, one
column a thread, each column's rows in order (B > 1); a segment that is
neither the chunk's first nor its last is written; the first's and last's
partials go to a carry pair (the second neutral where the chunk holds one
segment), which the next level folds the same way until one chunk holds
them all. Sums in float64, min and max by torch.minimum's and
torch.maximum's rules in float32; the identity folded in before each
segment's first element; y rounded float64 -> float32 -> value dtype. It
imports no JAX, so the card's tests can hold K16 to it too.
"""

import numpy as np
import torch

THREADS, ITEMS, ROWS = 256, 8, 256  # FOLD_THREADS, FOLD_ITEMS, FOLD_ROWS
WARP = 32
CODES = {"plus_times": 0, "min_plus": 1, "max_times": 2, "or_and": 3, "or_and_counting": 4}


def fold_ops(code: int):
    """(accumulator dtype, reduce(earlier, later), neutral item) of ring `code`."""
    if code in (0, 4):
        return np.float64, (lambda e, l: e + l), -0.0
    if code == 1:
        return np.float32, (lambda e, l: np.where((l != l) | (l < e), l, e)), np.inf
    return np.float32, (lambda e, l: np.where((l != l) | (l > e), l, e)), -np.inf


def _bounds(S, valid, prev):
    """Per chunk-local element: its predecessor's id (the chunk's first
    takes `prev`), whether a segment starts there in the chunk, and
    whether its segment's last element in the chunk is there."""
    before = np.concatenate([prev[:, None], S[:, :-1]], axis=1)
    k = np.arange(S.shape[1])
    bnd = (k == 0)[None, :] | (S != before)
    nxt_valid = np.concatenate([valid[:, 1:], np.zeros((S.shape[0], 1), bool)], axis=1)
    nxt = np.concatenate([S[:, 1:], S[:, -1:]], axis=1)
    end = valid & (~nxt_valid | (nxt != S))
    return before, bnd, end


def _rows_level(v, s, first, ident, ops, threads, items):
    """One level of fold_rows_kernel -> (S, valid, end, ACC): the value
    folded so far at every chunk-local element."""
    acc_t, red, null = ops
    m, C = v.size, threads * items
    nc = -(-m // C)
    valid = (np.arange(nc * C) < m).reshape(nc, C)
    V = np.concatenate([v, np.full(nc * C - m, null, acc_t)]).reshape(nc, C)
    S = np.concatenate([s, np.full(nc * C - m, -2, np.int64)]).reshape(nc, C)
    prev = np.concatenate([[-1], s[C - 1::C][:nc - 1]]) if first else np.full(nc, -1)
    _, bnd, end = _bounds(S, valid, prev)
    if first:
        head = bnd & ((np.arange(C) > 0)[None, :] | (prev[:, None] != S))
        V = np.where(head, red(acc_t(ident), V), V).astype(acc_t)
    V3, B3, ok3 = (a.reshape(nc, threads, items) for a in (V, bnd, valid))
    # each thread's partial from its last segment start
    av, af = np.full((nc, threads), null, acc_t), np.zeros((nc, threads), bool)
    for i in range(items):
        x, b, ok = V3[..., i], B3[..., i], ok3[..., i]
        av = np.where(ok, np.where(b, x, red(av, x)), av).astype(acc_t)
        af = np.where(ok, b | af, af)
    # the warp scan by shuffles, then the warps' totals in order
    W = threads // WARP
    iv, fv = av.reshape(nc, W, WARP), af.reshape(nc, W, WARP)
    lane = np.arange(WARP)
    for d in (1, 2, 4, 8, 16):
        ov, of = np.full_like(iv, null), np.zeros_like(fv)
        ov[..., d:], of[..., d:] = iv[..., :-d], fv[..., :-d]
        nv, nf = np.where(fv, iv, red(ov, iv)), fv | of
        iv, fv = np.where(lane >= d, nv, iv).astype(acc_t), np.where(lane >= d, nf, fv)
    pv, pf = np.full((nc, W), null, acc_t), np.zeros((nc, W), bool)
    for w in range(1, W):
        tv, tf = iv[:, w - 1, -1], fv[:, w - 1, -1]
        pv[:, w] = np.where(tf, tv, red(pv[:, w - 1], tv))
        pf[:, w] = tf | pf[:, w - 1]
    ev, ef = np.full_like(iv, null), np.zeros_like(fv)
    ev[..., 1:], ef[..., 1:] = iv[..., :-1], fv[..., :-1]
    pre = np.where(lane > 0, np.where(ef, ev, red(pv[..., None], ev)), pv[..., None])
    acc = pre.astype(acc_t).reshape(nc, threads)
    ACC = np.empty((nc, threads, items), acc_t)
    for i in range(items):
        x, b = V3[..., i], B3[..., i]
        acc = np.where(b, x, red(acc, x)).astype(acc_t)
        ACC[..., i] = acc
    return S, valid, end, ACC.reshape(nc, C)


def _cols_level(v, s, first, ident, ops, rows):
    """One level of fold_cols_kernel (v (m, B)) -> (S, valid, end, ACC)."""
    acc_t, red, null = ops
    m, B = v.shape
    nc = -(-m // rows)
    valid = (np.arange(nc * rows) < m).reshape(nc, rows)
    V = np.concatenate([v, np.full((nc * rows - m, B), null, acc_t)]).reshape(nc, rows, B)
    S = np.concatenate([s, np.full(nc * rows - m, -2, np.int64)]).reshape(nc, rows)
    prev = np.concatenate([[-1], s[rows - 1::rows][:nc - 1]]) if first else np.full(nc, -1)
    _, bnd, end = _bounds(S, valid, prev)
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


def k16_model(vals: torch.Tensor, seg: torch.Tensor, n_segments: int, code: int,
              identity: float, perm=None, threads=THREADS, items=ITEMS,
              rows=ROWS) -> torch.Tensor:
    """K16 on CPU tensors, in its order: vals (n,) or (n, B) in float32,
    bfloat16 or float16 (row i is perm[i] where given), seg (n,) sorted ->
    (n_segments,) + vals.shape[1:] in vals' dtype. `threads`, `items` and
    `rows` model other chunk sizes."""
    ops = fold_ops(code)
    acc_t, _, null = ops
    v = vals.float().numpy().astype(acc_t)
    if perm is not None:
        v = v[np.asarray(perm, np.int64)]
    s = np.asarray(seg, np.int64)
    ident = float(torch.tensor(identity, dtype=vals.dtype))
    y = np.full((n_segments,) + v.shape[1:], ident, np.float32)
    if n_segments == 0 or s.size == 0 or (v.ndim == 2 and v.shape[1] == 0):
        return torch.from_numpy(y).to(vals.dtype)
    first = True
    while True:
        if v.ndim == 1:
            S, valid, end, ACC = _rows_level(v, s, first, ident, ops, threads, items)
        else:
            S, valid, end, ACC = _cols_level(v, s, first, ident, ops, rows)
        nc = S.shape[0]
        first_id = S[:, 0]
        last_id = S[np.arange(nc), valid.sum(1) - 1]
        c, k = np.nonzero(end)
        es, ea = S[c, k], ACC[c, k]
        carried = (nc > 1) & ((es == first_id[c]) | (es == last_id[c]))
        w = ~carried & (es >= 0) & (es < n_segments)
        y[es[w]] = ea[w].astype(np.float32)
        if nc == 1:
            return torch.from_numpy(y).to(vals.dtype)
        cv = np.full((2 * nc,) + v.shape[1:], null, acc_t)
        cs = np.repeat(first_id, 2)
        fst = carried & (es == first_id[c])
        cv[2 * c[fst]] = ea[fst]
        lst = carried & (es != first_id[c])
        cv[2 * c[lst] + 1], cs[2 * c[lst] + 1] = ea[lst], es[lst]
        v, s, first = cv, cs, False
