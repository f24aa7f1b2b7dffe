"""Sparse triangular solve and ILU(0), level-scheduled.

Counterpart of `spmv_tpu/kernels/trisolve.py`. A triangular solve is
sequential along its dependency chains; the plan groups the rows into
levels (the wavefront method) such that every row's dependencies lie in
strictly earlier levels, padded to one (rows per level, nonzeros per
row) envelope. The host half (the levels, the solve plan and the ILU(0)
factorization) is the reference's, line for line, so its arrays are
the reference's bit for bit.

The device half is K14 (`_sptrsv_pass`, csrc/trisolve_kernels.cu): one
launch per triangular solve, a single CTA that walks the levels in order
with a barrier between them, as the reference's `lax.scan` walks them in
one device loop. Its plain version, `_sptrsv_plain`, is the same
arithmetic as a loop of torch ops per level: gather the x values a level
reads, sum the row in slot order from 0, subtract it from b and divide by
the diagonal, and scatter the results into an (n + 1)-slot x whose last
slot catches the padding rows. 2-byte values compute in float32 and are
rounded where x is written.

ILU(0): the no-fill incomplete factorization A ~= L @ U on A's pattern
((L@U)[i,j] == A[i,j] on every stored (i,j)). The factorization is a
sequential host computation (NumPy); the factors are CSRs whose solves
run on the device through `sptrsv`.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, widen16
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.ops.registry import as_input, plan_cache


# ---------------------------------------------------------------------------
# Level scheduling
# ---------------------------------------------------------------------------

def _levels(A: CSR, lower: bool):
    """Wavefront levels: level[i] = 1 + max(level of off-diagonal
    dependencies). Rows with no deps are level 0. Returns (level,
    order) with `order` grouping rows by level."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    n = A.n_rows
    level = np.zeros(n, dtype=np.int64)
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        cols = Aj[Ap[i]:Ap[i + 1]]
        deps = cols[cols < i] if lower else cols[cols > i]
        if deps.size:
            level[i] = level[deps].max() + 1
    return level


def _build_solve_plan(A: CSR, lower: bool, unit_diagonal: bool):
    """Pack rows per level into padded (PL, W) blocks.

    Per level l: rows_l (padded with -1), their off-diagonal column
    indices and values (padded), and the diagonal values. All levels
    share one (n_levels, PL, W) envelope, so one step serves every
    level. The values and diagonals are narrowed as the reference's
    `jnp.asarray` narrows them (float64 -> float32).
    """
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = np.asarray(A.Ax)
    n = A.n_rows
    level = _levels(A, lower)
    n_levels = int(level.max()) + 1 if n else 1
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(n_levels + 1))

    lens = Ap[1:] - Ap[:-1]
    # off-diagonal count per row
    offd = np.zeros(n, dtype=np.int64)
    diag = np.full(n, np.nan, dtype=np.float64)
    for i in range(n):
        cols = Aj[Ap[i]:Ap[i + 1]]
        vals = Ax[Ap[i]:Ap[i + 1]]
        m = cols < i if lower else cols > i
        offd[i] = int(m.sum())
        d = np.nonzero(cols == i)[0]
        if d.size:
            diag[i] = vals[d[0]]
    if not unit_diagonal and np.isnan(diag).any():
        missing = int(np.isnan(diag).sum())
        raise ValueError(
            f"triangular solve: {missing} rows have no stored diagonal "
            f"(pass unit_diagonal=True for implicit unit diagonals)")

    PL = max(int(np.diff(bounds).max()) if n else 1, 1)
    W = max(int(offd.max()) if n else 1, 1)

    rows = np.full((n_levels, PL), -1, dtype=np.int64)
    cols_p = np.zeros((n_levels, PL, W), dtype=np.int64)
    vals_p = np.zeros((n_levels, PL, W), dtype=Ax.dtype)
    diag_p = np.ones((n_levels, PL), dtype=Ax.dtype)
    for l in range(n_levels):
        rs = order[bounds[l]:bounds[l + 1]]
        rows[l, :rs.size] = rs
        for s, i in enumerate(rs):
            cols = Aj[Ap[i]:Ap[i + 1]]
            vals = Ax[Ap[i]:Ap[i + 1]]
            m = cols < i if lower else cols > i
            c, v = cols[m], vals[m]
            cols_p[l, s, :c.size] = c
            vals_p[l, s, :c.size] = v
            if not unit_diagonal:
                diag_p[l, s] = diag[i]
    return {
        "rows": torch.from_numpy(rows.astype(np.int32)),
        "cols": torch.from_numpy(cols_p.astype(np.int32)),
        "vals": as_input(vals_p),
        "diag": as_input(diag_p),
        "n_levels": n_levels,
    }


def _level_of_row0(rows: torch.Tensor) -> int:
    """The level whose slots write row 0, or -1 (no rows). K14 defers that
    write past the level's barrier: the level's padding slots read x[0]
    as it was before the level, as the reference's scan step does."""
    hit = (rows == 0).any(dim=1).nonzero()
    return int(hit[0, 0]) if hit.numel() else -1


def _solve_plan(A: CSR, lower: bool, unit_diagonal: bool) -> dict:
    """A's checks and solve plan, built once and cached on A."""

    def build():
        Ap = np.asarray(A.Ap, dtype=np.int64)
        Aj = np.asarray(A.Aj, dtype=np.int64)
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
        bad = (Aj > rows) if lower else (Aj < rows)
        if bad.any():
            side = "upper" if lower else "lower"
            raise ValueError(
                f"matrix has {int(bad.sum())} {side}-triangle entries; "
                f"sptrsv requires a triangular matrix")
        if A.n_rows != A.n_cols:
            raise ValueError("triangular solve requires a square matrix")
        return _build_solve_plan(A, lower, unit_diagonal)

    return plan_cache(A, ("sptrsv", lower, unit_diagonal), build)


def _sptrsv_plain(rows, cols, vals, diag, b, *, n):
    """Plain version of K14: x (n,) from the solve plan (rows (L, PL)
    int32, -1 on padding; cols (L, PL, W) int32; vals (L, PL, W) and diag
    (L, PL) of b's dtype) and b (n,). Level by level, in order, every slot
    reads x as it stands before the level: acc = 0, then acc += vals[w] *
    x[cols[w]] for w = 0..W-1; x[row] = (b[row] - acc) / diag, where a
    padding row reads b[0] and writes slot n. Padding slots (cols 0, vals
    0) multiply 0 * x[0], so NaN and +-inf spread as in the reference.
    2-byte values compute in float32 and x is rounded to their dtype where
    it is written, as K14 does."""
    L, PL, W = cols.shape
    x = torch.zeros(n + 1, dtype=vals.dtype, device=b.device)
    r = rows.long()
    bg = widen16(b)[r.clamp(min=0)]
    dst = torch.where(r >= 0, r, n)
    v, dg = widen16(vals), widen16(diag)
    for lev in range(L):
        xg = widen16(x[cols[lev].long()])                      # (PL, W)
        acc = torch.zeros(PL, dtype=v.dtype, device=b.device)
        for w in range(W):
            acc = acc + v[lev, :, w] * xg[:, w]
        x.index_copy_(0, dst[lev], ((bg[lev] - acc) / dg[lev]).to(x.dtype))
    return x[:n]


def _sptrsv_pass(rows, cols, vals, diag, b, *, n, l0):
    """K14: the level-scheduled triangular solve in one launch -> x (n,)
    of b's dtype (float32, bfloat16 or float16), on b's device; the
    arguments as `_sptrsv_plain` takes them, all on that device, and `l0`
    the level that writes row 0 (`_level_of_row0`). A CPU tensor runs the
    plain version."""
    if b.device.type == "cpu":
        return _sptrsv_plain(rows, cols, vals, diag, b, n=n)
    if b.device.type != "cuda":
        raise ValueError(f"_sptrsv_pass: unsupported device {b.device}")
    dev = b.device
    L, PL, W = cols.shape
    code = _cuda.value_code(b, "K14 (sptrsv)")
    _cuda.expect(b, "b", b.dtype, (n,), dev)
    _cuda.expect(rows, "rows", torch.int32, (L, PL), dev)
    _cuda.expect(cols, "cols", torch.int32, (L, PL, W), dev)
    _cuda.expect(vals, "vals", b.dtype, (L, PL, W), dev)
    _cuda.expect(diag, "diag", b.dtype, (L, PL), dev)
    x = torch.empty(n + 1, dtype=b.dtype, device=dev)
    if n == 0:
        return x[:0]
    rc = _cuda.lib().spmv_sptrsv(
        _cuda.ptr(rows), _cuda.ptr(cols), _cuda.ptr(vals), _cuda.ptr(diag),
        _cuda.ptr(b), _cuda.ptr(x), L, PL, W, n, l0, code, _cuda.stream(dev))
    _cuda.check(rc, "spmv_sptrsv")
    _sptrsv_pass.launches += 1
    return x[:n]


_sptrsv_pass.launches = 0


def sptrsv(A: CSR, b, lower: bool = True,
           unit_diagonal: bool = False) -> torch.Tensor:
    """Solve T x = b on b's device, where T is the `lower` (or upper)
    triangle stored in A (A must BE triangular; entries on the wrong side
    are a user error and raise). Matches
    scipy.sparse.linalg.spsolve_triangular. On the card it is one K14
    launch."""
    plan = _solve_plan(A, lower, unit_diagonal)
    b = as_input(b)
    if tuple(b.shape) != (A.n_rows,):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({A.n_rows},)")
    dev = b.device
    val_dtype = torch.promote_types(plan["vals"].dtype, b.dtype)
    d = plan_cache(A, ("sptrsv", lower, unit_diagonal, str(dev), val_dtype), lambda: {
        "rows": plan["rows"].to(dev), "cols": plan["cols"].to(dev),
        "vals": plan["vals"].to(dev, val_dtype), "diag": plan["diag"].to(dev, val_dtype),
        "l0": _level_of_row0(plan["rows"])})
    return _sptrsv_pass(d["rows"], d["cols"], d["vals"], d["diag"],
                        b.to(val_dtype).contiguous(), n=A.n_rows, l0=d["l0"])


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

def ilu0(A: CSR):
    """No-fill incomplete LU: returns (L, U) CSRs with
    L unit-lower-triangular (unit diagonal NOT stored) and U
    upper-triangular, such that (L @ U)[i, j] == A[i, j] on every
    stored position of A (the ILU(0) defining property).

    Host factorization (IKJ, sequential by nature); the factors' solves
    run on the device through sptrsv: the preconditioner apply
    M^-1 r = U^-1 (L^-1 r) is the recurring cost.
    """
    if A.n_rows != A.n_cols:
        raise ValueError("ilu0 requires a square matrix")
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    a = np.array(np.asarray(A.Ax), dtype=np.float64)  # working copy
    n = A.n_rows

    # position lookup per row: col -> nnz index. Duplicate stored
    # positions cannot be represented (SpMV sums them; a pattern map
    # cannot) — refuse rather than factor a different matrix.
    col_pos = [dict() for _ in range(n)]
    for i in range(n):
        for t in range(Ap[i], Ap[i + 1]):
            j = int(Aj[t])
            if j in col_pos[i]:
                raise ValueError(
                    f"ilu0: duplicate stored entry ({i}, {j}); "
                    f"sum duplicates before factorizing")
            col_pos[i][j] = t

    for i in range(n):
        if i not in col_pos[i]:
            raise ValueError(f"ilu0: row {i} has no stored diagonal")

    for i in range(n):
        # process row i's lower entries in increasing column order
        row = sorted(col_pos[i].items())
        for k, t_ik in row:
            if k >= i:
                break
            dkk = a[col_pos[k][k]]
            if dkk == 0.0:
                raise ZeroDivisionError(
                    f"ilu0: zero pivot at row {k}")
            a[t_ik] /= dkk
            lik = a[t_ik]
            for j, t_kj in col_pos[k].items():
                if j <= k:
                    continue
                t_ij = col_pos[i].get(j)
                if t_ij is not None:
                    a[t_ij] -= lik * a[t_kj]

    # split into L (strictly lower, unit diag implicit) and U (incl diag)
    val_dtype = np.asarray(A.Ax).dtype
    rows = np.repeat(np.arange(n, dtype=np.int64), Ap[1:] - Ap[:-1])
    lm = Aj < rows
    um = Aj >= rows
    from spmv_tpu_torch.formats import COO, coo_to_csr

    L = coo_to_csr(COO(n, n, rows[lm], Aj[lm], a[lm].astype(val_dtype)),
                   offset_dtype=np.int64)
    U = coo_to_csr(COO(n, n, rows[um], Aj[um], a[um].astype(val_dtype)),
                   offset_dtype=np.int64)
    return L, U


def ilu0_apply(L: CSR, U: CSR, r) -> torch.Tensor:
    """Preconditioner apply M^-1 r = U^-1 (L^-1 r), both solves
    level-scheduled on r's device: two K14 launches on the card."""
    y = sptrsv(L, r, lower=True, unit_diagonal=True)
    return sptrsv(U, y, lower=False, unit_diagonal=False)
