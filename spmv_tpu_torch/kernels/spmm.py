"""SpMM: Y = A (x) X for a CSR A and a dense X of shape (n_cols, B).

Counterpart of `spmv_tpu/kernels/spmm.py`, with its methods and its
thresholds:

- `window` (the default device path): the nonzeros sorted by column and
  cut into tiles of 128, each inside one 128-row window of X
  (`_plan_spmm_window`, the reference's plan, bit for bit). Per
  128-column block of X, K13 (`_spmm_window_pass`,
  csrc/spmm_kernels.cu) writes every nonzero's product row
  P[slot] = combine(ax, X[col, block]); K16 (`segment_reduce_sorted`,
  kernels/fold.py; plus-times summed in float64 in a fixed order) reads
  P through the plan's `perm` in CSR order and folds it into rows, the
  reference's XLA take and fold. Past
  nnz * 128 * 4 * 2.2 > 12e9 (the product buffer's cap) it raises
  PlanCapacityError.
- `stream`: the stream pipeline on the Kronecker expansion A (x) I_128,
  one call per column block. Past 64,000,000 expanded nonzeros it raises
  PlanCapacityError before building the expansion.
- `xla`: a row gather and `combine` (glue), then K16
  (`segment_reduce_sorted`).
- `auto`: `window`, else `xla` where the window path refuses the matrix.

The port reads X rows directly where the reference's K13 multiplies by a
one-hot matrix: on finite X the two agree; where X holds +-inf the port
gives the semiring oracle's values and the reference NaN (ROADMAP §3).
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import (CSR, as_values, float_values, host_values, is_bfloat16,
                                    widen16)
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv
from spmv_tpu_torch.kernels.tile_ops import LANES
from spmv_tpu_torch.ops.registry import (PlanCapacityError, as_input, plan_cache,
                                         resolve_val_dtype, torch_dtype)
from spmv_tpu_torch.ops.semiring import (PLUS_TIMES, USER_RING_CODE, Semiring,
                                         device_ring_code, segment_reduce_sorted)

STREAM_MAX_EXPANDED_NNZ = 64_000_000
WINDOW_MAX_PRODUCT_BYTES = 12e9  # against nnz * 128 * 4 * 2.2
SBT_SPMM = 8  # the reference's tiles per grid step; tile counts pad to it


def _check_X(A: CSR, X: torch.Tensor) -> None:
    if X.dim() != 2 or X.shape[0] != A.n_cols:
        raise ValueError(f"X must be (n_cols, B) = ({A.n_cols}, B); got "
                         f"{tuple(X.shape)}")


def _kron_expand(A: CSR) -> CSR:
    """A (x) I_128 as CSR: nonzero (r, j, v) becomes the 128 nonzeros
    (128r+c, 128j+c, v), rows in (r, c) order."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    lens = (Ap[1:] - Ap[:-1]).astype(np.int64)
    reps = np.repeat(lens, LANES)  # per (r, c) expanded-row length
    Ap2 = np.concatenate([[0], np.cumsum(reps)])
    starts = np.repeat(Ap[:-1], LANES)
    offs = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(Ap2[:-1], reps)
    src = np.repeat(starts, reps) + offs  # source nonzero of each entry
    c_of = np.repeat(np.tile(np.arange(LANES, dtype=np.int64), A.n_rows), reps)
    Aj2 = Aj[src] * LANES + c_of
    Ax2 = Ax[src]
    # expanded columns reach n_cols*128: int64 where int32 would wrap
    idx_dtype = (np.int32 if A.n_cols * LANES <= np.iinfo(np.int32).max
                 else np.int64)
    if is_bfloat16(A.Ax):
        Ax2 = as_values(Ax2, torch.bfloat16)
    return CSR(A.n_rows * LANES, A.n_cols * LANES, Ap2.astype(np.int64),
               Aj2.astype(idx_dtype), Ax2)


def spmm_stream(A: CSR, X, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Y = A (x) X by the stream pipeline on the Kronecker expansion."""
    X = as_input(X)
    _check_X(A, X)
    B = X.shape[1]
    Bp = -(-B // LANES) * LANES
    # refuse before the 128x expansion is built
    if A.nnz * LANES > STREAM_MAX_EXPANDED_NNZ:
        raise PlanCapacityError("matrix too large for the stream SpMM path")
    Ak: CSR = plan_cache(A, "spmm_kron", lambda: _kron_expand(A))
    Xp = torch.nn.functional.pad(X, (0, Bp - B))
    outs = []
    for vb in range(Bp // LANES):
        xv = Xp[:, vb * LANES:(vb + 1) * LANES].reshape(-1)
        yv = _stream_spmv(Ak, xv, semiring, StreamPolicy())
        outs.append(yv.reshape(A.n_rows, LANES))
    return torch.cat(outs, dim=1)[:, :B]


def _plan_spmm_window(A: CSR) -> dict:
    """Column-window tiling of the nonzeros, one per slot of a 128-slot
    tile: q (slot's row in its window), ax, xb (each tile's window),
    perm (the product row of each CSR rank), rows, n_tiles."""
    Aj = np.asarray(A.Aj, dtype=np.int64)
    nnz = Aj.shape[0]
    order = np.argsort(Aj, kind="stable")
    cols = Aj[order]
    win = (cols // LANES).astype(np.int64)
    uw, wstart = np.unique(win, return_index=True)
    counts = np.diff(np.append(wstart, nnz))
    tiles_per = -(-counts // LANES)
    T = int(tiles_per.sum())
    Tp = max(SBT_SPMM, -(-T // SBT_SPMM) * SBT_SPMM)

    t0 = np.concatenate([[0], np.cumsum(tiles_per)])[:-1]
    pos_in_w = np.arange(nnz) - np.repeat(wstart, counts)
    slot = ((np.repeat(t0, counts) + pos_in_w // LANES) * LANES
            + pos_in_w % LANES)

    q = np.zeros(Tp * LANES, dtype=np.int32)
    ax = np.zeros(Tp * LANES, dtype=np.float64)
    q[slot] = (cols % LANES).astype(np.int32)
    ax[slot] = float_values(A.Ax)[order]
    xb = np.zeros(Tp, dtype=np.int32)
    xb[:T] = np.repeat(uw, tiles_per).astype(np.int32)

    # CSR rank r lives at product row slot_of_rank[r]; ranks are
    # row-sorted, so P[slot_of_rank] is directly segment-reducible
    slot_of_rank = np.empty(nnz, dtype=np.int64)
    slot_of_rank[order] = slot
    return {"q": q.reshape(Tp, LANES), "ax": ax.reshape(Tp, LANES), "xb": xb,
            "perm": slot_of_rank, "rows": A.row_ids(), "n_tiles": Tp}


# K13's value dtypes: the floating ones; int32 and int64 under a built-in
# ring, the narrower integers widened to int32
_K13_DTYPES = tuple(_cuda.DTYPE_CODES)


def _spmm_window_plain(Xblk, ax, q, xb, *, sr):
    """Plain version of K13: P[t*128 + s, :] = combine(ax[t, s],
    Xblk[xb[t]*128 + q[t, s], :]) -> (T*128, 128); 2-byte values
    combined in float32 and rounded to Xblk's dtype once, as K13 does."""
    rows = (xb.long()[:, None] * LANES + q.long()).reshape(-1)
    return sr.combine(widen16(ax.reshape(-1, 1)), widen16(Xblk[rows])).to(Xblk.dtype)


def _spmm_window_pass(Xblk, ax, q, xb, *, sr):
    """K13: the product rows of every tile of 128 nonzeros from a
    (rows, 128) column block of X -> (T*128, 128).

    Xblk may be a column slice of a wider row-major matrix: the kernel
    takes its row stride (a multiple of 4, its start aligned to 4
    values). Xblk and ax are float32, bfloat16 or float16 (int32 and
    int64 too with a built-in ring), one dtype, and P is in it; q is (T, 128) int32, xb
    (T,) int32. int8, uint8, int16 and bool values, which the CPU takes
    too, go through the int32 body and are narrowed back: the ring's
    products and sums wrap in the narrow width as the truncated int32
    results do."""
    if Xblk.device.type == "cpu":
        return _spmm_window_plain(Xblk, ax, q, xb, sr=sr)
    if Xblk.device.type != "cuda":
        raise ValueError(f"_spmm_window_pass: unsupported device {Xblk.device}")
    lib, ring = device_ring_code(sr)
    if Xblk.dtype in _cuda.NARROW_INTS and ring != USER_RING_CODE:
        return _spmm_window_pass(Xblk.to(torch.int32), ax.to(torch.int32), q, xb,
                                 sr=sr).to(Xblk.dtype)
    dev = Xblk.device
    T = xb.shape[0]
    code = _cuda.value_code(Xblk, "K13 (spmm_window)", _K13_DTYPES + (
        tuple(_cuda.INT_CODES) if ring != USER_RING_CODE else ()))
    align = 4 * Xblk.element_size()  # the kernel reads 4 values a lane at once
    if (Xblk.dim() != 2 or Xblk.shape[1] != LANES or Xblk.stride(1) != 1
            or Xblk.stride(0) % 4 or Xblk.data_ptr() % align):
        raise ValueError(f"Xblk: {tuple(Xblk.shape)} {Xblk.dtype} strides "
                         f"{Xblk.stride()}, expected a (rows, 128) block with "
                         f"unit column stride, a row stride that is a multiple "
                         f"of 4 and a {align}-byte aligned start")
    _cuda.expect(ax, "ax", Xblk.dtype, (T, LANES), dev)
    _cuda.expect(q, "q", torch.int32, (T, LANES), dev)
    _cuda.expect(xb, "xb", torch.int32, (T,), dev)
    out = torch.empty((T * LANES, LANES), dtype=Xblk.dtype, device=dev)
    rc = lib.spmv_spmm_window(
        _cuda.ptr(Xblk), Xblk.stride(0), Xblk.shape[0], _cuda.ptr(ax),
        _cuda.ptr(q), _cuda.ptr(xb), _cuda.ptr(out), T, code, ring,
        _cuda.stream(dev))
    _cuda.check(rc, "spmv_spmm_window")
    _spmm_window_pass.launches += 1
    return out


_spmm_window_pass.launches = 0


def device_window_plan(A: CSR, val_dtype, device) -> dict:
    """The window plan of A, built once on the host and uploaded once per
    (value dtype, device); both cached on A."""
    plan = plan_cache(A, "spmm_window", lambda: _plan_spmm_window(A))
    perm = plan["perm"]
    if plan["n_tiles"] * LANES <= np.iinfo(np.int32).max:
        perm = perm.astype(np.int32)

    def upload():
        up = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in (("ax", plan["ax"]), ("q", plan["q"]),
                           ("xb", plan["xb"]), ("perm", perm), ("rows", plan["rows"]))}
        up["ax"] = up["ax"].to(torch_dtype(val_dtype))
        up["rows_pad"] = LANES * max(int(plan["xb"].max(initial=0)) + 1,
                                     -(-A.n_cols // LANES), 1)
        return up

    return plan_cache(A, ("spmm_window_dev", str(torch_dtype(val_dtype)), str(device)),
                      upload)


def spmm_window(A: CSR, X, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Y = A (x) X by the window product (K13); O(nnz) plan."""
    X = as_input(X)
    _check_X(A, X)
    val_dtype = tdtype = resolve_val_dtype(A, X)
    ident = float(semiring.identity_for(val_dtype))
    if A.nnz == 0 or A.n_cols == 0:
        return torch.full((A.n_rows, X.shape[1]), ident, dtype=tdtype, device=X.device)
    # the product buffer (T*128, 128) per column block, capped so that two
    # copies and the take fit in device memory
    if A.nnz * LANES * 4 * 2.2 > WINDOW_MAX_PRODUCT_BYTES:
        raise PlanCapacityError("matrix too large for the window SpMM path")
    dev = device_window_plan(A, val_dtype, X.device)
    B = X.shape[1]
    Bp = -(-B // LANES) * LANES
    # columns to whole blocks, rows to the window grid (xb indexes
    # 128-row blocks); each block is a strided view, read in place
    Xp = torch.nn.functional.pad(X.to(tdtype), (0, Bp - B, 0, dev["rows_pad"] - A.n_cols))
    outs = []
    for vb in range(Bp // LANES):
        P = _spmm_window_pass(Xp[:, vb * LANES:(vb + 1) * LANES], dev["ax"],
                              dev["q"], dev["xb"], sr=semiring)
        outs.append(segment_reduce_sorted(P, dev["rows"], A.n_rows, semiring, ident,
                                          perm=dev["perm"]))
    Y = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return Y[:, :B]


def spmm_xla(A: CSR, X, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Y = A (x) X by a row gather (glue) and a sorted segment reduction
    (K16)."""
    X = as_input(X)
    plan = plan_cache(A, ("spmm_xla", str(X.device)), lambda: {
        "rows": torch.from_numpy(np.ascontiguousarray(A.row_ids())).to(X.device),
        "Aj": torch.from_numpy(np.asarray(A.Aj, np.int64)).to(X.device),
        "Ax": as_input(A.Ax, X.device)})  # float64 values narrowed, as jnp.asarray
    prod = semiring.combine(plan["Ax"][:, None], X[plan["Aj"]])
    ident = float(semiring.identity_for(prod.dtype))
    return segment_reduce_sorted(prod, plan["rows"], A.n_rows, semiring, ident)


def spmm(A: CSR, X, semiring: Semiring = PLUS_TIMES,
         method: str = "auto") -> torch.Tensor:
    """Y = A (x) X for a dense X of shape (n_cols, B), on X's device (a
    host X on the card unless the process asked for the CPU, `as_input`;
    so for each method below).

    method: 'window' (the K13 product pass, the default device path),
    'stream' (the stream pipeline on the 128x Kronecker expansion; small
    matrices only), 'xla', or 'auto' (window where its plan can reach
    the matrix, else xla)."""
    X = as_input(X)
    # validated once here, so that auto falls back only on capacity
    # errors, never on a shape mistake
    _check_X(A, X)
    if method == "xla":
        return spmm_xla(A, X, semiring)
    if method == "stream":
        return spmm_stream(A, X, semiring)
    if method == "window":
        return spmm_window(A, X, semiring)
    try:
        return spmm_window(A, X, semiring)
    except PlanCapacityError:
        return spmm_xla(A, X, semiring)
