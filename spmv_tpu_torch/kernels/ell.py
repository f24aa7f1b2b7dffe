"""ELL-style packed row execution: the shared machinery of the
csr-vector and LightSpMV direct kinds.

Counterpart of `spmv_tpu/kernels/ell.py`. Rows are cut into chunks of W
nonzeros ("virtual rows"), packed densely into (8, 128) tiles (128/W
chunks per 128-lane row). One call runs three phases:

A. the x read (torch glue, as it is XLA in the reference): the planned
   paged gather (K9, kernels/pgather.py) where the plan has one, else
   `x[aj]`; then `combine` and the ring's identity on invalid slots;
B. K11 (`_group_reduce_pass`, csrc/direct_kernels.cu): each W-lane group
   reduced to its leader, by the `linear`, `tree` or `broadcast`
   strategy, the leaders written compactly in chunk order;
C. the leaders, one per chunk, folded into rows by K16
   (`segment_reduce_sorted`, kernels/fold.py; plus-times summed in
   float64 in a fixed order), as the reference's XLA fold ends its jit.

The planner is the reference's, copied: `build_ell_plan` emits the same
arrays, bit for bit, native planner on or off
(tests/test_torch_direct.py), as NumPy; `EllPlan.to(device)` uploads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, as_values, host_values, value_dtype, widen16
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.pgather import build_paged_gather_plan, paged_gather
from spmv_tpu_torch.kernels.tile_ops import LANES
from spmv_tpu_torch.ops.registry import float_val_dtype, plan_cache, resolve_val_dtype
from spmv_tpu_torch.ops.semiring import (Semiring, device_ring_code,
                                         segment_reduce_sorted)

SUBLANES = 8
STRATEGIES = ("linear", "tree", "broadcast")  # K11's codes 0, 1, 2


@dataclasses.dataclass
class EllPlan:
    """Packed chunks for one (row subset, W). Arrays are NumPy from the
    planner and tensors after `.to(device)`."""

    width: int  # W, lanes per chunk (power of two <= 128)
    n_vrows: int  # valid chunk count V
    n_tiles: int  # Tv
    aj: object  # (Tv, 8, 128) int32
    ax: object  # (Tv, 8, 128) values
    valid: object  # (Tv, 8, 128) bool
    vrow_row: object  # (V,) int32 global row of each chunk
    # planned paged gather of phase A (None = the plain x[aj] gather)
    pgather: object = None

    def to(self, device) -> "EllPlan":
        up = {f: torch.from_numpy(np.ascontiguousarray(getattr(self, f))).to(device)
              for f in ("aj", "ax", "valid", "vrow_row")}
        pg = self.pgather.to(device) if self.pgather is not None else None
        return dataclasses.replace(self, pgather=pg, **up)


def build_ell_plan(A: CSR, rows: np.ndarray, width: int) -> EllPlan:
    """Pack the given rows' nonzeros at W=width lanes per chunk
    (`pack_ell`), with the paged-gather plan of their x read."""
    p = pack_ell(A, rows, width)
    pg = build_paged_gather_plan(
        np.where(p.valid, p.aj.astype(np.int64), -1).reshape(-1),
        A.n_cols, host_values(A.Ax).dtype.itemsize if A.nnz else 4)
    return dataclasses.replace(p, pgather=pg)


def pack_ell(A: CSR, rows: np.ndarray, width: int) -> EllPlan:
    """Pack the given rows' nonzeros at W=width lanes per chunk, with no
    paged-gather plan (pgather None): what a caller that reads x itself
    needs (K11', parallel/dist_spmv.py).

    rows: sorted array of global row indices to pack (a bin, or all
    rows). Rows are cut into ceil(len/W) chunks (min 1, so empty rows
    still yield an identity-valued chunk)."""
    W = width
    assert W & (W - 1) == 0 and 1 <= W <= LANES
    G = LANES // W  # chunks per lane-row
    slots_per_tile = SUBLANES * G

    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    rows = np.asarray(rows, dtype=np.int64)

    # native chunk walk when available (native/host.cpp spmv_ell_fill);
    # the NumPy fallback below emits the same arrays
    k = valid = vrow_row = None
    try:
        from spmv_tpu_torch import native

        if native.available():
            k, valid, vrow_row = native.ell_chunks(rows, Ap, W, int(Ap[-1]))
    except (NotImplementedError, ValueError):
        k = None
    if k is None:
        lens = Ap[rows + 1] - Ap[rows]
        n_chunks = np.maximum((lens + W - 1) // W, 1)
        V = int(n_chunks.sum())
        vrow_row = np.repeat(rows, n_chunks)
        chunk_in_row = np.arange(V, dtype=np.int64) - np.repeat(
            np.cumsum(n_chunks) - n_chunks, n_chunks)
        k = (np.repeat(Ap[vrow_row] + chunk_in_row * W, W).reshape(V, W)
             + np.arange(W, dtype=np.int64)[None, :])
        k_end = np.repeat(Ap[vrow_row + 1], W).reshape(V, W)
        valid = k < k_end
        k = np.minimum(k, max(int(Ap[-1]) - 1, 0))
        vrow_row = vrow_row.astype(np.int32)
    V = vrow_row.shape[0]
    Tv = max((V + slots_per_tile - 1) // slots_per_tile, 1)
    V_pad = Tv * slots_per_tile
    if int(Ap[-1]) == 0:  # empty matrix: all slots invalid
        aj = np.zeros((V, W), np.int32)
        ax = np.zeros((V, W), Ax.dtype if Ax.size else np.float32)
    else:
        aj = np.where(valid, Aj[k], 0).astype(np.int32)
        ax = np.where(valid, Ax[k], 0).astype(Ax.dtype)

    def pad_tiles(arr, fill):
        out = np.full((V_pad, W), fill, dtype=arr.dtype)
        out[:V] = arr
        # slot = ((t*8 + s)*G + g), lanes [g*W, (g+1)*W)
        return out.reshape(Tv, SUBLANES, G, W).reshape(Tv, SUBLANES, LANES)

    return EllPlan(width=W, n_vrows=V, n_tiles=Tv, aj=pad_tiles(aj, 0),
                   ax=pad_tiles(ax, 0), valid=pad_tiles(valid, False),
                   vrow_row=vrow_row.astype(np.int32))


def device_ell_plan(A: CSR, key: tuple, rows_fn, width: int, device) -> EllPlan:
    """The ELL plan of (A, key), built once on the host (rows_fn() gives
    its rows) and uploaded once per device; both cached on A."""
    host = plan_cache(A, key, lambda: build_ell_plan(A, rows_fn(), width))
    return plan_cache(A, key + (str(device),), lambda: host.to(device))


def _group_reduce_plain(prod, *, W, strategy, sr):
    """Plain version of K11 on a (rows, 128) tensor: the reference's roll
    loops. `linear` folds lanes 1..W-1 of each group into its leader in
    order; `tree` takes d = W/2, ..., 1 with lane j < d of each group
    taking reduce(v[j], v[j+d]); `broadcast` is `tree` with the leader
    then copied to every lane of its group. 2-byte values are reduced in
    float32 and rounded to prod's dtype once, as K11 does."""
    lanes = torch.arange(LANES, device=prod.device) % W
    v = widen16(prod)
    if strategy == "linear":
        acc = v
        for d in range(1, W):
            acc = torch.where(lanes == 0, sr.reduce(acc, torch.roll(v, -d, 1)), acc)
        return acc.to(prod.dtype)
    d = W // 2
    while d >= 1:
        v = torch.where(lanes < d, sr.reduce(v, torch.roll(v, -d, 1)), v)
        d //= 2
    if strategy == "broadcast":
        d = 1
        while d < W:
            v = torch.where(lanes >= d, torch.roll(v, d, 1), v)
            d *= 2
    return v.to(prod.dtype)


def _group_reduce_pass(prod, *, W, strategy, sr):
    """K11: reduce each W-lane group of a (Tv*8, 128) product stream
    (float32, bfloat16 or float16) to its leader -> (Tv*8, 128/W) in
    prod's dtype, the leaders in the order of the plain version's
    `[:, ::W]`.

    Each leader is reduced in the reference's order (see the plain
    version), so every ring gives the plain version's bits; `broadcast`
    yields the same leaders as `tree` (the plain version's copies of the
    leader to the other lanes of its group are not produced: nothing
    reads them)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if W & (W - 1) or not 1 <= W <= LANES:
        raise ValueError(f"W={W} is not a power of two in [1, 128]")
    if prod.device.type == "cpu":
        return _group_reduce_plain(prod, W=W, strategy=strategy, sr=sr)[:, ::W].contiguous()
    if prod.device.type != "cuda":
        raise ValueError(f"_group_reduce_pass: unsupported device {prod.device}")
    lib, ring = device_ring_code(sr)
    dev = prod.device
    if prod.dim() != 2 or prod.shape[1] != LANES or prod.shape[0] % SUBLANES:
        raise ValueError(f"prod: shape {tuple(prod.shape)}, expected "
                         f"(Tv*8, 128)")
    code = _cuda.value_code(prod, "K11 (group_reduce)")
    _cuda.expect(prod, "prod", prod.dtype, tuple(prod.shape), dev)
    if prod.data_ptr() % 16:  # the kernel reads it by 4 lanes a thread
        raise ValueError("prod: not 16-byte aligned")
    out = torch.empty((prod.shape[0], LANES // W), dtype=prod.dtype, device=dev)
    rc = lib.spmv_group_reduce(
        _cuda.ptr(prod), _cuda.ptr(out), prod.shape[0] // SUBLANES, W,
        STRATEGIES.index(strategy), code, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_group_reduce")
    _group_reduce_pass.launches += 1
    return out


_group_reduce_pass.launches = 0


def ell_products(A: CSR, x: torch.Tensor, semiring: Semiring,
                 plan: EllPlan) -> torch.Tensor:
    """Phase A: the x read (K9 where the plan has a paged gather), the
    ring's combine, and its identity on invalid slots -> (Tv*8, 128)."""
    val_dtype = tdtype = float_val_dtype(A, x, "the ELL kinds")
    xv = x.to(tdtype)
    if plan.pgather is not None:
        xg = paged_gather(xv, plan.pgather).view(plan.aj.shape)
    elif xv.numel():
        xg = xv[plan.aj.long()]
    else:  # no columns: every slot is invalid
        xg = torch.zeros(plan.aj.shape, dtype=tdtype, device=x.device)
    prod = semiring.combine(as_values(plan.ax, value_dtype(A.Ax)).to(tdtype), xg)
    ident = float(semiring.identity_for(val_dtype))
    return torch.where(plan.valid, prod, ident).reshape(-1, LANES).contiguous()


def ell_spmv(A: CSR, x: torch.Tensor, semiring: Semiring, plan: EllPlan,
             strategy: str) -> torch.Tensor:
    """y = A (x) x over the rows of `plan` (on x's device); rows outside
    it get the ring's identity."""
    prod = ell_products(A, x, semiring, plan)
    # phase B: K11, one leader per chunk
    leaders = _group_reduce_pass(prod, W=plan.width, strategy=strategy, sr=semiring)
    # phase C: chunk values -> rows
    y_vrow = leaders.reshape(-1)[:plan.n_vrows]
    ident = float(semiring.identity_for(resolve_val_dtype(A, x)))
    return segment_reduce_sorted(y_vrow, plan.vrow_row, A.n_rows, semiring, ident)


def select_width(mean_nnz_per_row: float,
                 table=((2, 2), (4, 4), (8, 8), (16, 16))) -> int:
    """Threads-per-row heuristic of the reference (ref: cusp.cuh:187-222):
    mean nnz/row <=2 -> 2, <=4 -> 4, <=8 -> 8, <=16 -> 16, <=64 -> 32,
    <=128 -> 64, else 128."""
    for bound, width in table:
        if mean_nnz_per_row <= bound:
            return width
    if mean_nnz_per_row <= 64:
        return 32
    if mean_nnz_per_row <= 128:
        return 64
    return 128
