"""DIA (diagonal-format) SpMV: the kind for banded and stencil matrices.

Counterpart of `spmv_tpu/kernels/dia.py`. A diagonal-sparse matrix is a
few shifts: y[r] = reduce_d combine(A[r, r+d], x[r+d]) over a small
sorted set of offsets d, with absent slots masked to the ring's
identity. No column indices are read and nothing is routed. The
csr-vector kinds send every diagonal-sparse matrix here
(kernels/csr_vector.py), which is how CG solves a Poisson system.

The plan is the reference's, copied: `diag_profile` and
`build_dia_plan` emit the same `(vals, valid, diags)` bit for bit. K12
(`_dia_pass`, csrc/dia_kernels.cu) folds the diagonals in the plan's
order from the identity, in float32 whatever the value dtype (float32,
bfloat16, float16), y rounded to it once, 4 rows a thread, with every plan and x load of
a chunk of 8 diagonals in flight at once and the plan streamed past L2;
it gives the plain version's bits in every ring. The reference runs an XLA pass instead of its
Pallas kernel when an offset exceeds MAX_SHIFT, the reach of the TPU
kernel's on-chip x halo; both compute the same y in the same order, and
K12 reads x directly, so on the card it serves every diagonal set.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, float_values, host_values, is_bfloat16, widen16
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.ops.registry import plan_cache, register, resolve_val_dtype
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring, device_ring_code

MAX_DIAGS = 64          # diagonals before DIA stops being "regular"
MAX_FILL = 4.0          # DIA slots per nnz before padding outweighs
MAX_SHIFT = 8000        # the reference's Pallas halo (see the docstring)


def diag_profile(A: CSR):
    """(diags, fill) or None when the matrix is not diagonal-sparse."""
    if A.nnz == 0 or A.n_rows != A.n_cols:
        return None
    Ap = np.asarray(A.Ap, np.int64)
    Aj = np.asarray(A.Aj, np.int64)
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
    uniq = np.unique(Aj - rows)
    if uniq.size > MAX_DIAGS:
        return None
    fill = uniq.size * A.n_rows / max(A.nnz, 1)
    if fill > MAX_FILL:
        return None
    return uniq, fill


def build_dia_plan(A: CSR, diags: np.ndarray):
    """Dense per-diagonal values (D, n) and validity (D, n) int8, and the
    offsets as a tuple. Duplicate (row, col) entries are summed with +
    whatever the ring, as the reference's planner does."""
    Ap = np.asarray(A.Ap, np.int64)
    Aj = np.asarray(A.Aj, np.int64)
    # bfloat16 values, which NumPy cannot sum, are summed in float32
    Ax = float_values(A.Ax, np.float32) if is_bfloat16(A.Ax) else np.asarray(A.Ax)
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
    k = np.searchsorted(diags, Aj - rows)
    vals = np.zeros((diags.size, A.n_rows), Ax.dtype)
    valid = np.zeros((diags.size, A.n_rows), np.int8)
    np.add.at(vals, (k, rows), Ax)
    valid[k, rows] = 1
    return vals, valid, tuple(int(d) for d in diags)


def _dia_plain(vals, valid, x, offsets, *, sr):
    """Plain version of K12: y starts at the identity and, diagonal by
    diagonal in the plan's order, y = reduce(y, valid ? combine(vals[i],
    x[r + d_i]) : identity); 2-byte values in float32, y rounded to
    vals' dtype once, as K12 does."""
    v = widen16(vals)
    ident = float(sr.identity_for(v.dtype))
    n = vals.shape[1]
    diags = [int(d) for d in offsets.tolist()]
    lo, hi = max(-min(diags), 0), max(max(diags), 0)
    xp = torch.nn.functional.pad(widen16(x.to(vals.dtype)), (lo, hi))
    y = torch.full((n,), ident, dtype=v.dtype, device=vals.device)
    for i, d in enumerate(diags):
        xs = xp[lo + d:lo + d + n]
        y = sr.reduce(y, torch.where(valid[i] > 0, sr.combine(v[i], xs), ident))
    return y.to(vals.dtype)


def _dia_pass(vals, valid, x, offsets, *, sr):
    """K12: y (n,) from the DIA plan (vals (D, n) float32, bfloat16 or
    float16, valid (D, n) int8, offsets (D,) int32, all on x's device)
    and x (n,) of vals' dtype; y in that dtype."""
    if x.device.type == "cpu":
        return _dia_plain(vals, valid, x, offsets, sr=sr)
    if x.device.type != "cuda":
        raise ValueError(f"_dia_pass: unsupported device {x.device}")
    lib, ring = device_ring_code(sr)
    dev = x.device
    D, n = vals.shape
    if not 1 <= D <= MAX_DIAGS:
        raise ValueError(f"{D} diagonals; K12 takes 1 to {MAX_DIAGS}")
    code = _cuda.value_code(vals, "K12 (dia)")
    _cuda.expect(vals, "vals", vals.dtype, (D, n), dev)
    _cuda.expect(valid, "valid", torch.int8, (D, n), dev)
    _cuda.expect(x, "x", vals.dtype, (n,), dev)
    _cuda.expect(offsets, "offsets", torch.int32, (D,), dev)
    y = torch.empty((n,), dtype=vals.dtype, device=dev)
    rc = lib.spmv_dia(_cuda.ptr(vals), _cuda.ptr(valid), _cuda.ptr(x),
                      _cuda.ptr(offsets), _cuda.ptr(y), D, n, code, ring,
                      _cuda.stream(dev))
    _cuda.check(rc, "spmv_dia")
    _dia_pass.launches += 1
    return y


_dia_pass.launches = 0


def device_dia_plan(A: CSR, device, dtype=None):
    """A's DIA plan on `device` as (vals, valid, offsets int32), or None
    when A is not diagonal-sparse; vals cast to `dtype` where one is
    given. The profile and the host plan are built once, the upload once
    per device and the cast once per dtype; all cached on A."""
    prof = plan_cache(A, ("dia", "profile"), lambda: diag_profile(A))
    if prof is None:
        return None
    vals, valid, dtup = plan_cache(A, ("dia", "plan"), lambda: build_dia_plan(A, prof[0]))
    up = plan_cache(A, ("dia", "plan", str(device)), lambda: (
        torch.from_numpy(vals).to(device), torch.from_numpy(valid).to(device),
        torch.tensor(dtup, dtype=torch.int32, device=device)))
    if dtype is None or up[0].dtype == dtype:
        return up
    return plan_cache(A, ("dia", "plan", str(device), str(dtype)),
                      lambda: (up[0].to(dtype),) + up[1:])


@register("dia", supports_semiring=True,
          reference_analog="(none: beyond-reference diagonal-format "
                           "specialization for regular matrices)")
def _dia(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """DIA SpMV for diagonal-sparse matrices (K12); other matrices fall
    back to the stream pipeline, so the kind is total."""
    tdtype = resolve_val_dtype(A, x)
    plan = device_dia_plan(A, x.device, tdtype)
    if plan is None:
        from spmv_tpu_torch.kernels.stream import _stream_spmv
        from spmv_tpu_torch.ops.tuning import detect_chip, policy_for

        width = host_values(A.Ax).dtype.itemsize
        return _stream_spmv(A, x, semiring, policy_for(width, detect_chip(x.device)))
    vals, valid, offsets = plan
    return _dia_pass(vals, valid, x.to(tdtype).contiguous(), offsets, sr=semiring)
