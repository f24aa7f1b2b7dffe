"""K16: the sorted-segment fold on the device.

The reference folds sorted segments with `jax.ops.segment_sum`,
`segment_min` or `segment_max` (`spmv_tpu/ops/semiring.py:
segment_reduce_sorted`, :130), which XLA compiles into the same jit as
the Pallas kernel before it: Phase C of `kernels/ell.py:_ell_spmv_device`
(after K11), of `parallel/dist_spmv.py:_local_ell_matvec` (after K11') and
of `kernels/spmm.py:_spmm_window_pass` (after K13); alone in `xla`,
`spmm_xla`, `spmv_values` and the split-row fixup. There is no
`pallas_call` behind it. Here it is K16 (`segment_fold`,
csrc/fold_kernels.cu): y first takes the identity (a memset node, which
for B = 1 also resets the look-back records, allocated right after y);
then for B = 1 one launch in which tiles fold in a fixed order and the
tile where a segment ends folds its predecessors' published partials in
a fixed shape; for B > 1 chunks of rows and then carry levels. No atomics touch
a value, so y repeats bit for bit from call to call as the reference's
does.

`segment_fold` takes the caller's tensors as they are: seg int32 or
int64 (no per-call copy), and the window `spmm`'s `perm`, by which K16
reads K13's products in place. Its plain version is
`ops/semiring.py:_segment_reduce_plain` (float64 index_add_,
scatter_reduce, the scan of a user ring), which runs on a CPU tensor. On
a CUDA tensor a built-in ring launches K16 or raises; a user-defined ring
runs the plain version's segmented scan there, glue as the reference's
`associative_scan` is. Values are float32, bfloat16, float16, int32 or
int64 in the kernel; int8, uint8, int16 and bool, which the CPU folds too,
are widened to int32 for it and narrowed back (exact: a sum's wrap-around
survives two's-complement truncation, and min and max of widened values
are the same values). The scratch is allocated here with `torch.empty`
(for B = 1 in y's allocation, after y), sized from n, B, n_segments, the
ring and the dtype alone, so a call reads nothing on the host and
captures in a CUDA graph. Under autograd
(and `torch.func.jvp`) the plus-times fold is `_SegmentSum`, whose
backward is the gather g[seg] (the VJP of a segment sum, which XLA also
derives as a gather) and whose tangent is K16 again.
"""

from __future__ import annotations

import functools

import torch

from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.ops.semiring import (DEVICE_RINGS, OR_AND_COUNTING, PLUS_TIMES,
                                         Semiring, _segment_reduce_plain)

_INDEX_DTYPES = (torch.int32, torch.int64)
# the value dtypes K16 is instantiated for (the narrower integers fold as
# int32, _cuda.NARROW_INTS)
_VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64)


@functools.lru_cache(maxsize=None)
def _stored_identity(identity: float, dtype: torch.dtype):
    """(float, int) of the identity as `dtype` stores it, as the plain
    version's torch.full rounds or converts it: its value and its bits (a
    floating dtype), or 0.0 and its value (an integer dtype); on the host,
    so nothing is read from the card."""
    t = torch.full((), float(identity), dtype=dtype)
    if not dtype.is_floating_point:
        return 0.0, int(t)
    return float(t), int(t.view({2: torch.int16, 4: torch.int32}[t.element_size()]))


def _launch(vals: torch.Tensor, seg: torch.Tensor, n_segments: int, code: int,
            identity: float, perm) -> torch.Tensor:
    """One K16 call on the card (on the current stream) ->
    (n_segments,) + vals.shape[1:] in vals' dtype."""
    dev = vals.device
    if vals.dtype in _cuda.NARROW_INTS:
        wide = vals.to(torch.int32)
        ident = _stored_identity(float(identity), vals.dtype)[1]
        return _launch(wide, seg, n_segments, code, ident, perm).to(vals.dtype)
    dt = _cuda.value_code(vals, "K16 (segment_fold)", _VALUE_DTYPES)
    if vals.dim() not in (1, 2):
        raise ValueError(f"segment_fold: vals of shape {tuple(vals.shape)}, expected "
                         f"(n,) or (n, B)")
    n = seg.shape[0]
    for name, t in (("seg", seg), ("perm", perm)):
        if t is None:
            continue
        if t.device != dev or t.dtype not in _INDEX_DTYPES or t.dim() != 1 \
                or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"segment_fold: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected ({n},) int32 or int64, contiguous, "
                             f"on {dev}")
    B = 1 if vals.dim() == 1 else vals.shape[1]
    if perm is None and vals.shape[0] != n:
        raise ValueError(f"segment_fold: {vals.shape[0]} rows of vals, {n} segment ids")
    if perm is not None and B == 1:
        raise ValueError("segment_fold: perm takes (n, B) vals with B > 1")
    identf, identi = _stored_identity(float(identity), vals.dtype)
    shape = (n_segments,) + tuple(vals.shape[1:])
    if n_segments == 0 or B == 0:
        return torch.empty(shape, dtype=vals.dtype, device=dev)
    if n == 0:
        return torch.full(shape, identf if vals.dtype.is_floating_point else identi,
                          dtype=vals.dtype, device=dev)
    if (B == 1 and not vals.is_contiguous()) or (B > 1 and vals.stride(1) != 1):
        raise ValueError(f"segment_fold: vals strides {vals.stride()}, expected "
                         f"{'contiguous values' if B == 1 else 'a unit column stride'}")
    lib = _cuda.lib()
    nb = lib.spmv_fold_scratch_bytes(n, B, code, dt)
    if B == 1:
        # the scratch right after y (16-byte aligned), so that the one
        # memset that writes the identity into y also resets the records
        size = vals.element_size()
        at = -(-n_segments * size // 16) * 16 // size
        buf = torch.empty(at + nb // size, dtype=vals.dtype, device=dev)
        y, scratch = buf[:n_segments], buf[at:]
    else:
        y = torch.empty(shape, dtype=vals.dtype, device=dev)
        scratch = torch.empty(nb, dtype=torch.uint8, device=dev) if nb else None
    rc = lib.spmv_segment_fold(
        _cuda.ptr(vals), vals.stride(0) if vals.dim() == 2 else 1,
        None if perm is None else _cuda.ptr(perm),
        int(perm is not None and perm.dtype == torch.int64), _cuda.ptr(seg),
        int(seg.dtype == torch.int64), n, B, n_segments, identf, identi, _cuda.ptr(y),
        None if scratch is None else _cuda.ptr(scratch), nb, dt, code, _cuda.stream(dev))
    _cuda.check(rc, "spmv_segment_fold")
    segment_fold.launches += 1
    return y


class _SegmentSum(torch.autograd.Function):
    """K16's plus-times fold (identity 0) under autograd: the VJP is the
    gather g[seg], the JVP the fold of the tangent."""

    @staticmethod
    def forward(vals, seg, n_segments, code):
        return _launch(vals, seg, n_segments, code, 0.0, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.seg, ctx.n_segments, ctx.code = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.seg), None, None, None

    @staticmethod
    def jvp(ctx, dv, *_):
        # through apply again: under torch.func.jvp the tangent comes
        # wrapped, and apply hands forward the tensor it wraps
        return _SegmentSum.apply(dv, ctx.seg, ctx.n_segments, ctx.code)


def _differentiated(t: torch.Tensor) -> bool:
    """True where autograd or a torch.func transform follows `t`."""
    wrapped = getattr(torch._C._functorch, "is_functorch_wrapped_tensor", None)
    return (torch.is_grad_enabled() and t.requires_grad) or bool(wrapped and wrapped(t))


def segment_fold(vals: torch.Tensor, seg: torch.Tensor, n_segments: int, sr: Semiring,
                 identity, perm: torch.Tensor = None) -> torch.Tensor:
    """K16: y (n_segments,) + vals.shape[1:] with y[s] the ring's reduce
    of `identity` and every element i with seg[i] == s, in order; a
    segment no element names gets `identity`. vals (n,) or (n, B) in
    float32, bfloat16, float16 or an integer dtype (row i is perm[i] where
    `perm` is given, B > 1); seg (n,) sorted, int32 or int64. On a CPU tensor its plain
    version runs (perm taken by index_select); on a CUDA tensor a
    built-in ring launches K16 (one count a call) or raises."""
    code = next((c for c, ring in enumerate(DEVICE_RINGS) if sr is ring), None)
    if vals.device.type == "cpu" or code is None:
        v = vals if perm is None else vals.index_select(0, perm)
        return _segment_reduce_plain(v, seg, n_segments, sr, identity)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_fold: unsupported device {vals.device}")
    if _differentiated(vals):
        if (sr is not PLUS_TIMES and sr is not OR_AND_COUNTING) or perm is not None \
                or float(identity) != 0.0:
            raise NotImplementedError(
                f"segment_fold: differentiable on the card as a plus-times sum "
                f"from 0 only (ring {sr.name})")
        return _SegmentSum.apply(vals, seg, n_segments, code)
    return _launch(vals, seg, n_segments, code, identity, perm)


segment_fold.launches = 0
