"""Semiring abstraction for generalized SpMV.

Counterpart of `spmv_tpu/ops/semiring.py`. A semiring provides

    initialize() -> identity of `reduce`
    combine(a_ij, x_j) -> product term
    reduce(acc, v) -> accumulation

as callables on torch tensors (elementwise, broadcasting). `reduce`
must be associative. The plain PyTorch versions of the kernels take any
such ring. The CUDA kernels are instantiated per built-in ring
(csrc/ring.cuh), and `device_ring_code` maps a ring, by object identity,
to its instantiation in the main library. A user-defined ring is traced
into CUDA source (ops/ring_codegen.py) and compiled into a library of its
own at its first CUDA call (kernels/_cuda.py:ring_lib).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    initialize: Callable[[], float]  # identity of reduce
    combine: Callable  # (a_ij, x_j) -> term
    reduce: Callable  # (acc, v) -> acc'   (associative)

    def identity_for(self, dtype) -> np.ndarray:
        """Identity value cast to a concrete NumPy dtype (±inf becomes
        the integer extreme for integer dtypes). A torch dtype is taken
        too; bfloat16, which NumPy lacks, gives the float32 value (every
        identity the rings use is exact in bfloat16)."""
        ident = self.initialize()
        if isinstance(dtype, torch.dtype):
            dtype = (np.float32 if dtype == torch.bfloat16
                     else torch.empty(0, dtype=dtype).numpy().dtype)
        dt = np.dtype(dtype)
        if np.isinf(ident) and dt.kind in "iu":
            info = np.iinfo(dt)
            return np.array(info.max if ident > 0 else info.min, dtype=dt)
        return np.array(ident, dtype=dt)

    def reduce_array(self, arr: torch.Tensor, axis=None) -> torch.Tensor:
        """Reduce a tensor along an axis (all of it for None) with this
        ring's reduce. The built-in rings, matched by identity, take
        torch's own reductions; any other ring a log-tree of its
        `reduce` over the axis."""
        if axis is None:
            arr, axis = arr.reshape(-1), 0
        if self is PLUS_TIMES:
            return arr.sum(dim=axis)
        if self is MIN_PLUS:
            return arr.amin(dim=axis)
        if self is MAX_TIMES or self is OR_AND:
            return arr.amax(dim=axis)
        arr = arr.movedim(axis, 0)
        n = arr.shape[0]
        while n > 1:
            half = n // 2
            merged = self.reduce(arr[:half], arr[half:2 * half])
            if n % 2:
                merged = torch.cat([merged, arr[2 * half:n]])
            arr = merged
            n = arr.shape[0]
        return arr[0]


# The conventional (+, x) ring.
PLUS_TIMES = Semiring(
    name="plus_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: acc + v,
)

# Tropical (min, +): shortest-path relaxation.
MIN_PLUS = Semiring(
    name="min_plus",
    initialize=lambda: float("inf"),
    combine=lambda a, x: a + x,
    reduce=lambda acc, v: torch.minimum(acc, v),
)

# (max, x): maximum-reliability paths.
MAX_TIMES = Semiring(
    name="max_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: torch.maximum(acc, v),
)


def _or_and_combine(a, x):
    """Boolean (or, and) combine on any data: (a != 0) AND (x != 0)
    as {0, 1} in the promoted value dtype."""
    t = (a != 0) & (x != 0)
    return t.to(torch.promote_types(a.dtype, x.dtype))


OR_AND = Semiring(
    name="or_and",
    initialize=lambda: 0.0,
    combine=_or_and_combine,
    reduce=lambda acc, v: torch.maximum(acc, v),
)

BUILTIN_SEMIRINGS = {
    s.name: s for s in (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
}

# or_and rides the plus-times kernels on float32 as a COUNTING ring:
# combine yields {0,1}, reduce is +, and the caller thresholds the
# counts at the end (or = sum > 0 over non-negatives). Its name is the
# reference's, whose kernels pick their plus-times bodies by name.
OR_AND_COUNTING = Semiring(
    name="plus_times",
    initialize=lambda: 0.0,
    combine=_or_and_combine,
    reduce=lambda acc, v: acc + v,
)

# The rings the CUDA kernels are instantiated on, in the order of the
# ring codes of csrc/ring.cuh.
DEVICE_RINGS = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND, OR_AND_COUNTING)


def segment_reduce_sorted(vals: torch.Tensor, seg: torch.Tensor,
                          n_segments: int, sr: Semiring, identity,
                          perm: torch.Tensor = None) -> torch.Tensor:
    """Reduce `vals` over sorted segment ids with the ring's reduce.

    vals: (n,) or (n, B); seg: (n,) non-decreasing ids < n_segments,
    int32 or int64. With `perm` (n,), element i is row perm[i] of vals
    (which then has any number of rows). Segments absent from `seg` yield
    `identity`. This is K16 (kernels/fold.py:segment_fold): on a CPU
    tensor its plain version (`_segment_reduce_plain`); on a CUDA tensor
    the kernel for a built-in ring, in a fixed order, so y repeats bit
    for bit; a user-defined ring's segmented scan on either."""
    from spmv_tpu_torch.kernels.fold import segment_fold

    return segment_fold(vals, seg, n_segments, sr, identity, perm=perm)


def _segment_reduce_plain(vals: torch.Tensor, seg: torch.Tensor,
                          n_segments: int, sr: Semiring,
                          identity) -> torch.Tensor:
    """Plain version of K16 (`segment_reduce_sorted`; the reference's
    sorted `jax.ops.segment_*`), for any ring, on any device. The
    built-in rings, matched by identity, take torch's scatter reductions:
    a sum by index_add_, min and max by scatter_reduce into a tensor that
    starts at `identity`, which folds the identity into every row as the
    oracle's acc = initialize() does (scatter_reduce's amin and amax keep
    the earlier of two equal operands and propagate NaN). A floating sum
    (plus-times, and the or-and counting ring, exact either way) of
    float32, bfloat16 or float16 values is taken in float64 and rounded
    to their dtype once (Tensor.to rounds float64 to float32, then to a
    2-byte dtype): a hub row's 1e4-1e5 products of mixed sign, summed in
    float32, drift past the float64 oracle's rtol 2e-4 where they cancel;
    in a 2-byte dtype every add would round as well (the reference sums
    in the value dtype in a fixed order). Any other ring runs a segmented
    inclusive scan (log2(n) steps, earlier operand first) and takes each
    segment's last element, with no fold, as the reference's generic path
    does; that scan is also what a user-defined ring runs on the card."""
    shape = (n_segments,) + tuple(vals.shape[1:])
    out = torch.full(shape, float(identity), dtype=vals.dtype, device=vals.device)
    if seg.shape[0] == 0:
        return out
    seg = seg.long()
    if sr is PLUS_TIMES or sr is OR_AND_COUNTING:
        if vals.dtype in (torch.float32, torch.bfloat16, torch.float16):
            return out.double().index_add_(0, seg, vals.double()).to(vals.dtype)
        return out.index_add_(0, seg, vals)
    red = ("amin" if sr is MIN_PLUS else
           "amax" if sr is MAX_TIMES or sr is OR_AND else None)
    if red is not None:
        idx = seg.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
        return out.scatter_reduce_(0, idx, vals, red, include_self=True)
    v, n, d = vals, seg.shape[0], 1
    while d < n:
        same = seg[d:] == seg[:-d]
        if v.dim() == 2:
            same = same[:, None]
        v = torch.cat([v[:d], torch.where(same, sr.reduce(v[:-d], v[d:]), v[d:])])
        d *= 2
    last = torch.ones(n, dtype=torch.bool, device=seg.device)
    last[:-1] = seg[1:] != seg[:-1]
    # each segment's last element into its row, every other element into
    # one row past the end, dropped: no boolean mask, whose size the host
    # would have to read, so a CUDA graph can capture the fold
    out = torch.cat([out, out[:1]])
    out.index_copy_(0, torch.where(last, seg, n_segments), v)
    return out[:n_segments]


# The ring code of a user-defined ring in its own library (csrc/ring.cuh)
USER_RING_CODE = 5


def device_ring_code(sr: Semiring) -> tuple:
    """(the kernel library, the ring code) of `sr` on the card.

    A built-in ring, matched by identity, takes the main library and its
    instantiation's code. A user-defined ring takes its own library, built
    at its first call from its traced callables (kernels/_cuda.py:
    ring_lib), and SPMV_RING_USER; one that leaves the traced menu raises
    NotImplementedError naming the operation (it runs on a CPU tensor)."""
    from spmv_tpu_torch.kernels import _cuda

    for code, ring in enumerate(DEVICE_RINGS):
        if sr is ring:
            return _cuda.lib(), code
    return _cuda.ring_lib(sr), USER_RING_CODE
