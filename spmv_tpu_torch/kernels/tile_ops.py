"""Plain PyTorch building blocks of the stream kernels.

Counterpart of the parts of `spmv_tpu/kernels/pallas_utils.py` (and of
`stream._flat_cumsum_batched`) that the ported stream kernels use.
These are what the kernels' plain versions are made of; the CUDA
kernels compute the same things in `csrc/route3.cuh` and beside it.

Layout: a stack of nt (128,128) tiles is an (nt*128, 128) tensor; a
route stage is the same shape in uint8.
"""

from __future__ import annotations

import torch

LANES = 128
TILE = LANES * LANES


def lane_iota(shape, device=None) -> torch.Tensor:
    """Index along the last (128-lane) dim, broadcast to `shape`."""
    return torch.arange(shape[-1], dtype=torch.int32, device=device).expand(shape)


def sublane_iota(shape, device=None) -> torch.Tensor:
    """Index along the second-to-last dim, broadcast to `shape`."""
    return torch.arange(shape[-2], dtype=torch.int32,
                        device=device)[:, None].expand(shape)


def flat_iota(shape, device=None) -> torch.Tensor:
    """Row-major flat index over the trailing (sublanes, lanes) dims."""
    return sublane_iota(shape, device) * shape[-1] + lane_iota(shape, device)


def _tile_transpose(a: torch.Tensor) -> torch.Tensor:
    nt = a.shape[0] // LANES
    return a.view(nt, LANES, LANES).transpose(1, 2).reshape(-1, LANES)


def route3_batched(v: torch.Tensor, s1, s2, s3) -> torch.Tensor:
    """3-stage tile routing over nt stacked (128,128) tiles: a lane
    gather by s1, a per-tile transpose, a lane gather by s2, a
    transpose, a lane gather by s3. Composed, for each tile,

        out[r, c] = v[s2[k, r], s1[s2[k, r], k]]   with k = s3[r, c],

    which is the form the CUDA kernels evaluate (csrc/route3.cuh)."""
    a = torch.gather(v, 1, s1.long())
    a = torch.gather(_tile_transpose(a), 1, s2.long())
    return torch.gather(_tile_transpose(a), 1, s3.long())


def flat_cumsum_tiles(v: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inclusive cumsum of each (128,128) tile of an (nt*128, 128)
    stack in row-major flat order, accumulated in `dtype` (default:
    v's dtype)."""
    nt = v.shape[0] // LANES
    return v.reshape(nt, TILE).cumsum(1, dtype=dtype).reshape(-1, LANES)


def segmented_scan_tile(v: torch.Tensor, seg: torch.Tensor,
                        reduce_fn) -> torch.Tensor:
    """Inclusive segmented scan of each (S, 128) tile (the trailing two
    dims; leading dims are a batch) in row-major order. `seg` holds
    non-decreasing segment ids in that order; the scan restarts where
    the id changes. Any associative `reduce_fn`, applied as
    reduce(later, earlier) as in pallas_utils.py:69.

    A Hillis-Steele scan over the flat order (log2(S*128) steps); the
    reference's lane phase plus sublane carry computes the same values.
    Equal ids at distance d mean one segment in between, because the
    ids do not decrease."""
    shape = v.shape
    n = shape[-2] * shape[-1]
    fv = v.reshape(-1, n)
    fs = seg.reshape(-1, n)
    d = 1
    while d < n:
        tail = fv[:, d:]
        upd = torch.where(fs[:, :-d] == fs[:, d:],
                          reduce_fn(tail, fv[:, :-d]), tail)
        fv = torch.cat([fv[:, :d], upd], dim=1)
        d *= 2
    return fv.reshape(shape)


def segmented_scan_lanes(v: torch.Tensor, head: torch.Tensor,
                         reduce_fn) -> torch.Tensor:
    """Inclusive segmented scan along the 128 lanes of each row only (no
    carry across rows), flag-based: `head` is nonzero at each segment's
    first lane. Any associative `reduce_fn`, applied as reduce(earlier,
    later) as in pallas_utils.py:126. Seven log steps, as the
    reference's."""
    f = head != 0
    d = 1
    while d < LANES:
        tail, ftail = v[..., d:], f[..., d:]
        upd = torch.where(ftail, tail, reduce_fn(v[..., :-d], tail))
        v = torch.cat([v[..., :d], upd], dim=-1)
        f = torch.cat([f[..., :d], ftail | f[..., :-d]], dim=-1)
        d *= 2
    return v
