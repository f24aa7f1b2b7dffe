"""Planned paged gather: x[idx] for a flat index stream (K9).

Counterpart of `spmv_tpu/kernels/pgather.py`. The plan is the
reference's, copied (host NumPy plus the native route planner): the
stream is cut into 16384-element chunks; within a chunk, elements bucket
by idx mod 128 (their sublane in the reference's transposed x window
table) and bucket overflow past 128 lanes spills into a further round.
Per (chunk, round), slot (s, l) holds the l-th element of bucket s, with
`qlo` its lane within its 16384-column window and `qhi` its window (-1
on empty slots); an injective 3-stage route returns the slots' values to
the original positions, with liveness in bit 7 of the route's last
stage. `pages`, `pcnt` and `pmask` are the TPU kernel's window sweep
schedule; they stay in the plan, for parity with the reference, and K9
does not read them.

K9 (`_pgather_pass`, csrc/direct_kernels.cu) reads x in natural order:
the slot's element is x[qhi*16384 + qlo*128 + s], which is the
reference's x2d[qhi*128 + s, qlo] without building the swapped window
table. One CTA per chunk stages each round's route in shared memory and
gathers the slots in slot order, so every plan byte is read once,
coalesced. It moves values of any dtype it is instantiated for (float32,
bfloat16, float16) as their bits. `paged_gather(x, plan)` keeps the reference's contract:
x[idx] in stream order, 0 on dead slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.tile_ops import LANES, TILE, route3_batched
from spmv_tpu_torch.ops.routing import route_tiles

R_MAX = 4  # rounds; past this the stream is adversarially bucketed
# (e.g. all columns = c mod 128) and the caller keeps the plain gather


@dataclasses.dataclass
class PagedGatherPlan:
    n: int                # elements in the original stream
    n_chunks: int
    rounds: int
    k_max: int            # widest per-(chunk, round) page list
    n_w: int              # 16384-column windows of x
    # arrays: NumPy from the planner, tensors after .to(device)
    qlo: object           # (C*R*128, 128) uint8 lane within window
    qhi: object           # (C*R*128, 128) int32 window id (-1 dead)
    s1: object            # (C*R*128, 128) uint8 route stages
    s2: object
    s3: object            # bit 7 = original-position liveness
    pages: object         # (C*R, k_max) int32 windows the TPU sweeps
    pcnt: object          # (C*R,) int32 live pages per (chunk, round)
    pmask: object         # (C, ceil(n_w/32)) int32 window bitmap

    def to(self, device) -> "PagedGatherPlan":
        """The same plan with every array a tensor on `device`."""
        up = {f: torch.from_numpy(np.ascontiguousarray(getattr(self, f))).to(device)
              for f in ("qlo", "qhi", "s1", "s2", "s3", "pages", "pcnt", "pmask")}
        return dataclasses.replace(self, **up)


def build_paged_gather_plan(idx: np.ndarray, n_cols: int,
                            val_bytes: int = 4):
    """Plan x[idx] for a flat idx stream (-1 = dead slot, yields 0).

    Returns None past the reference's reach (more than 4096 windows, or
    bucket spill past R_MAX rounds): callers keep the plain gather.
    `val_bytes` is the reference's signature; the plan does not depend
    on it."""
    idx = np.asarray(idx).reshape(-1)
    n = idx.shape[0]
    if n == 0 or n_cols == 0:
        return None
    W = LANES * LANES
    n_w = -(-n_cols // W)
    if n_w > 4096:
        return None
    C = -(-n // TILE)
    pad = C * TILE - n
    idxp = np.concatenate(
        [idx.astype(np.int64), np.full(pad, -1, np.int64)])
    live = idxp >= 0
    pos = np.nonzero(live)[0]
    if pos.size == 0:
        return None
    chunk = pos // TILE
    sub = idxp[pos] % LANES
    # stable bucket fill: position within (chunk, sub)
    key = chunk * LANES + sub
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.searchsorted(key_s, key_s, side="left")
    pib = np.arange(pos.size) - starts  # position in bucket
    rnd = pib // LANES
    lane = pib % LANES
    R = int(rnd.max()) + 1
    if R > R_MAX:
        return None
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    rnd = rnd[inv]
    lane = lane[inv]

    qlo = np.zeros((C, R, LANES, LANES), np.uint8)
    qhi = np.full((C, R, LANES, LANES), -1, np.int32)
    src = np.full((C, R, TILE), -1, np.int32)
    w_of = idxp[pos] // W
    l_of = (idxp[pos] // LANES) % LANES
    qlo[chunk, rnd, sub, lane] = l_of.astype(qlo.dtype)
    qhi[chunk, rnd, sub, lane] = w_of.astype(qhi.dtype)
    src[chunk, rnd, pos % TILE] = (sub * LANES + lane).astype(np.int32)

    s1, s2, s3 = route_tiles(src.reshape(C * R, LANES, LANES), dedupe=False)
    s3 = s3.copy()
    s3.reshape(C * R, TILE)[...] |= (
        (src.reshape(C * R, TILE) >= 0).astype(np.uint8) << 7)

    # the TPU kernel's sweep schedule: per (chunk, round) distinct
    # windows, short lists padded by repeating their last page
    pages_l = []
    for c in range(C):
        for r in range(R):
            u = np.unique(qhi[c, r][qhi[c, r] >= 0])
            pages_l.append(u.astype(np.int32))
    k_max = max(max((p.size for p in pages_l), default=1), 1)
    pages = np.zeros((C * R, k_max), np.int32)
    pcnt = np.zeros((C * R,), np.int32)
    for i, p in enumerate(pages_l):
        pages[i, :p.size] = p
        if p.size:
            pages[i, p.size:] = p[-1]
        pcnt[i] = p.size
    n_words = -(-n_w // 32)
    pmask = np.zeros((C, n_words), np.int64)
    for c in range(C):
        touched = np.unique(qhi[c][qhi[c] >= 0])
        np.bitwise_or.at(pmask[c], touched // 32,
                         np.int64(1) << (touched % 32))
    pmask = pmask.astype(np.uint32).view(np.int32)

    return PagedGatherPlan(
        n=n, n_chunks=C, rounds=R, k_max=k_max, n_w=n_w,
        qlo=qlo.reshape(-1, LANES), qhi=qhi.reshape(-1, LANES),
        s1=s1.reshape(-1, LANES), s2=s2.reshape(-1, LANES),
        s3=s3.reshape(-1, LANES), pages=pages, pcnt=pcnt, pmask=pmask)


def _pgather_plain(x, qlo, qhi, s1, s2, s3, *, C, R):
    """Plain version of K9: each slot (s, l) of chunk c, round r takes
    x[qhi*16384 + qlo*128 + s] (0 where qhi < 0); each round's slots are
    routed back to stream positions, and a position takes the value of
    the round whose s3 bit 7 marks it live (0 if none) ->
    (C*128, 128), a move in x's dtype."""
    rows = C * R * LANES
    hi = qhi.long()
    s = (torch.arange(rows, device=x.device) % LANES)[:, None]
    flat = (hi * TILE + qlo.long() * LANES + s).clamp(min=0)
    acc = torch.where(hi >= 0, x[flat], 0.0)
    s3i = s3.to(torch.int32)
    routed = route3_batched(acc, s1, s2, s3i & 127).view(C, R, LANES, LANES)
    live = (s3i >> 7).view(C, R, LANES, LANES) > 0
    out = torch.zeros((C, LANES, LANES), dtype=x.dtype, device=x.device)
    for r in range(R):
        out = torch.where(live[:, r], routed[:, r], out)
    return out.reshape(C * LANES, LANES)


def _pgather_pass(x, qlo, qhi, s1, s2, s3, *, C, R):
    """K9: the planned gather of C chunks in R rounds from natural x
    (float32, bfloat16 or float16) -> (C*128, 128) in x's dtype, in
    stream order, 0 on dead positions; each value's bits moved."""
    if x.device.type == "cpu":
        return _pgather_plain(x, qlo, qhi, s1, s2, s3, C=C, R=R)
    if x.device.type != "cuda":
        raise ValueError(f"_pgather_pass: unsupported device {x.device}")
    dev = x.device
    rows = C * R * LANES
    code = _cuda.value_code(x, "K9 (pgather)")
    _cuda.expect(x, "x", x.dtype, (x.numel(),), dev)
    _cuda.expect(qlo, "qlo", torch.uint8, (rows, LANES), dev)
    _cuda.expect(qhi, "qhi", torch.int32, (rows, LANES), dev)
    for name, t in (("s1", s1), ("s2", s2), ("s3", s3)):
        _cuda.expect(t, name, torch.uint8, (rows, LANES), dev)
    for name, t in (("qlo", qlo), ("qhi", qhi), ("s1", s1), ("s2", s2), ("s3", s3)):
        if t.data_ptr() % 16:  # the kernel reads and stages them by 16 bytes
            raise ValueError(f"{name}: not 16-byte aligned")
    out = torch.empty((C * LANES, LANES), dtype=x.dtype, device=dev)
    rc = _cuda.lib().spmv_pgather(
        _cuda.ptr(x), x.numel(), _cuda.ptr(qlo), _cuda.ptr(qhi), _cuda.ptr(s1),
        _cuda.ptr(s2), _cuda.ptr(s3), _cuda.ptr(out), C, R, code, _cuda.stream(dev))
    _cuda.check(rc, "spmv_pgather")
    _pgather_pass.launches += 1
    return out


_pgather_pass.launches = 0


def paged_gather(x: torch.Tensor, plan: PagedGatherPlan) -> torch.Tensor:
    """x[idx] for the planned stream (plan on x's device); dead slots
    yield 0. Returns a flat (n,) tensor in the original stream order."""
    out = _pgather_pass(x.contiguous(), plan.qlo, plan.qhi, plan.s1, plan.s2,
                        plan.s3, C=plan.n_chunks, R=plan.rounds)
    return out.reshape(-1)[: plan.n]
