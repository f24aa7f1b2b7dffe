"""Multi-device SpMV over a shard mesh: the halo exchange and K11'.

Counterpart of `spmv_tpu/parallel/dist_spmv.py`, where the body runs in
`shard_map`; here it is enqueued from Python over a `ShardMesh`
(parallel/bootstrap.py), and replayed as one CUDA graph on the card (see
"One graph a call" below), every shard-stacked tensor with a leading axis
of the shards this process holds (all of them on a local mesh, one on
a process-group mesh).

- **Halo-compacted exchange**: the plan (partition.build_halo_plan)
  knows which x entries each shard reads from each owner; the run-time
  exchange is ONE all-to-all of values sized by the halo, with remote
  column indices remapped at plan time into halo-table coordinates.
- **Self and halo blocks**: each shard's nonzeros split into a SELF
  block (owned columns, no dependency on the exchange) and a HALO block
  (columns from the received table); y = reduce(y_self, y_halo).
- **The exchange overlaps the self block**, in the reference's order
  (its exchange, then y_self, then y_halo, which XLA's scheduler runs
  concurrently): `_matvec_eager` gathers the send payload, starts the
  collective (`ShardMesh.start_all_to_all`, or `start_all_gather` in
  'allgather' mode), runs the self block, then joins the collective
  (under NCCL a stream wait, which a capture records as a fork and a
  join, so the replayed graph has no path between the exchange and the
  self block) and runs the halo block.
- **K11'** (`_local_ell_pass`, csrc/dist_kernels.cu): each block is an
  ELL packing per shard; one launch covers that block on every held
  shard: the x read, the ring's combine and the `tree` group reduce,
  leaders written compactly. The leaders' fold into rows is K16
  (`segment_reduce_sorted`, kernels/fold.py); the reduce of the two
  blocks and the exchange stay torch glue, as they are XLA in the
  reference.
- **Split rows**: a row cut across shards is finished by a
  one-value-per-shard all-gather of the boundary partials, grouped by
  row in NumPy at plan time.

`mode="allgather"` gathers every column instead of the halo (the
baseline the halo exchange is measured against).

What `matvec` returns: on a local mesh, the global y (n_rows,); on a
process-group mesh, this rank's owned rows
[row_starts[rank], row_starts[rank+1]).

One graph a call on the card: the reference compiles each matvec into
one program (`jax.jit` over `shard_map`); here, on a mesh on the card,
`matvec` replays one CUDA graph per (ring, mode, x dtype, x layout:
global (n_cols,) or sharded (n_local, B)), kept on the object
(`graphs`). The first call for a key runs the body eagerly
(`_matvec_eager`: plans, value casts and ring libraries are made there)
and then captures it (`utils/timing.py:capture_graph`, which raises,
naming the call, when the capture fails); a later call copies x into the
graph's static input, replays, and returns a copy of the graph's y, so
that no later call changes an earlier y. A mesh on the CPU runs the body
eagerly. A process-group mesh on the card takes the graph too: NCCL's
`all_to_all_single` and `all_gather` capture (every rank captures the
same collectives in the same order, as it calls them eagerly).

Values: A's may be float32, bfloat16 or float16, and so may x. As in the
reference, the compute dtype is x's (after `as_input`'s narrowing of
float64) and A's values are cast to it (`ax.astype(x.dtype)`), once per
compute dtype, cached on the object; y is in x's dtype. The exchange and
the all-gather carry values of that dtype as they are: NCCL and gloo
both take bfloat16 and float16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.formats import COO, CSR, as_values, coo_to_csr, value_dtype, widen16
from spmv_tpu_torch.kernels import _cuda
from spmv_tpu_torch.kernels.ell import SUBLANES, _group_reduce_plain, pack_ell
from spmv_tpu_torch.kernels.tile_ops import LANES
from spmv_tpu_torch.ops.registry import as_input, plan_cache
from spmv_tpu_torch.ops.semiring import (
    PLUS_TIMES,
    Semiring,
    device_ring_code,
    segment_reduce_sorted,
)
from spmv_tpu_torch.parallel.bootstrap import ShardMesh, put_global
from spmv_tpu_torch.parallel.partition import HaloPlan, build_halo_plan

# The value dtypes the multi-device layer computes in (x's dtype)
VALUE_DTYPES = tuple(_cuda.DTYPE_CODES)


def check_x_dtype(x: torch.Tensor) -> None:
    """Raise ValueError unless x (after `as_input`) is of a value dtype
    the layer computes in."""
    if x.dtype not in VALUE_DTYPES:
        raise ValueError(f"x: dtype {x.dtype}; the multi-device layer computes "
                         f"in {', '.join(str(d) for d in VALUE_DTYPES)}")


def _stack_ell(plans, R):
    """Stack per-shard EllPlans, padded to uniform (Tv, V)."""
    Tv = max(p.n_tiles for p in plans)
    V = max(p.n_vrows for p in plans)
    n = len(plans)
    W = plans[0].width
    aj = np.zeros((n, Tv, SUBLANES, LANES), np.int32)
    ax = np.zeros((n, Tv, SUBLANES, LANES), np.asarray(plans[0].ax).dtype)
    valid = np.zeros((n, Tv, SUBLANES, LANES), bool)
    vrow = np.full((n, V), R, np.int32)  # pad rows -> segment R (dropped)
    for s, p in enumerate(plans):
        aj[s, :p.n_tiles] = np.asarray(p.aj)
        ax[s, :p.n_tiles] = np.asarray(p.ax)
        valid[s, :p.n_tiles] = np.asarray(p.valid)
        vrow[s, :p.n_vrows] = np.asarray(p.vrow_row)
    return {"aj": aj, "ax": ax, "valid": valid, "vrow": vrow,
            "Tv": Tv, "V": V, "W": W}


def _block_ell_plans(rows, cols, vals, R, W):
    """Per-shard ELL plans for a (rows, cols, vals) padded block whose
    pad entries carry row id R (excluded).

    Only rows that have entries are packed: R is the max rows per
    shard, and a block (the halo especially) often touches a small
    subset. Missing rows come out of the segment reduce as the
    identity, which is what reduce(y_self, y_halo) needs."""
    n = rows.shape[0]
    plans = []
    for s in range(n):
        m = rows[s] < R
        coo = COO(R, int(cols.max() + 1) if cols.size else 1,
                  rows[s][m].astype(np.int64),
                  cols[s][m].astype(np.int64), vals[s][m])
        nonempty = np.unique(coo.rows)
        if nonempty.size == 0:
            nonempty = np.zeros(1, np.int64)  # degenerate: one empty row
        plans.append(pack_ell(coo_to_csr(coo, offset_dtype=np.int64), nonempty, W))
    return _stack_ell(plans, R)


def _block_width(rows, R) -> int:
    """ELL lane width of a distributed block: the W that minimizes the
    stacked tile count (padded slots, the bytes K11' streams), max over
    shards; ties prefer the wider W.

    A mean-based pick misjudges power-law blocks: hub rows are
    insensitive to W while every short row pays ceil(len/W)*W - len, so
    the argmin lands near the tail's width, not the mean's."""
    candidates = (2, 4, 8, 16, 32, 64, 128)
    slots_per_tile = SUBLANES * LANES
    best_w, best_t = 2, None
    for W in candidates:
        worst = 1
        for s in range(rows.shape[0]):
            r = rows[s][rows[s] < R]
            if r.size == 0:
                continue
            lens = np.bincount(r - r.min())
            lens = lens[lens > 0]
            chunks = int(((lens + W - 1) // W).sum())
            worst = max(worst, (chunks * W + slots_per_tile - 1)
                        // slots_per_tile)
        if best_t is None or worst <= best_t:
            best_w, best_t = W, worst
    return best_w


# ---------------------------------------------------------------------------
# K11': the per-shard ELL product and group reduce
# ---------------------------------------------------------------------------

def _local_ell_plain(aj, ax, valid, xsrc, *, W, sr):
    """Plain version of K11', the reference's sequence: per held shard
    l, gather xsrc[l, aj], combine with ax, the ring's identity where
    not valid, the `tree` group reduce of each W-lane group
    (kernels/ell.py:_group_reduce_plain), then the leaders in the order
    of reduced[:, ::W].reshape(-1) -> (n_local, Tv*8*128/W). 2-byte
    values are combined and reduced in float32 and the leaders rounded
    to xsrc's dtype once, as K11' does."""
    L = aj.shape[0]
    xg = torch.gather(xsrc, 1, aj.reshape(L, -1).long()).view(aj.shape)
    prod = sr.combine(widen16(ax), widen16(xg))
    prod = torch.where(valid, prod, float(sr.identity_for(prod.dtype)))
    red = _group_reduce_plain(prod.reshape(-1, LANES), W=W, strategy="tree", sr=sr)
    return red[:, ::W].reshape(L, -1).to(xsrc.dtype)


def _local_ell_pass(aj, ax, valid, xsrc, *, W, sr):
    """K11': aj, ax, valid (n_local, Tv, 8, 128) int32 / values / bool,
    xsrc (n_local, C), the x table of each held shard, of ax's value
    dtype (float32, bfloat16 or float16) -> (n_local, Tv*8*128/W) group
    leaders in that dtype. One launch covers every held shard. On a CPU
    tensor the plain version runs; on a CUDA tensor the kernel launches
    or this raises."""
    if W & (W - 1) or not 1 <= W <= LANES:
        raise ValueError(f"W={W} is not a power of two in [1, 128]")
    dev = xsrc.device
    if dev.type == "cpu":
        return _local_ell_plain(aj, ax, valid, xsrc, W=W, sr=sr)
    if dev.type != "cuda":
        raise ValueError(f"_local_ell_pass: unsupported device {dev}")
    lib, ring = device_ring_code(sr)
    L, Tv = int(aj.shape[0]), int(aj.shape[1])
    shape = (L, Tv, SUBLANES, LANES)
    _cuda.expect(aj, "aj", torch.int32, shape, dev)
    code = _cuda.value_code(ax, "K11' (local_ell)")
    _cuda.expect(ax, "ax", ax.dtype, shape, dev)
    _cuda.expect(valid, "valid", torch.bool, shape, dev)
    if xsrc.dim() != 2 or xsrc.shape[0] != L:
        raise ValueError(f"xsrc: shape {tuple(xsrc.shape)}, expected ({L}, C)")
    _cuda.expect(xsrc, "xsrc", ax.dtype, tuple(xsrc.shape), dev)
    # the kernel reads 4 lanes a thread as one vector: 16 bytes of aj, 4 of
    # valid (checked at 16), 4 values of ax
    for name, t, align in (("aj", aj, 16), ("ax", ax, 4 * ax.element_size()),
                           ("valid", valid, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: not {align}-byte aligned")
    out = torch.empty((L, Tv * SUBLANES * (LANES // W)), dtype=ax.dtype, device=dev)
    rc = lib.spmv_local_ell(
        _cuda.ptr(aj), _cuda.ptr(ax), _cuda.ptr(valid), _cuda.ptr(xsrc),
        xsrc.shape[1], _cuda.ptr(out), L, Tv, W, code, ring, _cuda.stream(dev))
    _cuda.check(rc, "spmv_local_ell")
    _local_ell_pass.launches += 1
    return out


_local_ell_pass.launches = 0


def _local_ell_matvec(blk: dict, xsrc, *, R, sr, identity, ax=None):
    """One block's product on every held shard, with its values `ax`
    (blk["ax"] by default) in xsrc's dtype: K11', then the leaders folded
    into the shard's R local rows -> (n_local, R). The fold (K16,
    `segment_reduce_sorted`) sums plus-times in float64 in a fixed order
    and rounds once: in float32 the tens of thousands of leaders of a hub
    row drift past the oracle's rtol 2e-4 where they cancel (measured on
    the card)."""
    red = _local_ell_pass(blk["aj"], blk["ax"] if ax is None else ax, blk["valid"],
                          xsrc, W=blk["W"], sr=sr)
    L = red.shape[0]
    y = segment_reduce_sorted(red[:, :blk["V"]].reshape(-1), blk["seg"], L * (R + 1),
                              sr, identity)
    return y.view(L, R + 1)[:, :R]


# ---------------------------------------------------------------------------
# What both distributed SpMVs share: x placement, the exchange, the
# split-row fixup and the returned rows
# ---------------------------------------------------------------------------

def _export_fix(plan: HaloPlan, mesh: ShardMesh) -> dict:
    """Plan-time arrays of the cross-shard fixup (None without exports):
    the exported partials grouped by row (order, mask, segment ids), and
    the flat (held shard, owned slot) position each combined row lands
    on with the index of its combined value. Rows outside a shard's
    owned range are left out (the reference drops them by index mode)."""
    if not plan.export_flag.any():
        return None
    er = np.asarray(plan.export_rows)
    order = np.argsort(er, kind="stable")
    er_sorted = er[order]
    uniq, seg_of = np.unique(er_sorted, return_inverse=True)
    keep = np.nonzero(uniq >= 0)[0]
    rows = uniq[keep]
    owned = plan.owned
    pos, src = [], []
    for l, s in enumerate(mesh.shard_ids):
        p = rows - plan.row_starts[s]
        m = (p >= 0) & (p < owned[s])
        pos.append(l * plan.R_out + p[m])
        src.append(keep[m])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
    return {"order": t(order.astype(np.int64)), "live": t(er_sorted >= 0),
            "seg": t(seg_of.reshape(-1).astype(np.int64)), "n_seg": int(uniq.size),
            "pos": t(np.concatenate(pos).astype(np.int64)),
            "src": t(np.concatenate(src).astype(np.int64))}


def _placement(plan: HaloPlan, mesh: ShardMesh, n_rows: int) -> dict:
    """The fields of `_Distributed` that both distribute_* place the
    same way: the send plan, the fixup and, on a local mesh, the
    position of each global row in the flat (n*R_out,) owned y."""
    n = plan.n_shards
    unpad = None
    if not mesh.distributed:
        shard_of = np.clip(np.searchsorted(plan.row_starts, np.arange(n_rows),
                                           side="right") - 1, 0, n - 1)
        unpad = torch.from_numpy(shard_of * plan.R_out + (
            np.arange(n_rows) - plan.row_starts[shard_of])).to(mesh.device)
    return {"send_idx": put_global(plan.send_idx.reshape(n, -1).astype(np.int64), mesh),
            "fix": _export_fix(plan, mesh), "unpad_idx": unpad, "x_pad": n * plan.B}


@dataclasses.dataclass
class _Distributed:
    """A CSR matrix planned over a shard mesh: x placement, the halo
    exchange, the split-row fixup and the returned rows."""

    mesh: ShardMesh
    axis: str
    plan: HaloPlan
    n_rows: int
    n_cols: int
    dev: dict                 # held shards' plan tensors
    send_idx: torch.Tensor    # (n_local, n*M) int64 x positions each held shard sends
    fix: dict                 # the split-row fixup (_export_fix), or None
    unpad_idx: torch.Tensor   # (n_rows,) into the flat owned y (local mesh only)
    x_pad: int                # n_shards * B
    # (ring, mode, x dtype, x dims) -> (graph, static x, static y): `_replay`
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    @property
    def comm_bytes_per_shard(self) -> int:
        return self.plan.comm_bytes_per_shard

    @property
    def allgather_bytes_per_shard(self) -> int:
        return self.plan.allgather_bytes_per_shard

    def shard_x(self, x) -> torch.Tensor:
        """Global x (n_cols,) -> the held shards' blocks (n_local, B), in
        x's dtype (float32, bfloat16 or float16), on the mesh's device. x
        is narrowed first as the reference's `jnp.asarray` narrows it
        (`as_input`: float64 -> float32)."""
        return self._shard(self._global_x(x))

    def _global_x(self, x) -> torch.Tensor:
        """Global x narrowed (`as_input`), on the mesh's device, its dtype
        and shape checked."""
        x = as_input(x, self.mesh.device)
        check_x_dtype(x)
        if x.dim() != 1 or x.shape[0] != self.n_cols:
            raise ValueError(f"x: shape {tuple(x.shape)}, expected ({self.n_cols},)")
        return x

    def _shard(self, x) -> torch.Tensor:
        mesh = self.mesh
        xs = torch.nn.functional.pad(x, (0, self.x_pad - x.shape[0]))
        xs = xs.view(mesh.n_shards, -1)
        return xs[mesh.rank:mesh.rank + 1] if mesh.distributed else xs

    def _input(self, x) -> torch.Tensor:
        """x as `matvec` takes it, checked and not yet computed on: a 2-D
        tensor as the held shards' blocks (n_local, B), anything else as
        the global vector (`_global_x`)."""
        if isinstance(x, torch.Tensor) and x.dim() == 2:
            x = as_input(x)
            want = (self.mesh.n_local, self.x_pad // self.mesh.n_shards)
            if tuple(x.shape) != want or x.device != self.mesh.device:
                raise ValueError(f"sharded x: {tuple(x.shape)} on {x.device}, "
                                 f"expected {want} on {self.mesh.device}")
            check_x_dtype(x)
            return x
        return self._global_x(x)

    def _sharded(self, x) -> torch.Tensor:
        """x as the held shards' (n_local, B) blocks: a 2-D tensor is
        taken as already sharded, anything else as the global vector."""
        x = self._input(x)
        return x if x.dim() == 2 else self._shard(x)

    def _graphed(self) -> bool:
        """Whether `matvec` replays graphs: on a mesh on the card, local or
        process-group (see the module's docstring)."""
        return self.mesh.device.type == "cuda"

    def _replay(self, x, ring: Semiring, mode, eager) -> torch.Tensor:
        """`eager(x)`, the body of `matvec`, on a mesh on the card as one
        replay of the CUDA graph of (ring, mode, x's dtype, x's layout),
        captured after the key's first call, which runs eagerly (see the
        module's docstring); y is a copy of the graph's. On the CPU,
        `eager(x)`."""
        if not self._graphed():
            return eager(x)
        x = self._input(x)
        key = (ring, mode, x.dtype, x.dim())
        hit = self.graphs.get(key)
        if hit is None:
            from spmv_tpu_torch.utils.timing import capture_graph

            y = eager(x)
            xs, out = x.clone(), []
            graph = capture_graph(lambda: out.append(eager(xs)),
                                  f"{type(self).__name__}.matvec ({ring.name}"
                                  f"{'' if mode is None else ', ' + mode})", self.mesh.device)
            self.graphs[key] = (graph, xs, out[0])
            return y
        graph, xs, ys = hit
        xs.copy_(x)
        graph.replay()
        return ys.clone()

    def _exchange(self, xs) -> torch.Tensor:
        """The value-only halo exchange: each held shard's halo table
        (n_local, n*M), the received all-to-all payload."""
        return self._start_exchange(xs)()

    def _start_exchange(self, xs):
        """The halo exchange started: the send payload gathered and the
        all-to-all started. Returns `finish()`, which joins it and
        returns the halo table (n_local, n*M)."""
        L, n, M = xs.shape[0], self.mesh.n_shards, self.plan.M
        send = torch.gather(xs, 1, self.send_idx).view(L, n, M)
        started = self.mesh.start_all_to_all(send)
        return lambda: started.wait().reshape(L, n * M)

    def _finish(self, y_own, first, sr: Semiring, identity) -> torch.Tensor:
        """Fold the exported boundary partials into their owners' rows,
        then return the global y on a local mesh, this rank's owned rows
        on a process-group mesh. `first` (n_local,) is each held shard's
        partial of its first local row; one all-gather brings every
        shard's, one segment reduce groups them by row, and one scatter
        (distinct positions) updates y_own (n_local, R_out) in place."""
        fix = self.fix
        if fix is not None:
            parts = self.mesh.all_gather(first)  # (n_shards,)
            ps = torch.where(fix["live"], parts.index_select(0, fix["order"]), identity)
            comb = segment_reduce_sorted(ps, fix["seg"], fix["n_seg"], sr, identity)
            if fix["pos"].numel():
                flat = y_own.view(-1)
                upd = sr.reduce(flat.index_select(0, fix["pos"]),
                                comb.index_select(0, fix["src"]))
                flat.index_copy_(0, fix["pos"], upd)
        if self.mesh.distributed:
            return y_own[0, :int(self.plan.owned[self.mesh.rank])]
        return y_own.reshape(-1).index_select(0, self.unpad_idx)


@dataclasses.dataclass
class DistributedSpMV(_Distributed):
    """A CSR matrix distributed over a shard mesh, ready for matvec: a
    self and a halo ELL block per shard (K11')."""

    # (block, compute dtype) -> its values cast to it (`_values`)
    cast: dict = dataclasses.field(default_factory=dict)

    def _values(self, blk: str, dtype) -> torch.Tensor:
        """Block `blk`'s values (A's dtype on the device) cast to the
        compute dtype, made once per dtype and cached (the reference's
        ax.astype(x.dtype))."""
        key = (blk, dtype)
        if key not in self.cast:
            ax = self.dev[blk]["ax"]
            self.cast[key] = ax if ax.dtype == dtype else ax.to(dtype)
        return self.cast[key]

    def x_table(self, xs, mode: str = "halo") -> torch.Tensor:
        """The halo table of each held shard, (n_local, n*M): the
        received all-to-all payload, or in 'allgather' mode the same
        coordinates read out of every shard's gathered x block."""
        return self._start_table(xs, mode)()

    def _start_table(self, xs, mode: str):
        """`x_table(xs, mode)` started: its collective started, nothing
        waiting on it. Returns `finish()`, which joins the collective and
        returns the table."""
        if mode == "allgather":
            started = self.mesh.start_all_gather(xs)
            return lambda: started.wait().reshape(-1)[self.dev["ag_idx"]]
        return self._start_exchange(xs)

    def matvec(self, x, semiring: Semiring = PLUS_TIMES,
               mode: str = "halo") -> torch.Tensor:
        """y = A (x) x. x is the global vector (n_cols,) or the held
        shards' blocks (n_local, B) from `shard_x`. mode 'halo'
        (default): the all-to-all of halo values; 'allgather': every
        column gathered. Returns the global y on a local mesh, this
        rank's owned rows on a process-group mesh; on the card, one
        graph replay after the first call of its key (`_replay`)."""
        if mode not in ("halo", "allgather"):
            raise ValueError(f"unknown mode {mode!r}; 'halo' or 'allgather'")
        return self._replay(x, semiring, mode,
                            lambda v: self._matvec_eager(v, semiring, mode))

    def _matvec_eager(self, x, semiring: Semiring = PLUS_TIMES,
                      mode: str = "halo") -> torch.Tensor:
        """`matvec`'s body, every launch and collective enqueued here: the
        collective started, the self block, the join, the halo block (see
        the module's docstring)."""
        xs = self._sharded(x)
        d, R = self.dev, self.plan.R
        identity = float(semiring.identity_for(xs.dtype))
        table = self._start_table(xs, mode)
        y_self = _local_ell_matvec(d["self"], xs, R=R, sr=semiring, identity=identity,
                                   ax=self._values("self", xs.dtype))
        y_halo = _local_ell_matvec(d["halo"], table(), R=R, sr=semiring,
                                   identity=identity, ax=self._values("halo", xs.dtype))
        y = semiring.reduce(y_self, y_halo)
        # owned output block: slot j = local row idx_own[j] (-1 -> identity)
        y_own = torch.where(d["own_live"], torch.gather(y, 1, d["own_idx"]),
                            identity)
        return self._finish(y_own, y[:, 0], semiring, identity)


def _upload_block(blk: dict, mesh: ShardMesh, R: int, val_dtype=None) -> dict:
    """A stacked block's arrays on the mesh's device, its values viewed as
    `val_dtype` where they are bfloat16 bits."""
    put = lambda a: put_global(a, mesh)
    vrow = put(blk["vrow"]).long()
    off = torch.arange(vrow.shape[0], device=vrow.device)[:, None] * (R + 1)
    return {"aj": put(blk["aj"]), "ax": as_values(put(blk["ax"]), val_dtype),
            "valid": put(blk["valid"]),
            "seg": (vrow + off).reshape(-1), "W": blk["W"], "Tv": blk["Tv"],
            "V": blk["V"]}


def _host_plan(A: CSR, n: int, balance: str) -> dict:
    plan = build_halo_plan(A, n, balance=balance)
    R = plan.R
    W_self = _block_width(plan.rows_self, R)
    W_halo = _block_width(plan.rows_halo, R)
    return {"plan": plan,
            "self": _block_ell_plans(plan.rows_self, plan.cols_self,
                                     plan.vals_self, R, W_self),
            "halo": _block_ell_plans(plan.rows_halo, plan.cols_halo,
                                     plan.vals_halo, R, W_halo)}


def distribute_csr(A: CSR, mesh: ShardMesh, axis: str = "shards",
                   balance: str = "nnz") -> DistributedSpMV:
    """Plan A over the mesh's n_shards (host NumPy, cached on A per
    shard count and balance) and place the held shards' arrays on the
    mesh's device, A's values in their own dtype."""
    n = mesh.n_shards
    host = plan_cache(A, ("dist_csr", n, balance),
                      lambda: _host_plan(A, n, balance))
    plan: HaloPlan = host["plan"]
    R = plan.R
    put = lambda a: put_global(a, mesh)
    recv_idx = plan.send_idx.transpose(1, 0, 2).astype(np.int64)
    base = np.arange(n, dtype=np.int64)[None, :, None] * plan.B
    io = plan.idx_own.astype(np.int64)
    dev = {
        # recv_idx[s, t] = send_idx[t, s], offset into the gathered x
        "ag_idx": put((recv_idx + base).reshape(n, -1)),
        "self": _upload_block(host["self"], mesh, R, value_dtype(A.Ax)),
        "halo": _upload_block(host["halo"], mesh, R, value_dtype(A.Ax)),
        "own_idx": put(np.clip(io, 0, R - 1)),
        "own_live": put(io >= 0),
    }
    return DistributedSpMV(mesh=mesh, axis=axis, plan=plan, n_rows=A.n_rows,
                           n_cols=A.n_cols, dev=dev,
                           **_placement(plan, mesh, A.n_rows))
