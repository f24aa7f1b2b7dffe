"""Row partitioning and halo-exchange planning for the multi-device SpMV.

Counterpart of `spmv_tpu/parallel/partition.py`, pure NumPy and copied:
for the same matrix, shard count and balance, `partition_rows` and
`build_halo_plan` return the reference's arrays bit for bit
(tests/test_torch_parallel.py).

- The default partition cuts EXACT nnz/n entry ranges, which may split a
  row at a shard boundary; the boundary row's partials are combined by a
  one-value-per-shard all-gather (the cross-shard carry fixup).
  Row-aligned 'merge' and 'rows' balances remain available.
- x is owned in contiguous column blocks, one per shard.
- The halo plan names, per (receiver, owner) pair, exactly which x
  entries travel. Remote column indices are remapped at plan time into
  the receiver's halo-table coordinates, so the run-time exchange is one
  all-to-all of values, no index traffic, sized by the halo rather than
  by every column.

Values are carried as `formats.host_values` gives them (bfloat16 as its
uint16 bits), so a bfloat16 plan equals the reference's through a
uint16 view.

Each shard's nonzeros split into a SELF part (columns it owns) and a
HALO part (remote columns); the self product does not depend on the
exchange. Per-shard arrays are padded to the largest shard, so every
shard has one shape; the exact-nnz split keeps that padding within one
128-entry granule even when a hub row holds more than nnz/n entries.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.formats import CSR, host_values


@dataclasses.dataclass
class RowPartition:
    """A 1-D row partition of a CSR matrix into n_shards blocks."""

    n_shards: int
    row_starts: np.ndarray  # (n_shards+1,) global first row per shard
    rows_per_shard: int  # padded local row count R
    nnz_per_shard: int  # padded local nnz N
    Ap: np.ndarray  # (n_shards, R+1) int32 local offsets (padded rows empty)
    Aj: np.ndarray  # (n_shards, N) int32 GLOBAL column indices
    Ax: np.ndarray  # (n_shards, N) values (padding = 0)
    halo_counts: np.ndarray  # (n_shards,) distinct columns touched


@dataclasses.dataclass
class HaloPlan:
    """Value-only halo exchange and split local blocks.

    x ownership: shard s owns columns [s*B, (s+1)*B) of the padded x.
    The exchange is an all-to-all of (n, M) value payloads; receiver
    s's halo table is the received (n, M) block flattened, so a remote
    column that owner t sends in slot j lives at table position t*M + j
    (baked into cols_halo at plan time).

    Shards are ENTRY ranges [e0, e1), not row ranges ('nnz' cuts
    mid-row): local row ids are relative to the shard's first touched
    row (ftr); a row is OWNED by the shard that holds its first entry,
    and a shard whose range starts mid-row exports its partial for that
    row (export_flag); the owner reduces the exported partials in.
    Row-aligned balances ('merge', 'rows') give the same fields with no
    exports, so the run time has one path.
    """

    n_shards: int
    B: int               # x block (columns per shard, padded)
    M: int               # max send-slot count per (owner, receiver)
    R: int               # padded local TOUCHED rows per shard
    R_out: int           # padded OWNED rows per shard (output block)
    N_self: int          # padded self-nnz per shard
    N_halo: int          # padded halo-nnz per shard
    row_starts: np.ndarray   # (n+1,) OWNERSHIP starts (global rows)
    # owned-block gather: owned row j of shard s reads local y slot
    # idx_own[s, j] (-1 -> no touched entries, output = identity)
    idx_own: np.ndarray      # (n, R_out) int32
    export_flag: np.ndarray  # (n,) bool: shard exports y_local[0]
    export_rows: np.ndarray  # (n,) int64 global row exported (-1 none)
    # per-shard send plan: send_idx[t, s, :] = local x positions shard t
    # sends to shard s (pad 0)
    send_idx: np.ndarray     # (n, n, M) int32
    # split local blocks (COO-style: per-nnz local row + remapped col)
    rows_self: np.ndarray    # (n, N_self) int32 local row (pad R)
    cols_self: np.ndarray    # (n, N_self) int32 in [0, B)
    vals_self: np.ndarray    # (n, N_self)
    rows_halo: np.ndarray    # (n, N_halo) int32 local row (pad R)
    cols_halo: np.ndarray    # (n, N_halo) int32 in [0, n*M)
    vals_halo: np.ndarray    # (n, N_halo)
    halo_counts: np.ndarray  # (n,) true halo entries received per shard

    @property
    def comm_bytes_per_shard(self) -> int:
        """All-to-all payload bytes each shard sends (float32 values)."""
        return int(self.n_shards * self.M * 4)

    @property
    def allgather_bytes_per_shard(self) -> int:
        """What a full all-gather of x would move per shard."""
        return int(self.n_shards * self.B * 4)

    @property
    def owned(self) -> np.ndarray:
        """(n,) owned row count of each shard."""
        return self.row_starts[1:] - self.row_starts[:-1]


def partition_rows(A: CSR, n_shards: int, balance: str = "merge") -> RowPartition:
    """Split rows into contiguous shards.

    balance='merge': equalize rows + nnz per shard (the merge-path
    diagonal split applied at shard granularity); 'rows': equal row
    counts.
    """
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    n_rows, nnz = A.n_rows, int(Ap[-1])

    row_starts = _row_starts(Ap, n_rows, nnz, n_shards, balance)

    R = int(max((row_starts[1:] - row_starts[:-1]).max(), 1))
    local_nnz = Ap[row_starts[1:]] - Ap[row_starts[:-1]]
    N = int(max(local_nnz.max(), 1))
    N = -(-N // 128) * 128
    R = max(R, 1)

    Ap_l = np.zeros((n_shards, R + 1), dtype=np.int64)
    Aj_l = np.zeros((n_shards, N), dtype=np.int64)
    Ax_l = np.zeros((n_shards, N), dtype=Ax.dtype if Ax.size else np.float32)
    halo_counts = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        r0, r1 = row_starts[s], row_starts[s + 1]
        k0, k1 = Ap[r0], Ap[r1]
        nl = int(k1 - k0)
        offs = Ap[r0 : r1 + 1] - k0
        Ap_l[s, : r1 - r0 + 1] = offs
        Ap_l[s, r1 - r0 + 1 :] = nl  # padded rows are empty
        Aj_l[s, :nl] = Aj[k0:k1]
        Ax_l[s, :nl] = Ax[k0:k1]
        halo_counts[s] = np.unique(Aj[k0:k1]).size if nl else 0

    if int(Ap_l.max()) > np.iinfo(np.int32).max or N > np.iinfo(np.int32).max:
        raise OverflowError("shard exceeds int32 offsets; increase n_shards")
    return RowPartition(
        n_shards=n_shards,
        row_starts=row_starts,
        rows_per_shard=R,
        nnz_per_shard=N,
        Ap=Ap_l.astype(np.int32),
        Aj=Aj_l.astype(np.int32),
        Ax=Ax_l,
        halo_counts=halo_counts,
    )


def _row_starts(Ap, n_rows, nnz, n_shards, balance):
    if balance == "rows" or nnz == 0:
        return np.linspace(0, n_rows, n_shards + 1).astype(np.int64)
    # merge balance: shard s gets merge items [s*I/n, (s+1)*I/n),
    # items = rows + nnz; boundary row r minimizes |(r + Ap[r]) - d|.
    items = n_rows + nnz
    diags = (np.arange(1, n_shards) * items) // n_shards
    merge_pos = np.arange(n_rows + 1) + Ap  # r + Ap[r], increasing
    cuts = np.searchsorted(merge_pos, diags, side="left")
    row_starts = np.concatenate([[0], cuts, [n_rows]]).astype(np.int64)
    return np.maximum.accumulate(row_starts)


def build_halo_plan(A: CSR, n_shards: int,
                    balance: str = "nnz") -> HaloPlan:
    """Plan the halo-compacted distributed SpMV (see HaloPlan).

    balance='nnz' (default): EXACT nnz/n entry cuts, splitting rows at
    shard boundaries, so a power-law hub row does not pin its whole
    weight to one shard. 'merge': rows+nnz-balanced row-aligned cuts.
    'rows': equal row counts.
    """
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Ax = host_values(A.Ax)  # bfloat16 as its bits
    n = n_shards
    n_rows, nnz = A.n_rows, int(Ap[-1])
    if balance == "nnz":
        e_cuts = (np.arange(n + 1, dtype=np.int64) * nnz) // n
    else:
        rs = _row_starts(Ap, n_rows, nnz, n, balance)
        e_cuts = Ap[rs]
    B = -(-max(A.n_cols, 1) // n)

    # row containing each cut entry (last row whose start <= e), and
    # ownership: row r belongs to the shard containing entry Ap[r]
    ftr = np.maximum(np.searchsorted(Ap, e_cuts[:-1], side="right") - 1, 0)
    own_starts = np.searchsorted(Ap[:n_rows], e_cuts[:-1], side="left")
    own_starts = np.concatenate([own_starts, [n_rows]]).astype(np.int64)
    own_starts = np.maximum.accumulate(own_starts)
    export_flag = Ap[ftr] < e_cuts[:-1]
    export_rows = np.where(export_flag, ftr, -1).astype(np.int64)

    per_shard = []
    M = 1
    for s in range(n):
        k0, k1 = e_cuts[s], e_cuts[s + 1]
        cols = Aj[k0:k1]
        vals = Ax[k0:k1]
        # global row of each entry -> local (relative to ftr[s]): one
        # linear repeat over the shard's clipped row lengths
        ltr = np.searchsorted(Ap, max(k1, k0 + 1) - 1, side="right") - 1
        lens = (np.minimum(Ap[ftr[s] + 1:ltr + 2], k1)
                - np.maximum(Ap[ftr[s]:ltr + 1], k0))
        rows = np.repeat(np.arange(ltr + 1 - ftr[s], dtype=np.int64),
                         np.maximum(lens, 0))
        owner = cols // B
        self_m = owner == s
        # halo: unique remote columns, grouped by owner
        hcols = np.unique(cols[~self_m])
        howner = hcols // B
        # per-owner send slot of each halo column
        slot = np.zeros(hcols.shape[0], dtype=np.int64)
        counts = np.zeros(n, dtype=np.int64)
        for t in np.unique(howner):
            m = howner == t
            c = int(m.sum())
            slot[m] = np.arange(c)
            counts[t] = c
            M = max(M, c)
        per_shard.append(dict(
            rows=rows, cols=cols, vals=vals, self_m=self_m,
            hcols=hcols, howner=howner, slot=slot, counts=counts,
            n_touched=int(rows[-1] + 1) if rows.size else 1))

    R = int(max(max(p["n_touched"] for p in per_shard), 1))
    owned = own_starts[1:] - own_starts[:-1]
    R_out = int(max(owned.max(), 1))
    # owned row j of shard s = global row own_starts[s] + j, living at
    # local slot (global - ftr[s]) when touched, else identity (-1); a
    # touched-but-empty row reads its identity-filled slot
    idx_own = np.full((n, R_out), -1, dtype=np.int64)
    for s in range(n):
        j = np.arange(owned[s], dtype=np.int64)
        loc = own_starts[s] + j - ftr[s]
        touched = (loc >= 0) & (loc < per_shard[s]["n_touched"])
        idx_own[s, :owned[s]] = np.where(touched, loc, -1)
    N_self = max(int(max(p["self_m"].sum() for p in per_shard)), 1)
    N_halo = max(int(max((~p["self_m"]).sum() for p in per_shard)), 1)
    N_self = -(-N_self // 128) * 128
    N_halo = -(-N_halo // 128) * 128

    send_idx = np.zeros((n, n, M), dtype=np.int64)
    rows_self = np.full((n, N_self), R, dtype=np.int64)
    cols_self = np.zeros((n, N_self), dtype=np.int64)
    vals_self = np.zeros((n, N_self), dtype=Ax.dtype if Ax.size else np.float32)
    rows_halo = np.full((n, N_halo), R, dtype=np.int64)
    cols_halo = np.zeros((n, N_halo), dtype=np.int64)
    vals_halo = np.zeros((n, N_halo), dtype=vals_self.dtype)
    halo_counts = np.zeros(n, dtype=np.int64)

    for s, p in enumerate(per_shard):
        sm = p["self_m"]
        c_self = p["cols"][sm] - s * B
        rows_self[s, :c_self.size] = p["rows"][sm]
        cols_self[s, :c_self.size] = c_self
        vals_self[s, :c_self.size] = p["vals"][sm]
        # halo entries: remap each col to its table position t*M + slot.
        # hcols is sorted and unique, so a binary search finds each
        # entry's column (the reference does this by a Python dict over
        # every halo entry; the arrays are the same)
        hm = ~sm
        hc = p["cols"][hm]
        pos_of = p["howner"] * M + p["slot"]
        mapped = pos_of[np.searchsorted(p["hcols"], hc)]
        rows_halo[s, :hc.size] = p["rows"][hm]
        cols_halo[s, :hc.size] = mapped
        vals_halo[s, :hc.size] = p["vals"][hm]
        halo_counts[s] = p["hcols"].size
        # sender side: what every OWNER t must send to s
        for t in np.unique(p["howner"]):
            m = p["howner"] == t
            send_idx[t, s, :int(m.sum())] = p["hcols"][m] - t * B

    return HaloPlan(
        n_shards=n, B=int(B), M=int(M), R=R, R_out=R_out,
        N_self=N_self, N_halo=N_halo,
        row_starts=own_starts,
        idx_own=idx_own.astype(np.int32),
        export_flag=export_flag,
        export_rows=export_rows,
        send_idx=send_idx.astype(np.int32),
        rows_self=rows_self.astype(np.int32),
        cols_self=cols_self.astype(np.int32),
        vals_self=vals_self,
        rows_halo=rows_halo.astype(np.int32),
        cols_halo=cols_halo.astype(np.int32),
        vals_halo=vals_halo,
        halo_counts=halo_counts,
    )
