"""SpGEMM: C = A (x) B for CSR x CSR over a semiring.

Counterpart of `spmv_tpu/kernels/spgemm.py`. Everything structural
happens once on the host, everything that depends on the values runs on
the device through the SpMV kinds:

- **Symbolic phase** (host, cached per (A, B) pair): expand the triples
  (i, k, j) of every (i, k) in A crossed with row k of B (Gustavson's
  row merge), group them by (i, j) and collapse the groups into C's CSR
  pattern. The native SPA walk (`native.spgemm_symbolic`) and the NumPy
  lexsort give the same arrays.
- **Numeric phase** (device): the products grouped by output nonzero
  are an SpMV on a *virtual* CSR V:

      V.n_rows = nnz(C)        one virtual row per output nonzero
      V.Ap     = the triple groups' offsets
      V.Aj     = each triple's index into B's value array
      V.Ax     = each triple's A value
      x        = B.Ax, on the device
      C.data   = spmv(V, B.Ax)

  so the stream pipeline and its rings serve it with no kernel of its
  own. method='auto' runs the `xla` kind unless a stream plan for V is
  already at hand (a one-shot product never pays back the O(nnz) plan
  build; a fixed pattern iterated, as in APSP relaxations, opts in once
  with method='stream' and rides the cached plan after that).

C is a host CSR, as every container of the port is: its values are
downloaded once. C keeps structural zeros (entries whose values reduce
to the ring's identity), as scipy.sparse does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spmv_tpu_torch import config
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv, plan_cache_key
from spmv_tpu_torch.ops.registry import (PlanCapacityError, as_input, plan_cache,
                                         plan_cached, spmv)
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring

# The one policy of the numeric stream phase: `_numeric_stream` builds its
# plan under this policy's key, and `_stream_planned` looks for that key.
_POLICY = StreamPolicy()


def _spgemm_symbolic(A: CSR, B: CSR) -> dict:
    """Expand the triples, group them by (i, j), build C's pattern.

    Returns the virtual CSR's host arrays and C's pattern."""
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Bp = np.asarray(B.Ap, dtype=np.int64)
    Bj = np.asarray(B.Aj, dtype=np.int64)
    nnzA = int(Ap[-1])

    # The native SPA walk is O(B.n_cols) in memory and time, so an
    # ultra-wide sparse B takes the lexsort (which scales with the
    # triples); any native failure falls back to NumPy too.
    native_ok = (B.n_cols <= np.iinfo(np.int32).max
                 and B.n_cols <= 64 * max(int(Bp[-1]) + A.n_rows, 1))
    if native_ok:
        try:
            from spmv_tpu_torch import native

            if native.available():
                Cp, Cj, v_ap, srcA, srcB, total = native.spgemm_symbolic(
                    A.n_rows, B.n_cols, Ap, Aj, Bp, Bj)
                return {"Cp": Cp, "Cj": Cj.astype(np.int64),
                        "v_ap": v_ap, "srcB": srcB, "srcA": srcA,
                        "n_triples": total}
        except (NotImplementedError, ValueError):
            pass

    iA = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
    lensB = Bp[Aj + 1] - Bp[Aj]  # per A nonzero: the B entries it expands to
    total = int(lensB.sum())
    if total == 0:
        return {
            "Cp": np.zeros(A.n_rows + 1, np.int64),
            "Cj": np.zeros(0, np.int64),
            "v_ap": np.zeros(1, np.int64),
            "srcB": np.zeros(0, np.int64),
            "srcA": np.zeros(0, np.int64),
            "n_triples": 0,
        }
    # triple t -> its A nonzero e(t) and its offset within B's row
    e_of_t = np.repeat(np.arange(nnzA, dtype=np.int64), lensB)
    starts = np.concatenate([[0], np.cumsum(lensB)])
    off = np.arange(total, dtype=np.int64) - starts[e_of_t]
    srcB = Bp[Aj[e_of_t]] + off
    i_t = iA[e_of_t]
    j_t = Bj[srcB]

    order = np.lexsort((j_t, i_t))
    i_s, j_s = i_t[order], j_t[order]
    new_out = np.ones(total, dtype=bool)
    new_out[1:] = (i_s[1:] != i_s[:-1]) | (j_s[1:] != j_s[:-1])
    group = np.cumsum(new_out) - 1
    nnzC = int(group[-1]) + 1
    Cj = j_s[new_out]
    Ci = i_s[new_out]
    Cp = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.add.at(Cp, Ci + 1, 1)
    np.cumsum(Cp, out=Cp)

    v_ap = np.zeros(nnzC + 1, dtype=np.int64)
    np.add.at(v_ap, group + 1, 1)
    np.cumsum(v_ap, out=v_ap)
    return {
        "Cp": Cp, "Cj": Cj,
        "v_ap": v_ap,
        "srcB": srcB[order],
        "srcA": e_of_t[order],
        "n_triples": total,
    }


def _ident_token(M: CSR):
    """A per-object token for plan-cache keys; unlike id(), it cannot
    alias a recycled object."""
    tok = getattr(M, "_ident_token", None)
    if tok is None:
        tok = object()
        M._ident_token = tok
    return tok


def _plan(A: CSR, B: CSR) -> dict:
    """Fetch or build the (A, B) symbolic plan and virtual CSR, cached in
    A's plan cache under B's identity token."""
    key = ("spgemm", _ident_token(B))

    def build():
        sym = _spgemm_symbolic(A, B)
        Ax = np.asarray(A.Ax)
        idx_dtype = np.int32 if B.n_cols <= np.iinfo(np.int32).max else np.int64
        V = CSR(
            n_rows=int(sym["Cj"].shape[0]),
            n_cols=B.nnz,
            Ap=sym["v_ap"],
            Aj=sym["srcB"].astype(
                np.int32 if B.nnz <= np.iinfo(np.int32).max else np.int64),
            Ax=Ax[sym["srcA"]] if sym["n_triples"] else Ax[:0],
        )
        # C's column indices in their output dtype, cast once per plan
        return {"sym": sym, "V": V, "Cj": sym["Cj"].astype(idx_dtype)}

    return plan_cache(A, key, build)


def spgemm(A: CSR, B: CSR, semiring: Semiring = PLUS_TIMES,
           method: str = "auto", device=None) -> CSR:
    """C = A (x) B over `semiring`, as a host CSR with C's pattern.

    method: 'stream' (the stream pipeline on the virtual CSR), 'xla'
    (gather and sorted segment reduce), or 'auto'. The numeric phase
    runs on `device`, by default `config.default_device()` (the card
    unless the process asked for the CPU); without a card this raises,
    naming device="cpu"."""
    if A.n_cols != B.n_rows:
        raise ValueError(
            f"inner dimensions mismatch: A is {A.shape}, B is {B.shape}")
    dev = config.device_for(device, who="spgemm", how='pass device="cpu"')
    plan = _plan(A, B)
    sym, V = plan["sym"], plan["V"]
    nnzC = sym["Cj"].shape[0]
    val_dtype = np.promote_types(np.asarray(A.Ax).dtype,
                                 np.asarray(B.Ax).dtype)
    if nnzC == 0:
        return CSR(A.n_rows, B.n_cols, sym["Cp"],
                   sym["Cj"].astype(np.int32), np.zeros(0, val_dtype))

    Bx = as_input(np.asarray(B.Ax), dev)
    if method == "xla":
        cvals = _numeric_xla(V, Bx, semiring)
    elif method == "stream":
        cvals = _numeric_stream(V, Bx, semiring)
    elif _stream_planned(V):
        # 'auto' after a 'stream' call on the same (A, B): ride the plan
        try:
            cvals = _numeric_stream(V, Bx, semiring)
        except PlanCapacityError:
            cvals = _numeric_xla(V, Bx, semiring)
    else:
        cvals = _numeric_xla(V, Bx, semiring)

    return CSR(A.n_rows, B.n_cols, sym["Cp"], plan["Cj"], cvals.cpu().numpy())


def _stream_planned(V: CSR) -> bool:
    """True when a stream plan for the virtual CSR is at hand: in the
    in-memory cache, or saved in the on-disk plan dir (so an APSP loop
    restarted in a new process still rides its plan)."""
    if plan_cached(V, plan_cache_key(_POLICY)):
        return True
    d = config.plan_dir()
    if d:
        from spmv_tpu_torch.utils.plancache import plan_key

        return os.path.exists(
            os.path.join(d, f"stream-{plan_key(V, _POLICY)}.npz"))
    return False


def _numeric_stream(V: CSR, Bx: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    return _stream_spmv(V, Bx, semiring, _POLICY)


def _numeric_xla(V: CSR, Bx: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    return spmv("xla", V, Bx, semiring=semiring)
