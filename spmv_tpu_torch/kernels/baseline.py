"""Baseline SpMV kinds: the CPU oracle, the framework gather, dense.

Counterpart of `spmv_tpu/kernels/baseline.py`:

- ``cpu_naive`` (alias ``cpu_navie``): the NumPy oracle, on the host,
  its result moved to x's device;
- ``xla`` (alias ``cusparse``, as in the reference): the framework's own
  gather and sorted segment reduction, plain torch here as it is plain
  XLA in the reference. It is the solvers' default kind. It is not
  cuSPARSE: the alias names the reference library it stands for;
- ``dense``: densify and `torch.matmul`, plus-times only, for small
  matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.ops.reference import spmv_ref, spmv_ref_semiring
from spmv_tpu_torch.ops.registry import plan_cache, register
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring, segment_reduce_sorted


@register("cpu_naive", supports_semiring=True, reference_analog="cpu_navie.hpp:3-35",
          aliases=("cpu_navie",))
def _cpu_naive(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Host NumPy row-loop oracle (ref: cpu_navie.hpp:3-35)."""
    xn = x.cpu().numpy()
    y = (spmv_ref(A, xn) if semiring is PLUS_TIMES
         else spmv_ref_semiring(A, xn, semiring))
    return torch.from_numpy(y).to(x.device)


@register("xla", supports_semiring=True, reference_analog="cusparse.cuh:36-89",
          aliases=("cusparse",))
def _xla(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Framework baseline: torch gather + sorted segment reduction."""
    plan = plan_cache(A, ("xla", str(x.device)), lambda: {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(x.device)
        for k, v in (("rows", A.row_ids()), ("Aj", np.asarray(A.Aj)),
                     ("Ax", np.asarray(A.Ax)))})
    prod = semiring.combine(plan["Ax"], x[plan["Aj"].long()])
    ident = float(semiring.identity_for(torch.empty(0, dtype=prod.dtype).numpy().dtype))
    return segment_reduce_sorted(prod, plan["rows"], A.n_rows, semiring, ident)


@register("dense", reference_analog="(none; sanity baseline)")
def _dense(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Densify + matmul: a sanity baseline for small matrices only."""
    if semiring is not PLUS_TIMES:
        raise ValueError("kind 'dense' supports plus_times only")
    if A.n_rows * A.n_cols > 64 * 1024 * 1024:
        raise ValueError("matrix too large to densify")
    d = plan_cache(A, ("dense", str(x.device)),
                   lambda: torch.from_numpy(A.to_dense()).to(x.device))
    return d @ x
