"""Baseline SpMV kinds: the CPU oracle, the framework gather, dense.

Counterpart of `spmv_tpu/kernels/baseline.py`:

- ``cpu_naive`` (alias ``cpu_navie``): the NumPy oracle, on the host,
  its result moved to x's device;
- ``xla`` (alias ``cusparse``, as in the reference): the framework's own
  gather (plain torch here, as it is plain XLA in the reference) and
  sorted segment reduction (K16, kernels/fold.py, where XLA compiles
  the reference's). It is the solvers' default kind. It is not
  cuSPARSE: the alias names the reference library it stands for;
- ``dense``: densify and `torch.matmul`, plus-times only, for small
  matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, float_values, is_bfloat16
from spmv_tpu_torch.ops.reference import spmv_ref, spmv_ref_semiring
from spmv_tpu_torch.ops.registry import as_input, plan_cache, register
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring, segment_reduce_sorted


@register("cpu_naive", supports_semiring=True, reference_analog="cpu_navie.hpp:3-35",
          aliases=("cpu_navie",))
def _cpu_naive(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Host NumPy row-loop oracle (ref: cpu_navie.hpp:3-35). bfloat16,
    which NumPy lacks, runs on float32 copies and is rounded at the end."""
    bf16 = is_bfloat16(A.Ax) or is_bfloat16(x)
    if bf16:
        A = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, float_values(A.Ax, np.float32))
    xn = x.cpu().float().numpy() if bf16 else x.cpu().numpy()
    y = (spmv_ref(A, xn) if semiring is PLUS_TIMES
         else spmv_ref_semiring(A, xn, semiring))
    y = as_input(y, x.device)
    return y.bfloat16() if bf16 and y.dtype == torch.float32 else y


@register("xla", supports_semiring=True, reference_analog="cusparse.cuh:36-89",
          aliases=("cusparse",))
def _xla(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Framework baseline: torch gather + sorted segment reduction."""
    plan = plan_cache(A, ("xla", str(x.device)), lambda: {
        "rows": torch.from_numpy(np.ascontiguousarray(A.row_ids())).to(x.device),
        "Aj": torch.from_numpy(np.ascontiguousarray(A.Aj)).to(x.device),
        "Ax": as_input(A.Ax, x.device)})  # float64 values narrowed, as jnp.asarray
    prod = semiring.combine(plan["Ax"], x[plan["Aj"].long()])
    ident = float(semiring.identity_for(prod.dtype))
    return segment_reduce_sorted(prod, plan["rows"], A.n_rows, semiring, ident)


@register("dense", reference_analog="(none; sanity baseline)")
def _dense(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Densify + matmul: a sanity baseline for small matrices only."""
    if semiring is not PLUS_TIMES:
        raise ValueError("kind 'dense' supports plus_times only")
    if A.n_rows * A.n_cols > 64 * 1024 * 1024:
        raise ValueError("matrix too large to densify")
    def densify():
        if is_bfloat16(A.Ax):  # NumPy has no bfloat16: densify in float32
            M = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, float_values(A.Ax, np.float32))
            return as_input(M.to_dense(), x.device).bfloat16()
        return as_input(A.to_dense(), x.device)

    d = plan_cache(A, ("dense", str(x.device)), densify)
    dt = torch.promote_types(d.dtype, x.dtype)
    if dt.is_floating_point:
        return d.to(dt) @ x.to(dt)
    return (d.to(dt) * x.to(dt)).sum(1, dtype=dt)  # integer matmul has no CUDA kernel
