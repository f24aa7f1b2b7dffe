"""csr-vector SpMV family: the CUSP kernel analogs.

Counterpart of `spmv_tpu/kernels/csr_vector.py`. The reference kinds
`cusp`/`cusp1`/`cusp2` run T threads per row with different reduction
mechanics; the port keeps the reference's mapping of that axis:

- ``csr_vector`` (alias ``cusp``): the stream pipeline at kappa 12288
  with the segmented-scan reduction (`scan_strategy="roll"`: K8 for
  every ring);
- ``csr_vector_shfl`` (``cusp1``) and ``csr_vector_shfl2`` (``cusp2``):
  the same plan with the prefix-difference scan (K6) where the ring has
  an inverse, and the roll scan for rows of mean length <= 2;
- on a diagonal-sparse matrix all three run `dia` (K12) instead;
- past the stream planner's reach they warn (`FallbackWarning`) and run
  the direct ELL kernels.

The direct W-lanes-per-chunk ELL kinds (K9 -> K11, kernels/ell.py) are
``csr_vector_ell`` (linear group fold), ``csr_vector_shfl_ell`` (tree)
and ``csr_vector_shfl2_ell`` (tree + broadcast), the last two dropping
to linear at W <= 16 as the reference's dispatchers do; ``csr_scalar``
is the linear ELL kernel at the mean-derived width.
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.dia import _dia, diag_profile
from spmv_tpu_torch.kernels.ell import device_ell_plan, ell_spmv, select_width
from spmv_tpu_torch.kernels import stream
from spmv_tpu_torch.ops.registry import (PlanCapacityError, plan_cache, register,
                                         warn_fallback)
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring
from spmv_tpu_torch.ops.tuning import detect_chip, dispatch_fields


def _all_rows(A: CSR) -> np.ndarray:
    return np.arange(A.n_rows, dtype=np.int64)


def csr_ell_plan(A: CSR, device):
    """The all-rows ELL plan at the width the mean row length picks,
    shared by the three `*_ell` kinds and `csr_scalar`."""
    W = select_width(A.mean_nnz_per_row)
    return device_ell_plan(A, ("ell", W), lambda: _all_rows(A), W, device)


def _csr_vector_ell_impl(A: CSR, x, semiring: Semiring, strategy: str,
                         min_shfl_width: int = 0):
    plan = csr_ell_plan(A, x.device)
    if plan.width <= min_shfl_width:
        # the reference's shuffle dispatchers fall back to the linear
        # kernel for narrow rows (ref: cusp_warp_reduce.cuh:100-127)
        strategy = "linear"
    return ell_spmv(A, x, semiring, plan, strategy)


def _csr_vector_fast(A: CSR, x, semiring: Semiring, scan_strategy: str,
                     ell_strategy: str, min_shfl_width: int = 0):
    # a diagonal-sparse (banded, stencil) matrix runs the DIA kind
    if plan_cache(A, ("dia", "profile"), lambda: diag_profile(A)) is not None:
        return _dia(A, x, semiring=semiring)
    if scan_strategy == "auto" and A.mean_nnz_per_row <= min_shfl_width:
        scan_strategy = "roll"  # narrow-row fallback, as the ref dispatcher
    try:
        return stream._stream_spmv(
            A, x, semiring,
            stream.StreamPolicy(kappa=12288, scan_strategy=scan_strategy,
                         **dispatch_fields(chip=detect_chip(x.device))))
    except PlanCapacityError as e:
        warn_fallback("csr_vector", "ELL", e)
        return _csr_vector_ell_impl(A, x, semiring, ell_strategy, min_shfl_width)


@register("csr_vector", supports_semiring=True,
          reference_analog="cusp/cusp.cuh:19-237", aliases=("cusp",))
def _csr_vector(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, roll-reduction scan (cusp smem-tree analog)."""
    return _csr_vector_fast(A, x, semiring, "roll", "linear")


@register("csr_vector_shfl", supports_semiring=True,
          reference_analog="cusp/cusp_warp_reduce.cuh:11-148", aliases=("cusp1",))
def _csr_vector_shfl(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, optimized reduction (cusp1 warp-shuffle analog)."""
    return _csr_vector_fast(A, x, semiring, "auto", "tree", min_shfl_width=2)


@register("csr_vector_shfl2", supports_semiring=True,
          reference_analog="cusp/cusp_warp_read_reduce.cuh:11-154", aliases=("cusp2",))
def _csr_vector_shfl2(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, optimized reduction + broadcast offsets (cusp2
    analog); the same path as csr_vector_shfl, kept for parity."""
    return _csr_vector_fast(A, x, semiring, "auto", "broadcast", min_shfl_width=2)


@register("csr_vector_ell", supports_semiring=True,
          reference_analog="cusp/cusp.cuh:19-237 (direct ELL execution)")
def _csr_vector_ell(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, direct W-lanes-per-chunk ELL kernel (linear group
    fold); the structural cusp analog and reach fallback."""
    return _csr_vector_ell_impl(A, x, semiring, "linear")


@register("csr_vector_shfl_ell", supports_semiring=True,
          reference_analog="cusp/cusp_warp_reduce.cuh (direct ELL execution)")
def _csr_vector_shfl_ell(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, direct ELL kernel with log-step tree reduce."""
    return _csr_vector_ell_impl(A, x, semiring, "tree", min_shfl_width=16)


@register("csr_vector_shfl2_ell", supports_semiring=True,
          reference_analog="cusp/cusp_warp_read_reduce.cuh (direct ELL)")
def _csr_vector_shfl2_ell(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """csr-vector, direct ELL kernel, tree reduce + group broadcast."""
    return _csr_vector_ell_impl(A, x, semiring, "broadcast", min_shfl_width=16)


@register("csr_scalar", supports_semiring=True,
          reference_analog="(SURVEY §7.3a; row-parallel baseline)")
def _csr_scalar(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Row-blocked baseline: rows chunked at the mean-derived width,
    linear group fold (K9 -> K11)."""
    return ell_spmv(A, x, semiring, csr_ell_plan(A, x.device), "linear")
