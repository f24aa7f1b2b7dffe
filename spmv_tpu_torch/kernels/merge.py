"""Merge-path kinds on the stream pipeline.

Counterpart of the registrations at the end of
`spmv_tpu/kernels/merge.py` (:577-636). The reference runs `merge`,
`merge_stock` and `merge_genl` on the stream pipeline with its own
equal-nnz tile sizes (kappa), and falls back to `merge_tiled` past the
stream planner's reach. That fallback runs the TPU kernel K10
(`_merge_spmv_device`), which is not ported yet: here a matrix past the
planner's reach raises NotImplementedError naming it.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv
from spmv_tpu_torch.ops.registry import PlanCapacityError, register
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring
from spmv_tpu_torch.ops.tuning import detect_chip, dispatch_fields


def _stream_policy_for(nnz_per_tile: int, device) -> StreamPolicy:
    return StreamPolicy(kappa=nnz_per_tile,
                        **dispatch_fields(chip=detect_chip(device)))


def _merge_fast(kind: str, A: CSR, x: torch.Tensor, semiring: Semiring,
                kappa: int) -> torch.Tensor:
    try:
        return _stream_spmv(A, x, semiring, _stream_policy_for(kappa, x.device))
    except PlanCapacityError as e:
        raise NotImplementedError(
            f"{kind}: the matrix is past the stream planner's reach ({e}); "
            f"the reference falls back to merge_tiled, whose TPU kernel K10 "
            f"(_merge_spmv_device, spmv_tpu/kernels/merge.py:438) is not "
            f"ported yet (ROADMAP queue 2)") from e


@register("merge", supports_semiring=True,
          reference_analog="merge_based/* (dispatch_spmv_orig.cuh:533-769)")
def _merge(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV, tuned tile size, on the stream pipeline."""
    return _merge_fast("merge", A, x, semiring, 14336)


@register("merge_stock", reference_analog="cub_merge.cuh:16-55",
          aliases=("cub_merge",), supports_semiring=True)
def _merge_stock(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV with the library-default (untuned) tile size: the
    same pipeline as `merge`, smaller equal-nnz tiles."""
    return _merge_fast("merge_stock", A, x, semiring, 8192)


@register("merge_genl", supports_semiring=True,
          reference_analog="merge_genl/* (merge_genl.cuh:41-80)")
def _merge_genl(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Semiring-generalized merge-path SpMV: plus-times takes the
    prefix-difference bodies (K2, K6), other rings the segmented-scan
    bodies (K7, K8); a user-defined ring runs on a CPU tensor."""
    return _merge_fast("merge_genl", A, x, semiring, 14336)
