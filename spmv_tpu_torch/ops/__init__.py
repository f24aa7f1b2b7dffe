from spmv_tpu_torch.ops.semiring import Semiring, PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND
from spmv_tpu_torch.ops.registry import register, get_kernel, list_kinds, spmv, SpMV
from spmv_tpu_torch.ops.reference import spmv_ref, spmv_ref_semiring

__all__ = [
    "Semiring",
    "PLUS_TIMES",
    "MIN_PLUS",
    "MAX_TIMES",
    "OR_AND",
    "register",
    "get_kernel",
    "list_kinds",
    "spmv",
    "SpMV",
    "spmv_ref",
    "spmv_ref_semiring",
]
