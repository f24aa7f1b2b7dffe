"""spmv_tpu_torch — the PyTorch + CUDA port of spmv_tpu.

The JAX package `spmv_tpu` is the reference, unchanged; this package
carries the same public surface for what has been ported so far:

- COO/CSR host containers and the synthetic generators (io.generate);
- semirings and the NumPy oracle;
- the string-dispatched registry: `spmv(kind, A, x)` runs on `x.device`;
- the kind 'stream' (plus-times and or-and on float32): the reference's
  planner (NumPy + native C++), and its four device kernels written by
  hand for Hopper in CUDA C++ (csrc/), each beside a plain PyTorch
  version that runs on the CPU.

Importing the package never imports JAX.
"""

from spmv_tpu_torch.formats import COO, CSR, coo_to_csr, csr_to_dense
from spmv_tpu_torch.ops.semiring import (
    Semiring,
    PLUS_TIMES,
    MIN_PLUS,
    MAX_TIMES,
    OR_AND,
)
from spmv_tpu_torch.ops.registry import (
    register,
    get_kernel,
    list_kinds,
    spmv,
    SpMV,
    plan_cache,
    PlanCapacityError,
    FallbackWarning,
)
from spmv_tpu_torch.ops.reference import spmv_ref, spmv_ref_semiring

# Importing the kernel modules registers the ported kinds.
from spmv_tpu_torch import kernels as _kernels  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "coo_to_csr",
    "csr_to_dense",
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
    "plan_cache",
    "PlanCapacityError",
    "FallbackWarning",
    "spmv_ref",
    "spmv_ref_semiring",
]
