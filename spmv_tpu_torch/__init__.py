"""spmv_tpu_torch — the PyTorch + CUDA port of spmv_tpu.

The JAX package `spmv_tpu` is the reference, unchanged; this package
carries the same public surface for what has been ported so far:

- COO/CSR host containers and the synthetic generators (io.generate);
- semirings, `segment_reduce_sorted` and the NumPy oracle;
- the string-dispatched registry: `spmv(kind, A, x)` runs on `x.device`.
  All 20 of the reference's kinds dispatch, on float32, in every
  built-in ring (any ring on the CPU): 'stream'; 'merge', 'merge_stock'
  (alias 'cub_merge'), 'merge_genl' and 'merge_tiled'; 'csr_vector'
  ('cusp'), 'csr_vector_shfl' ('cusp1'), 'csr_vector_shfl2' ('cusp2'),
  their three '*_ell' kinds and 'csr_scalar'; 'light_vec', 'light_warp'
  and their '*_ell' kinds; 'dia'; 'xla' ('cusparse'), 'cpu_naive'
  ('cpu_navie') and 'dense';
- `spmm(A, X)` for a dense block of right-hand sides (kernels/spmm.py);
- the reference's host planners (NumPy + native C++), and fourteen
  device kernels written by hand for Hopper in CUDA C++ (csrc/): the
  stream pipeline's eight (K1-K8), the paged gather (K9), the merge
  scan and carry chain (K10), the ELL group reduce (K11) and its
  per-shard form (K11'), the DIA fold (K12) and the SpMM window product
  (K13), each beside a plain PyTorch version that runs on the CPU;
- the multi-device layer (spmv_tpu_torch.parallel): the halo-exchange
  plan, shard meshes on torch.distributed (or every shard in one
  process), `distribute_csr` and `distribute_stream`, and its
  weak-scaling bench (spmv_tpu_torch.bench.weak_scaling);
- the Krylov solvers `cg`, `bicgstab` and `gmres` (solvers.py), on the
  device of b, with Jacobi or callable preconditioning;
- the examples: shortest paths (examples/shortest_paths.py) and a 2-D
  Poisson solve by CG (examples/solve_poisson.py).

Importing the package never imports JAX.
"""

from spmv_tpu_torch.formats import COO, CSR, coo_to_csr, csr_from_dense, csr_to_dense
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
from spmv_tpu_torch.kernels.spmm import spmm
from spmv_tpu_torch.solvers import bicgstab, cg, gmres

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "coo_to_csr",
    "csr_from_dense",
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
    "spmm",
    "cg",
    "bicgstab",
    "gmres",
]
