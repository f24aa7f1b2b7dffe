"""spmv_tpu_torch — the PyTorch + CUDA port of spmv_tpu.

The JAX package `spmv_tpu` is the reference, unchanged; this package
carries its public surface (all of `spmv_tpu.__all__`, plus names of its
own):

- COO/CSR host containers, Matrix Market I/O (`read_matrix_market`,
  `write_matrix_market`, io.matrix_market) and the synthetic
  generators (io.generate);
- semirings, `segment_reduce_sorted` and the NumPy oracle;
- where host inputs go (`config`): a NumPy x, b or X goes to the card
  unless the process asked for the CPU (`config.set_default_device("cpu")`),
  as the reference's `jnp.asarray` puts it on the TPU; a tensor keeps its
  device, and every entry point computes where its input lies;
- the string-dispatched registry: `spmv(kind, A, x)` runs on x's device.
  All 20 of the reference's kinds dispatch, on float32, in every
  built-in ring (any ring on the CPU): 'stream'; 'merge', 'merge_stock'
  (alias 'cub_merge'), 'merge_genl' and 'merge_tiled'; 'csr_vector'
  ('cusp'), 'csr_vector_shfl' ('cusp1'), 'csr_vector_shfl2' ('cusp2'),
  their three '*_ell' kinds and 'csr_scalar'; 'light_vec', 'light_warp'
  and their '*_ell' kinds; 'dia'; 'xla' ('cusparse'), 'cpu_naive'
  ('cpu_navie') and 'dense';
- `spmm(A, X)` for a dense block of right-hand sides (kernels/spmm.py);
- the reference's host planners (NumPy + native C++), and seventeen
  device kernels written by hand for Hopper in CUDA C++ (csrc/): the
  stream pipeline's eight (K1-K8), the paged gather (K9), the merge
  scan and carry chain (K10), the ELL group reduce (K11) and its
  per-shard form (K11'), the DIA fold (K12), the SpMM window product
  (K13), the triangular solve (K14), GMRES's least squares (K15) and
  the sorted-segment fold (K16), each beside a plain PyTorch version
  that runs on the CPU;
- the multi-device layer (spmv_tpu_torch.parallel): the halo-exchange
  plan, shard meshes on torch.distributed (or every shard in one
  process), `distribute_csr` and `distribute_stream`, and its
  weak-scaling bench (spmv_tpu_torch.bench.weak_scaling);
- `spgemm(A, B)` over any ring: a host symbolic phase (native or NumPy)
  and the numeric phase as an SpMV on a virtual CSR, on the card by
  default (kernels/spgemm.py);
- level-scheduled triangular solves `sptrsv` (one K14 launch each on
  the card), the ILU(0) factorization `ilu0` and its apply `ilu0_apply`
  (kernels/trisolve.py);
- the Krylov solvers `cg`, `bicgstab` and `gmres` (solvers.py), on the
  device of b (as placed by `config`), with Jacobi, ILU(0) or callable
  preconditioning; cg and bicgstab keep the stopping test on the device
  and replay a CUDA graph per chunk of iterations;
- autograd: `SparseOperator` (a kind forward, the same kind on A^T
  backward) and `spmv_values` (differentiable in the values too)
  (ops/autodiff.py);
- SciPy and torch.sparse interop (io/interop.py) and reverse
  Cuthill-McKee reordering (ops/reorder.py);
- the examples: shortest paths (examples/shortest_paths.py), a 2-D
  Poisson solve by CG (examples/solve_poisson.py), PageRank
  (examples/pagerank.py) and BFS (examples/bfs.py);
- the bench harness (`python -m spmv_tpu_torch.bench.harness`): each
  kind against the float64 oracle, timed by CUDA events, beside the
  roofline (utils/timing.py, utils/roofline.py).

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
from spmv_tpu_torch.io.matrix_market import read_matrix_market, write_matrix_market

# Importing the kernel modules registers the ported kinds.
from spmv_tpu_torch import kernels as _kernels  # noqa: F401
from spmv_tpu_torch.kernels.spmm import spmm
from spmv_tpu_torch.kernels.spgemm import spgemm
from spmv_tpu_torch.kernels.trisolve import sptrsv, ilu0, ilu0_apply
from spmv_tpu_torch.solvers import bicgstab, cg, gmres
from spmv_tpu_torch.ops.autodiff import SparseOperator, spmv_values

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
    "read_matrix_market",
    "write_matrix_market",
    "spmm",
    "spgemm",
    "sptrsv",
    "ilu0",
    "ilu0_apply",
    "cg",
    "bicgstab",
    "gmres",
    "SparseOperator",
    "spmv_values",
]
