"""Ported kernels. Importing this package registers the ported kinds.

| kind                    | strategy                                       |
|-------------------------|------------------------------------------------|
| stream                  | x prep (K1) + gather: early reduction (K2, or  |
|                         | K7 for other rings), fused with split 1 (K3)   |
|                         | or plain (K4) + planned shuffle (K5 per pass)  |
|                         | + scan (K6, or K8 for other rings) + window    |
|                         | merge (glue)                                   |
| merge, merge_stock      | the stream pipeline at the reference's merge   |
| (cub_merge), merge_genl | kappas (14336, 8192, 14336); merge_tiled past  |
|                         | the planner's reach                            |
| merge_tiled             | paged x gather (K9) + segmented scan, row-end  |
|                         | route and carry chain (K10) + ownership gather |
|                         | (K9)                                           |
| csr_vector (cusp),      | DIA (K12) on diagonal-sparse matrices, else    |
| csr_vector_shfl (cusp1),| the stream pipeline at kappa 12288 (roll scan  |
| csr_vector_shfl2        | K8, or K6 where the ring has an inverse); ELL  |
| (cusp2)                 | past the planner's reach                       |
| light_vec, light_warp   | the stream pipeline at a skew-picked kappa;    |
|                         | binned ELL past the planner's reach            |
| csr_vector_ell,         | direct ELL: paged x gather (K9) + group reduce |
| csr_vector_shfl_ell,    | (K11: linear, tree, broadcast) + segment fold  |
| csr_vector_shfl2_ell,   | (K16); the light kinds one ELL plan            |
| csr_scalar,             | per row-length bin                             |
| light_vec_ell,          |                                                |
| light_warp_ell          |                                                |
| dia                     | DIA fold (K12); the stream pipeline otherwise  |
| xla (cusparse)          | torch gather (glue) + segment fold (K16)       |
| cpu_naive (cpu_navie)   | the NumPy oracle on the host                   |
| dense                   | densify + torch.matmul                         |
"""

from spmv_tpu_torch.kernels import stream  # noqa: F401  (registers 'stream')
from spmv_tpu_torch.kernels import merge  # noqa: F401  (registers 'merge*')
from spmv_tpu_torch.kernels import dia  # noqa: F401  (registers 'dia')
from spmv_tpu_torch.kernels import csr_vector  # noqa: F401  (csr_vector*, csr_scalar)
from spmv_tpu_torch.kernels import light  # noqa: F401  (registers 'light_*')
from spmv_tpu_torch.kernels import baseline  # noqa: F401  (cpu_naive, xla, dense)
