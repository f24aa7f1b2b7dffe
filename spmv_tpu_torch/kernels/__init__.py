"""Ported kernels. Importing this package registers the ported kinds.

| kind        | strategy                                                |
|-------------|---------------------------------------------------------|
| stream      | x prep (K1) + gather: early reduction (K2, or K7 for    |
|             | other rings), fused with split 1 (K3) or plain (K4) +   |
|             | planned shuffle (K5 per pass) + scan (K6, or K8 for     |
|             | other rings) + window merge (glue)                      |
| merge       | the stream pipeline at the reference's merge kappas     |
| merge_stock | (14336, 8192, 14336); alias cub_merge for merge_stock   |
| merge_genl  |                                                         |
"""

from spmv_tpu_torch.kernels import stream  # noqa: F401  (registers 'stream')
from spmv_tpu_torch.kernels import merge  # noqa: F401  (registers 'merge*')
