"""Ported kernels. Importing this package registers the ported kinds.

| kind     | strategy                                                  |
|----------|-----------------------------------------------------------|
| stream   | x prep (K1) + gather with early reduction (K2) + planned  |
|          | shuffle (K5 per pass) + scan (K6) + window merge (glue)   |
"""

from spmv_tpu_torch.kernels import stream  # noqa: F401  (registers 'stream')
