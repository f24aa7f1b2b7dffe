from spmv_tpu_torch.io.matrix_market import read_matrix_market, write_matrix_market
from spmv_tpu_torch.io.generate import (
    random_csr,
    banded_csr,
    power_law_csr,
    kron_graph_csr,
)

__all__ = [
    "read_matrix_market",
    "write_matrix_market",
    "random_csr",
    "banded_csr",
    "power_law_csr",
    "kron_graph_csr",
]
