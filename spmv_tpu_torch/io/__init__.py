from spmv_tpu_torch.io.generate import random_csr, banded_csr, power_law_csr

__all__ = ["random_csr", "banded_csr", "power_law_csr"]
