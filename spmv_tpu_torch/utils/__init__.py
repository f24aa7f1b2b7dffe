from spmv_tpu_torch.utils.timing import cuda_time_ms

__all__ = ["cuda_time_ms"]
