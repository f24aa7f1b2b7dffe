from spmv_tpu_torch.utils.timing import BenchResult, benchmark_spmv, cuda_time_ms
from spmv_tpu_torch.utils.roofline import RooflineModel, chip_specs, speed_of_light

__all__ = [
    "benchmark_spmv",
    "BenchResult",
    "cuda_time_ms",
    "speed_of_light",
    "RooflineModel",
    "chip_specs",
]
