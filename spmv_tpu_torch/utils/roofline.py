"""Roofline model: speed-of-light targets for memory-bound SpMV.

Counterpart of `spmv_tpu/utils/roofline.py`, with the same byte model:
SpMV moves, per nonzero, at least Ax (4 B fp32) + Aj (4 B int32) + an
x-gather (4 B amortized), plus per row Ap (4 B) + y (4 B). Speed of
light = memory bandwidth / bytes per nonzero. The harness prints
achieved against it, so every kind is audited against the card, not
against other kinds.

The bandwidths are published figures, as the reference's are: the
H100 SXM's 3.35 TB/s is the one `chip_smoke.py`'s kernel bounds and
`PERF.md` use (NVIDIA's data sheet, at the card's 700 W limit).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Published memory bandwidths (GB/s), keyed by torch.cuda.get_device_name.
CHIP_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # the SXM5 part
    "NVIDIA H100 PCIe": 2000.0,
    "cpu": 50.0,  # placeholder for CPU runs: no device figure
}
_FALLBACK = "NVIDIA H100 80GB HBM3"  # the one card the port is measured on


def chip_specs(device=None) -> tuple:
    """(name, memory GB/s) of `device` (default: the current CUDA card
    where there is one, else the CPU): ('cpu', placeholder) for a CPU
    device, else the card's `torch.cuda.get_device_name` and its
    published rate; a card the table lacks gets the H100 SXM's rate."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", CHIP_HBM_GBPS["cpu"]
    name = torch.cuda.get_device_name(device)
    return name, CHIP_HBM_GBPS.get(name, CHIP_HBM_GBPS[_FALLBACK])


@dataclasses.dataclass
class RooflineModel:
    chip: str
    hbm_gbps: float
    bytes_per_nnz: float
    bytes_per_row: float

    def sol_nnz_per_s(self, mean_nnz_per_row: float) -> float:
        bytes_per_nnz_eff = self.bytes_per_nnz + self.bytes_per_row / max(
            mean_nnz_per_row, 1e-9
        )
        return self.hbm_gbps * 1e9 / bytes_per_nnz_eff

    def sol_gflops(self, mean_nnz_per_row: float) -> float:
        return 2.0 * self.sol_nnz_per_s(mean_nnz_per_row) / 1e9


def speed_of_light(
    nnz: int,
    n_rows: int,
    value_bytes: int = 4,
    index_bytes: int = 4,
    offset_bytes: int = 4,
    device: Optional[torch.device] = None,
) -> RooflineModel:
    chip, bw = chip_specs(device)
    return RooflineModel(
        chip=chip,
        hbm_gbps=bw,
        bytes_per_nnz=value_bytes + index_bytes + value_bytes,  # Ax + Aj + x
        bytes_per_row=offset_bytes + value_bytes,  # Ap + y
    )
