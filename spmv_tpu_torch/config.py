"""Global configuration for spmv_tpu_torch: the on-disk plan cache dir.

`spmv_tpu.config.set_interpret` has no counterpart here: the device of
`x` decides whether a kernel launches on the card (CUDA tensor) or its
plain PyTorch version runs (CPU tensor).
"""

from __future__ import annotations

import os
from typing import Optional

_plan_dir_override: Optional[str] = None


def set_plan_dir(path: Optional[str]) -> None:
    """Directory for the on-disk plan cache (None or "" disables)."""
    global _plan_dir_override
    _plan_dir_override = path


def plan_dir() -> Optional[str]:
    """On-disk plan cache directory, or None when disabled.

    Set with set_plan_dir() or SPMV_TPU_PLAN_DIR. Plans are pure
    functions of (matrix, policy); caching them turns the O(nnz) host
    planning cost into a one-time build per matrix (utils/plancache).
    The file format is the reference's, so both packages can share a
    directory.
    """
    if _plan_dir_override is not None:
        return _plan_dir_override or None
    return os.environ.get("SPMV_TPU_PLAN_DIR") or None
