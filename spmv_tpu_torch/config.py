"""Global configuration for spmv_tpu_torch: where host inputs go, and the
on-disk plan cache dir.

Where a host input goes is the counterpart of JAX's default device, which
decides where the reference's `jnp.asarray` puts a NumPy array: the card,
unless the process asks for the CPU (`set_default_device("cpu")`). A
tensor keeps its device, so a CPU tensor is the caller asking for the
CPU. `spmv_tpu.config.set_interpret` has no counterpart here: the device
of the input decides whether a kernel launches on the card (CUDA tensor)
or its plain PyTorch version runs (CPU tensor).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_plan_dir_override: Optional[str] = None
_default_device: Optional[torch.device] = None  # None: the current card


def set_default_device(device) -> None:
    """Where host inputs (NumPy arrays, lists, scalars) go from now on in
    this process: "cpu" (or any torch device) asks for it, None gives the
    card back."""
    global _default_device
    _default_device = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The device a host input goes to: the current card, as
    torch.device("cuda", torch.cuda.current_device()), unless the process
    asked for another with set_default_device. Raises RuntimeError when
    that is the card and CUDA is not available."""
    return device_for(None)


def device_for(device=None, *, who: str = "spmv_tpu_torch",
               how: Optional[str] = None) -> torch.device:
    """`device` where given, else default_device(), with a CUDA device's
    index filled in (the current card), so that it compares equal to the
    device of the tensors placed on it. A CUDA device without CUDA raises
    RuntimeError naming the ways to ask for the CPU: `how`, the caller's
    own way (by default "pass CPU tensors"), and set_default_device("cpu")
    where no device was given. The CPU is never chosen unasked."""
    dev = torch.device(device if device is not None else
                       _default_device if _default_device is not None else "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        if device is None:
            what = "the default device is the card unless the CPU is asked for"
            asks = [how or "pass CPU tensors",
                    'call spmv_tpu_torch.config.set_default_device("cpu")']
        else:
            what, asks = f"{dev} was asked for", [how or 'pass device="cpu"']
        raise RuntimeError(f"{who}: {what}, and CUDA is not available; to run on "
                           f"the CPU, {' or '.join(asks)}")
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


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
