"""Tuning-policy layer: per-chip tables of stream policies.

Counterpart of `spmv_tpu/ops/tuning.py`: stream-pipeline policies keyed
on the chip and the value width, plus an override that an autotune run
installs. Only chips with a measured row are listed. No GPU has been
measured yet, so a card (the H100 included) gets the default
`StreamPolicy()` and a one-time hint that its row is unmeasured.
The reference's `autotune_stream` is not ported yet.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from typing import Optional

import torch

# chip -> value-byte-width -> policy fields
CHIP_TABLES = {
    # cpu = the plain versions in the CPU tests; throughput is not
    # meaningful there, the row only pins plan geometry (as the
    # reference's cpu row does)
    "cpu": {4: {"kappa": 12288}, 8: {"kappa": 12288}, 2: {"kappa": 12288}},
}
_warned_unmeasured = set()

_ACTIVE: Optional[dict] = None  # autotuned override, if any

_KNOWN_CARDS = ("h100", "h200", "a100", "l40s")


def detect_chip(device=None) -> str:
    """'cpu' for a CPU device, else a short name of the CUDA card
    (e.g. 'h100'; the full lower-cased device name when unknown)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return _card_name(device.index if device.index is not None
                      else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    name = torch.cuda.get_device_name(index).lower()
    for key in _KNOWN_CARDS:
        if key in name:
            return key
    return name


def policy_for(value_bytes: int = 4, chip: Optional[str] = None):
    """The active stream policy: the autotuned override if set, else the
    chip's table row. A chip without a measured row gets the defaults
    and a one-time hint to run an autotune."""
    from spmv_tpu_torch.kernels.stream import StreamPolicy

    if _ACTIVE is not None:
        return StreamPolicy(**_ACTIVE)
    chip = chip or detect_chip()
    if chip not in CHIP_TABLES:
        if chip not in _warned_unmeasured:
            _warned_unmeasured.add(chip)
            print(f"spmv_tpu_torch: no measured tuning row for chip "
                  f"{chip!r}; using the default StreamPolicy (unmeasured) "
                  f"— run an autotune to refit", file=sys.stderr)
        return StreamPolicy()
    return StreamPolicy(**CHIP_TABLES[chip].get(value_bytes, {}))


# Dispatch-time knobs (they do not shape the plan; see
# StreamPolicy.structural_fields).
_DISPATCH_FIELDS = ("scan_sbt",)


def dispatch_fields(value_bytes: int = 4, chip: Optional[str] = None) -> dict:
    """Chip-tuned dispatch-only policy fields, for kinds that build their
    own StreamPolicy around a kind-specific kappa."""
    if _ACTIVE is not None:
        src = _ACTIVE
    else:
        src = CHIP_TABLES.get(chip or detect_chip(), {}).get(value_bytes, {})
    return {k: v for k, v in src.items() if k in _DISPATCH_FIELDS}


def set_active(fields: Optional[dict]):
    """Install (or clear, with None) an autotuned policy override."""
    global _ACTIVE
    _ACTIVE = dict(fields) if fields is not None else None


def load_table(path: str) -> Optional[dict]:
    """Load and install this chip's autotuned policy; returns it."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        table = json.load(f)
    fields = table.get(detect_chip())
    if fields:
        set_active(fields)
    return fields
