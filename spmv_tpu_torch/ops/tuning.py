"""Tuning-policy layer: per-chip tables of stream policies.

Counterpart of `spmv_tpu/ops/tuning.py`: stream-pipeline policies keyed
on the chip and the value width, plus an override that an autotune run
installs. Only chips with a measured row are listed. No GPU has been
measured yet, so a card (the H100 included) gets the default
`StreamPolicy()` and a one-time hint that its row is unmeasured.
`autotune_stream` measures candidate tile sizes on x's device (the
bench harness's `--autotune`), and `save_table` / `load_table` keep
the winner per chip in a JSON table.
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


def load_table(path: str, chip: Optional[str] = None) -> Optional[dict]:
    """Load and install chip's (default: the detected chip's) autotuned
    policy; returns it."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        table = json.load(f)
    fields = table.get(chip or detect_chip())
    if fields:
        set_active(fields)
    return fields


def autotune_stream(A, x, kappas=(8192, 10240, 12288, 14336, 16384),
                    iters=20, verbose=True):
    """Measure candidate tile sizes on x's device; returns (best_fields,
    results). Install with set_active / save_table.

    Two stages, as the reference's: kappa first (plan geometry, one plan
    build each), then scan_sbt at the winning kappa (the winner's plan
    is reused: scan_sbt does not shape it). Each candidate's time is the
    median of 3 `benchmark_fn` samples of a plus-times stream call."""
    from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.ops.semiring import PLUS_TIMES
    from spmv_tpu_torch.utils.timing import benchmark_fn

    def _med3(pol):
        ks = sorted(benchmark_fn(lambda v: _stream_spmv(A, v, PLUS_TIMES, pol),
                                 x, iters=iters)[1] for _ in range(3))
        return ks[1]

    def _try(fields, what):
        pol = StreamPolicy(**fields)
        try:
            kern = _med3(pol)
        except (PlanCapacityError, ValueError) as e:
            if verbose:
                print(f"autotune {what}: failed ({e})", file=sys.stderr)
            return
        results.append({"kappa": pol.kappa, "scan_sbt": pol.scan_sbt,
                        "kernel_s": kern})
        if verbose:
            print(f"autotune {what}: {kern * 1e3:.4f} ms (med3)", file=sys.stderr)

    results = []
    for kappa in kappas:
        _try({"kappa": kappa}, f"kappa={kappa}")
    if not results:
        raise RuntimeError("autotune: no candidate policy planned")
    best = min(results, key=lambda r: r["kernel_s"])
    for scan_sbt in (16,):
        _try({"kappa": best["kappa"], "scan_sbt": scan_sbt}, f"scan_sbt={scan_sbt}")
    best = min(results, key=lambda r: r["kernel_s"])
    return {"kappa": best["kappa"], "scan_sbt": best["scan_sbt"]}, results


def save_table(fields: dict, path: str, chip: Optional[str] = None):
    """Write `fields` as chip's row (default: the detected chip) of the
    JSON table at `path`, keeping its other rows."""
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    table[chip or detect_chip()] = fields
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)


def default_table_path() -> str:
    """Where the harness's --autotune keeps its result and where the
    harness reloads it at start: scratch/ at the repository's root
    (git-ignored), in a file of the port's own, apart from the
    reference's."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "scratch", "tuned_tables_torch.json")
