"""Tuning-policy layer: per-chip tables of stream policies.

Counterpart of `spmv_tpu/ops/tuning.py`: stream-pipeline policies keyed
on the chip and the value width, plus an override that an autotune run
installs. Only chips with a measured row are listed: the H100 (measured
by `scripts/tune_stream_torch.py`) and the CPU. A card with no row gets
the closest measured one, the H100's, and a one-time hint to run an
autotune, as the reference's chips without a row get its v5e row.
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

# chip -> value-byte-width -> policy fields. ONLY chips listed here
# carry measured numbers; any other card falls back to the h100 row plus
# a one-time autotune hint (see policy_for).
CHIP_TABLES = {
    # measured on an NVIDIA H100 80GB HBM3 at 700 W
    # (scripts/tune_stream_torch.py: autotune sweeps in 3 processes a
    # width on the 3.3M-nnz power-law bench matrix, the median over the
    # runs): kappa 14336 110.53 us a call in float32, 103.97 in
    # bfloat16, against 16384 111.15 / 104.27, 12288 111.30 / 104.03,
    # 10240 110.93 / 104.91 and 8192 130.33 / 122.48 (one run's 100.20
    # at 16384 and 92.84 at 12288 were flukes: early reduction caps
    # bench's kappa at 12288, so 12288-16384 build one plan). Held in
    # one call on wide_row, random 4.2M, the sssp graph, the 1M-row
    # nonsymmetric matrix and distribute_stream, 16384 plans as 14336 on
    # each (the planner steps both down to one kappa) and 10240 is 6%
    # slower on the graph. scan_sbt is the reference's 8: the port's
    # scan kernels do not read it. No 8-byte entry: the card refuses
    # 8-byte values (kernels/_cuda.py:value_code).
    "h100": {4: {"kappa": 14336, "scan_sbt": 8},
             2: {"kappa": 14336, "scan_sbt": 8}},
    # cpu = the plain versions in the CPU tests; throughput is not
    # meaningful there, the row only pins plan geometry (as the
    # reference's cpu row does)
    "cpu": {4: {"kappa": 12288}, 8: {"kappa": 12288}, 2: {"kappa": 12288}},
}
_FALLBACK_CHIP = "h100"  # the closest measured card for a100/h200/l40s/others
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


def _row_chip(chip: Optional[str]) -> str:
    """chip (default: the detected one) if it has a row, else the
    fallback chip, with a one-time hint naming the row used."""
    chip = chip or detect_chip()
    if chip in CHIP_TABLES:
        return chip
    if chip not in _warned_unmeasured:
        _warned_unmeasured.add(chip)
        print(f"spmv_tpu_torch: no measured tuning row for chip {chip!r}; "
              f"using the {_FALLBACK_CHIP} row — run an autotune (the "
              f"harness's --autotune) to refit", file=sys.stderr)
    return _FALLBACK_CHIP


def policy_for(value_bytes: int = 4, chip: Optional[str] = None):
    """The active stream policy: the autotuned override if set, else the
    chip's table row. A chip without a measured row uses the closest
    measured chip's row (the h100's) and gets a one-time hint to run an
    autotune. A width the row leaves out (the h100's 8 bytes: the card
    refuses 8-byte values) gets the defaults."""
    from spmv_tpu_torch.kernels.stream import StreamPolicy

    if _ACTIVE is not None:
        return StreamPolicy(**_ACTIVE)
    return StreamPolicy(**CHIP_TABLES[_row_chip(chip)].get(value_bytes, {}))


# Dispatch-time knobs (they do not shape the plan; see
# StreamPolicy.structural_fields).
_DISPATCH_FIELDS = ("scan_sbt",)


def dispatch_fields(value_bytes: int = 4, chip: Optional[str] = None) -> dict:
    """Chip-tuned dispatch-only policy fields, for kinds that build their
    own StreamPolicy around a kind-specific kappa."""
    if _ACTIVE is not None:
        src = _ACTIVE
    else:
        src = CHIP_TABLES[_row_chip(chip)].get(value_bytes, {})
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


KAPPAS = (8192, 10240, 12288, 14336, 16384)  # autotune's kappa candidates


def med3_kernel_s(fn, x, iters=20) -> float:
    """The median of 3 `benchmark_fn` kernel_s samples of fn(x)."""
    from spmv_tpu_torch.utils.timing import benchmark_fn

    return sorted(benchmark_fn(fn, x, iters=iters)[1] for _ in range(3))[1]


def autotune_stream(A, x, kappas=KAPPAS, iters=20, verbose=True):
    """Measure candidate tile sizes on x's device; returns (best_fields,
    results). Install with set_active / save_table.

    Two stages, as the reference's: kappa first (plan geometry, one plan
    build each), then scan_sbt at the winning kappa (the winner's plan
    is reused: scan_sbt does not shape it). Each candidate's time is the
    median of 3 `benchmark_fn` samples of a plus-times stream call."""
    from spmv_tpu_torch.kernels.stream import StreamPolicy, _stream_spmv
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.ops.semiring import PLUS_TIMES

    def _try(fields, what):
        pol = StreamPolicy(**fields)
        try:
            kern = med3_kernel_s(lambda v: _stream_spmv(A, v, PLUS_TIMES, pol), x, iters)
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
