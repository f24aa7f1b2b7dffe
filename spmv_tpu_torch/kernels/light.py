"""LightSpMV analogs: load-balanced row scheduling.

Counterpart of `spmv_tpu/kernels/light.py`. The reference's LightSpMV
balances load at run time with an atomic row counter; the TPU design
balances it at plan time, and the port keeps that design:

- ``light_vec`` and ``light_warp``: the stream pipeline, whose tiles
  hold equal nonzero counts, with the tile size (kappa) picked from the
  row-length skew (p99 / mean) by a fine and a coarse table;
- past the stream planner's reach they warn (`FallbackWarning`) and run
  ``light_vec_ell`` / ``light_warp_ell``: rows binned by length, each
  bin packed at its own ELL width and run through K9 -> K11 with the
  tree strategy, the bins' partial y folded by the ring's reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR, value_dtype
from spmv_tpu_torch.kernels.ell import device_ell_plan, ell_spmv
from spmv_tpu_torch.kernels import stream
from spmv_tpu_torch.ops.registry import (PlanCapacityError, plan_cache, register,
                                         warn_fallback)
from spmv_tpu_torch.ops.semiring import PLUS_TIMES, Semiring
from spmv_tpu_torch.ops.tuning import detect_chip, dispatch_fields

FINE_BINS = (1, 2, 4, 8, 16, 32, 64, 128)
COARSE_BINS = (8, 32, 128)

# (skew upper bound -> kappa): the fine table reacts to mild skew, the
# coarse one only to extreme skew
FINE_KAPPA = ((2.0, 14336), (8.0, 12288), (32.0, 10240), (1e30, 8192))
COARSE_KAPPA = ((8.0, 14336), (64.0, 12288), (1e30, 10240))


def _skew(A: CSR) -> float:
    lens = A.row_lengths()
    if lens.size == 0 or lens.mean() == 0:
        return 1.0
    return float(np.percentile(lens, 99) / max(lens.mean(), 1e-9))


def _kappa_for(A: CSR, table) -> int:
    s = _skew(A)
    for bound, kappa in table:
        if s <= bound:
            return kappa
    return table[-1][1]


def _bin_rows(A: CSR, widths):
    """Assign each row to the smallest width >= its nnz (the last bin
    takes the rest, chunked). Returns [(width, sorted_row_ids), ...]."""
    lens = A.row_lengths()
    bins = []
    assigned = np.zeros(A.n_rows, dtype=bool)
    for w in widths[:-1]:
        lo = ~assigned & (lens <= w)
        rows = np.nonzero(lo)[0]
        if rows.size:
            bins.append((w, rows))
        assigned |= lo
    rows = np.nonzero(~assigned)[0]
    if rows.size:
        bins.append((widths[-1], rows))
    return bins


def light_plans(A: CSR, widths, key: str, device) -> list:
    """One ELL plan per non-empty row-length bin, on `device`."""
    bins = plan_cache(A, (key, "bins"), lambda: _bin_rows(A, widths))
    return [device_ell_plan(A, (key, "ell", w), lambda rows=rows: rows, w, device)
            for w, rows in bins]


def _light_ell_impl(A: CSR, x, semiring: Semiring, widths, key: str):
    plans = light_plans(A, widths, key, x.device)
    if not plans:
        ident = float(semiring.identity_for(value_dtype(A.Ax)))
        return torch.full((A.n_rows,), ident, dtype=x.dtype, device=x.device)
    y = None
    for plan in plans:
        part = ell_spmv(A, x, semiring, plan, "tree")
        # each bin covers its own rows and gives the rest the identity
        y = part if y is None else semiring.reduce(y, part)
    return y


def _light_fast(A: CSR, x, semiring: Semiring, table, widths, key: str):
    kappa = plan_cache(A, (key, "kappa"), lambda: _kappa_for(A, table))
    try:
        return stream._stream_spmv(A, x, semiring, stream.StreamPolicy(
            kappa=kappa, **dispatch_fields(chip=detect_chip(x.device))))
    except PlanCapacityError as e:
        warn_fallback(key, "ELL", e)
        return _light_ell_impl(A, x, semiring, widths, key)


@register("light_vec", supports_semiring=True,
          reference_analog="LightSpMV.cuh:110-182,376-395")
def _light_vec(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Skew-adaptive SpMV, fine grain table (LightSpMV vector-dynamic
    analog: plan-time load balancing replaces the atomic row counter)."""
    return _light_fast(A, x, semiring, FINE_KAPPA, FINE_BINS, "light_vec")


@register("light_warp", supports_semiring=True,
          reference_analog="LightSpMV.cuh:184-263,397-416")
def _light_warp(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Skew-adaptive SpMV, coarse grain table (LightSpMV warp-dynamic
    analog)."""
    return _light_fast(A, x, semiring, COARSE_KAPPA, COARSE_BINS, "light_warp")


@register("light_vec_ell", supports_semiring=True,
          reference_analog="LightSpMV.cuh:110-182 (static-binned ELL)")
def _light_vec_ell(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Binned-row ELL SpMV, fine bins: rows bucketed by length, each bin
    packed at its own width; the reach fallback."""
    return _light_ell_impl(A, x, semiring, FINE_BINS, "light_vec")


@register("light_warp_ell", supports_semiring=True,
          reference_analog="LightSpMV.cuh:184-263 (static-binned ELL)")
def _light_warp_ell(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Binned-row ELL SpMV, coarse bins; the reach fallback."""
    return _light_ell_impl(A, x, semiring, COARSE_BINS, "light_warp")
