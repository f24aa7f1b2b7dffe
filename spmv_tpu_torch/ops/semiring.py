"""Semiring abstraction for generalized SpMV.

Counterpart of `spmv_tpu/ops/semiring.py`. A semiring provides

    initialize() -> identity of `reduce`
    combine(a_ij, x_j) -> product term
    reduce(acc, v) -> accumulation

as callables on torch tensors (elementwise, broadcasting). `reduce`
must be associative. The plain PyTorch versions of the kernels take any
such ring. The CUDA kernels are instantiated per built-in ring
(csrc/ring.cuh): `device_ring_code` maps a ring, by object identity, to
its instantiation, and raises for a user-defined ring, whose Python
callables cannot enter a CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    initialize: Callable[[], float]  # identity of reduce
    combine: Callable  # (a_ij, x_j) -> term
    reduce: Callable  # (acc, v) -> acc'   (associative)

    def identity_for(self, dtype) -> np.ndarray:
        """Identity value cast to a concrete NumPy dtype (±inf becomes
        the integer extreme for integer dtypes)."""
        ident = self.initialize()
        dt = np.dtype(dtype)
        if np.isinf(ident) and dt.kind in "iu":
            info = np.iinfo(dt)
            return np.array(info.max if ident > 0 else info.min, dtype=dt)
        return np.array(ident, dtype=dt)


# The conventional (+, x) ring.
PLUS_TIMES = Semiring(
    name="plus_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: acc + v,
)

# Tropical (min, +): shortest-path relaxation.
MIN_PLUS = Semiring(
    name="min_plus",
    initialize=lambda: float("inf"),
    combine=lambda a, x: a + x,
    reduce=lambda acc, v: torch.minimum(acc, v),
)

# (max, x): maximum-reliability paths.
MAX_TIMES = Semiring(
    name="max_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: torch.maximum(acc, v),
)


def _or_and_combine(a, x):
    """Boolean (or, and) combine on any data: (a != 0) AND (x != 0)
    as {0, 1} in the promoted value dtype."""
    t = (a != 0) & (x != 0)
    return t.to(torch.promote_types(a.dtype, x.dtype))


OR_AND = Semiring(
    name="or_and",
    initialize=lambda: 0.0,
    combine=_or_and_combine,
    reduce=lambda acc, v: torch.maximum(acc, v),
)

BUILTIN_SEMIRINGS = {
    s.name: s for s in (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
}

# or_and rides the plus-times kernels on float32 as a COUNTING ring:
# combine yields {0,1}, reduce is +, and the caller thresholds the
# counts at the end (or = sum > 0 over non-negatives). Its name is the
# reference's, whose kernels pick their plus-times bodies by name.
OR_AND_COUNTING = Semiring(
    name="plus_times",
    initialize=lambda: 0.0,
    combine=_or_and_combine,
    reduce=lambda acc, v: acc + v,
)

# The rings the CUDA kernels are instantiated on, in the order of the
# ring codes of csrc/ring.cuh.
DEVICE_RINGS = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND, OR_AND_COUNTING)


def device_ring_code(sr: Semiring) -> int:
    """The CUDA instantiation of a built-in ring, matched by identity.

    A user-defined ring raises NotImplementedError: its combine and
    reduce are Python callables, which cannot enter a CUDA kernel. It
    runs on a CPU tensor, where the plain versions take any ring."""
    for code, ring in enumerate(DEVICE_RINGS):
        if sr is ring:
            return code
    raise NotImplementedError(
        f"semiring {sr.name!r} is user-defined: its Python callables cannot "
        f"enter a CUDA kernel, and the kernels are instantiated only for the "
        f"built-in rings (csrc/ring.cuh). Run it on a CPU tensor; user-defined "
        f"rings on CUDA are ROADMAP queue 1 item 2")
