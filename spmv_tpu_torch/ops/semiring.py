"""Semiring abstraction for generalized SpMV.

Counterpart of `spmv_tpu/ops/semiring.py`. A semiring provides

    initialize() -> identity of `reduce`
    combine(a_ij, x_j) -> product term
    reduce(acc, v) -> accumulation

as callables on torch tensors (elementwise, broadcasting). `reduce`
must be associative. The CUDA kernels of the stream path carry
plus-times (and or-and as a counting ring); other rings raise
`NotImplementedError` there until their kernels are ported.
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
