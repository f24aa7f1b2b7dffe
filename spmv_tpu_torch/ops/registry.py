"""String-dispatched SpMV kernel registry.

Counterpart of `spmv_tpu/ops/registry.py`: a string kind maps to a
kernel entry; unknown kinds raise with the list of valid kinds.

Kernel entry contract::

    @register("mykind", supports_semiring=True)
    def mykind(A: CSR, x: torch.Tensor, *, semiring: Semiring) -> torch.Tensor:
        ...

`x` is a tensor; the kernel runs on `x.device` and returns y there.
Host-side plans are cached per matrix with `plan_cache`, so repeated
calls only launch.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.ops.semiring import Semiring, PLUS_TIMES


class PlanCapacityError(ValueError):
    """A kernel's plan-time layout cannot reach this matrix (size or
    geometry); callers may fall back to another kind. Distinct from
    user errors (bad shapes/dtypes), which raise plain ValueError."""


class FallbackWarning(UserWarning):
    """A planned fast path could not serve this matrix and a slower
    kernel ran instead (silenceable through the warnings module)."""


def resolve_val_dtype(A: CSR, x) -> np.dtype:
    """Compute dtype of the product stream: result_type(Ax, x).

    float64 raises: the reference computes in float64 only when JAX's
    x64 mode is switched on and raises otherwise, and the port has no
    such switch and no float64 kernels, so it keeps the reference's
    default behaviour. Cast A and x to float32."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise NotImplementedError(
                "bfloat16 SpMV is not ported yet: it needs the generic-ring "
                "TPU kernels K7/K8 (ROADMAP queue 1 item 5)")
        x_dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
    else:
        x_dtype = np.asarray(x).dtype
    val = np.promote_types(np.asarray(A.Ax).dtype, x_dtype)
    if val == np.float64:
        raise ValueError(
            "float64 SpMV is not supported by spmv_tpu_torch (the "
            "reference raises for it too unless JAX's x64 mode is on); "
            "cast A and x to float32")
    return np.dtype(val)


@dataclasses.dataclass
class KernelEntry:
    name: str
    fn: Callable
    supports_semiring: bool
    doc: str
    reference_analog: str = ""


_REGISTRY: Dict[str, KernelEntry] = {}
_ALIASES: Dict[str, str] = {}


def register(
    name: str,
    *,
    supports_semiring: bool = False,
    reference_analog: str = "",
    aliases: tuple = (),
):
    """Register an SpMV kernel under a string kind."""

    def deco(fn):
        _REGISTRY[name] = KernelEntry(
            name=name,
            fn=fn,
            supports_semiring=supports_semiring,
            doc=(fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else "",
            reference_analog=reference_analog,
        )
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def get_kernel(kind: str) -> KernelEntry:
    kind = _ALIASES.get(kind, kind)
    if kind not in _REGISTRY:
        raise KeyError(
            f"unknown SpMV kind {kind!r}; valid kinds: {sorted(_REGISTRY)}"
            f" (aliases: {sorted(_ALIASES)})")
    return _REGISTRY[kind]


def list_kinds(include_aliases: bool = False):
    kinds = sorted(_REGISTRY)
    if include_aliases:
        kinds += sorted(_ALIASES)
    return kinds


# Per-matrix plan caches, keyed by (CSR identity, plan key).
_PLAN_CACHES: "weakref.WeakKeyDictionary[CSR, dict]" = weakref.WeakKeyDictionary()


def plan_cache(A: CSR, key, builder: Callable[[], object]):
    """Fetch-or-build a cached plan for matrix A."""
    cache = _PLAN_CACHES.get(A)
    if cache is None:
        cache = {}
        _PLAN_CACHES[A] = cache
    if key not in cache:
        cache[key] = builder()
    return cache[key]


def spmv(
    kind: str,
    A: CSR,
    x,
    semiring: Optional[Semiring] = None,
    y_dtype=None,
) -> torch.Tensor:
    """Uniform dispatch: y = A (x) x with the named kernel, on x.device.

    `x` is a tensor (a NumPy array is taken as a CPU tensor).
    `semiring=None` means the plain (+, x) ring; passing a semiring to a
    kernel that does not support one raises. `y_dtype` (a torch dtype)
    selects the output dtype independently of the compute dtype.
    """
    entry = get_kernel(kind)
    sr = semiring if semiring is not None else PLUS_TIMES
    if semiring is not None and sr is not PLUS_TIMES and not entry.supports_semiring:
        raise ValueError(
            f"kind {entry.name!r} does not support semirings; "
            f"semiring-capable kinds: "
            f"{[k for k, e in _REGISTRY.items() if e.supports_semiring]}")
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({A.n_cols},)")
    y = entry.fn(A, x, semiring=sr)
    if y_dtype is not None and y.dtype != y_dtype:
        y = y.to(y_dtype)
    return y


def SpMV(kind, n_rows, n_cols, nnz, Ap, Aj, Ax, x, semiring=None, y_dtype=None):
    """Reference-signature shim: SpMV(kind, n_rows, n_cols, nnz, Ap, Aj,
    Ax, x) -> y. `spmv(kind, A, x)` is the idiomatic path: it caches
    plans per matrix object, which this shim builds anew each call."""
    Ap = np.asarray(Ap)
    Aj = np.asarray(Aj)
    Ax = np.asarray(Ax)
    if Ap.shape != (int(n_rows) + 1,):
        raise ValueError("Ap must have shape (n_rows+1,)")
    if Aj.shape != (int(nnz),) or Ax.shape != (int(nnz),):
        raise ValueError("Aj/Ax must have shape (nnz,)")
    A = CSR(int(n_rows), int(n_cols), Ap, Aj, Ax)
    return spmv(kind, A, x, semiring=semiring, y_dtype=y_dtype)
