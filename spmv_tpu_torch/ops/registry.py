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

from spmv_tpu_torch.formats import CSR, as_values, host_values, is_bfloat16, value_dtype
from spmv_tpu_torch.ops.semiring import Semiring, PLUS_TIMES


class PlanCapacityError(ValueError):
    """A kernel's plan-time layout cannot reach this matrix (size or
    geometry); callers may fall back to another kind. Distinct from
    user errors (bad shapes/dtypes), which raise plain ValueError."""


class FallbackWarning(UserWarning):
    """A planned fast path could not serve this matrix and a slower
    kernel ran instead (silenceable through the warnings module)."""


def warn_fallback(kind: str, to: str, err: Exception) -> None:
    """Emit a FallbackWarning: `kind`'s planned path could not serve the
    matrix (`err`) and the direct `to` kernels run instead."""
    import warnings

    warnings.warn(
        f"spmv kind {kind!r}: planned fast path unavailable "
        f"({err}); falling back to the direct {to} kernel "
        f"(typically 10-100x slower)", FallbackWarning, stacklevel=3)


# jnp.asarray with JAX's x64 mode off (the reference's default) narrows
# these to 32 bits; the port's entry points do the same (as_input)
_NARROW_NP = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}
_NARROW_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _NARROW_TORCH[torch.uint64] = torch.uint32


def as_input(v, device=None) -> torch.Tensor:
    """A caller's vector or matrix as the reference's `jnp.asarray` leaves
    it with x64 off: float64 -> float32, int64 -> int32, uint64 -> uint32,
    complex128 -> complex64, other dtypes as they are. A NumPy array (or
    anything np.asarray takes; an ml_dtypes bfloat16 array as bfloat16)
    becomes a CPU tensor; a tensor keeps its device; `device`, where
    given, moves the result there."""
    if isinstance(v, torch.Tensor):
        narrow = _NARROW_TORCH.get(v.dtype)
        if narrow is not None:
            v = v.to(narrow)
    elif is_bfloat16(v):
        v = as_values(host_values(v), torch.bfloat16)
    else:
        a = np.asarray(v)
        narrow = _NARROW_NP.get(a.dtype)
        v = torch.from_numpy(np.ascontiguousarray(a if narrow is None else a.astype(narrow)))
    return v if device is None else v.to(device)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, a NumPy dtype (ml_dtypes' bfloat16 too) or a dtype's
    name -> the torch dtype (np.float32, "float16" and torch.float16
    alike; "bfloat16" and torch.bfloat16 alike)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16" or is_bfloat16(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The compute dtype of values of dtypes a and b, as the reference
    promotes them: NumPy's table (int32 with float32 gives float64), and
    for the pairs with bfloat16, which NumPy cannot express, JAX's:
    bfloat16 with itself, any integer or bool gives bfloat16, with
    float16 or float32 float32, with float64 float64."""
    if torch.bfloat16 in (a, b):
        o = b if a == torch.bfloat16 else a
        if o == torch.bfloat16 or not o.is_floating_point:
            return torch.bfloat16
        return torch.float64 if o == torch.float64 else torch.float32
    np_a, np_b = (torch.empty(0, dtype=d).numpy().dtype for d in (a, b))
    return torch_dtype(np.promote_types(np_a, np_b))


def resolve_val_dtype(A: CSR, x) -> torch.dtype:
    """Compute dtype of the product stream: result_type(Ax, x), promoted
    as the reference promotes (`promote`).

    bfloat16 with float16 raises TypeError, as NumPy's promotion does in
    the reference. float64 raises, as in the reference with JAX's x64
    mode off (its default): a float64 Ax, or an integer x against float
    values (NumPy promotes int32 with float32 to float64). A float64 x does not get
    here: the entry points cast it to float32 first (`as_input`), as the
    reference's `jnp.asarray` does."""
    x_dtype = x.dtype if isinstance(x, torch.Tensor) else value_dtype(x)
    a_dtype = value_dtype(A.Ax)
    if {a_dtype, x_dtype} == {torch.bfloat16, torch.float16}:
        # the reference takes np.promote_types, which has no common dtype
        # for ml_dtypes' bfloat16 and float16
        raise TypeError(f"{a_dtype} values with {x_dtype} x have no common "
                        f"dtype (the reference's NumPy promotion raises); cast "
                        f"one of them")
    val = promote(a_dtype, x_dtype)
    if val == torch.float64:
        raise ValueError(
            f"float64 SpMV requested ({a_dtype} values, {x_dtype} x): the "
            f"reference computes in float64 only with JAX's x64 mode on, and "
            f"the port has no float64 kernels; cast A and x to float32")
    return val


def float_val_dtype(A: CSR, x, kind: str) -> torch.dtype:
    """resolve_val_dtype for the direct kinds' product streams, which hold
    floating values only: an integer compute dtype raises, as the
    reference's Pallas kernels refuse it."""
    val = resolve_val_dtype(A, x)
    if not val.is_floating_point:
        raise NotImplementedError(
            f"{kind}: {str(val).replace('torch.', '')} values are not supported: its kernels take "
            f"floating values only")
    return val


@dataclasses.dataclass
class KernelEntry:
    name: str
    fn: Callable
    supports_semiring: bool
    doc: str
    reference_analog: str = ""


_REGISTRY: Dict[str, KernelEntry] = {}
_ALIASES: Dict[str, str] = {}

# Kinds that compute on the host whatever x's device is: a CUDA graph
# cannot capture them, so the solvers run their chunks eagerly and the
# bench harness times them by back-to-back calls
HOST_KINDS = frozenset({"cpu_naive"})
# Kinds whose plus-times row fold adds in float64 by index_add_
# (ops/semiring.py:segment_reduce_sorted), in an order the card's atomics
# change from call to call: two calls (or a call and a graph's replay)
# agree within one float32 ulp per row, not bit for bit
ATOMIC_FOLD_KINDS = frozenset({"xla", "csr_scalar", "csr_vector_ell", "light_vec_ell"})


def is_host_kind(kind: str) -> bool:
    """True iff `kind` (or the kind it aliases) is in HOST_KINDS."""
    return get_kernel(kind).name in HOST_KINDS


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


def plan_cached(A: CSR, key) -> bool:
    """True iff a plan for (A, key) is already in the in-memory cache
    (no build is triggered), so that a dispatch rule can prefer a
    planned path only when its O(nnz) plan already exists."""
    cache = _PLAN_CACHES.get(A)
    return cache is not None and key in cache


def spmv(
    kind: str,
    A: CSR,
    x,
    semiring: Optional[Semiring] = None,
    y_dtype=None,
) -> torch.Tensor:
    """Uniform dispatch: y = A (x) x with the named kernel, on x.device.

    `x` is a tensor (a NumPy array is taken as a CPU tensor), narrowed as
    the reference's `jnp.asarray` narrows it (`as_input`: a float64 x
    computes in float32). `semiring=None` means the plain (+, x) ring;
    passing a semiring to a kernel that does not support one raises.
    `y_dtype` (a torch dtype, a NumPy dtype or a dtype's name) selects the
    output dtype independently of the compute dtype.
    """
    entry = get_kernel(kind)
    sr = semiring if semiring is not None else PLUS_TIMES
    if semiring is not None and sr is not PLUS_TIMES and not entry.supports_semiring:
        raise ValueError(
            f"kind {entry.name!r} does not support semirings; "
            f"semiring-capable kinds: "
            f"{[k for k, e in _REGISTRY.items() if e.supports_semiring]}")
    x = as_input(x)
    if tuple(x.shape) != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({A.n_cols},)")
    y = entry.fn(A, x, semiring=sr)
    if y_dtype is not None and y.dtype != torch_dtype(y_dtype):
        y = y.to(torch_dtype(y_dtype))
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
