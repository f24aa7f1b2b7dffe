"""K15: GMRES's (m+1) x m Hessenberg least squares on the device.

The reference solves min ||H y - beta e1|| with `jnp.linalg.lstsq` (an
SVD in float32) inside its compiled restart cycle
(`spmv_tpu/solvers.py:gmres`, :227); there is no `pallas_call` behind it.
Here it is K15 (`hessenberg_lstsq`, csrc/krylov_kernels.cu): one warp
rotates away H's subdiagonal with Givens rotations in float64 and
back-substitutes, for any m, so that a GMRES cycle on the card is one
CUDA graph with no host read (solvers.py). A pivot |r_jj| <= (m + 1) * 2^-23 *
max |R| counts as zero: its y_j is 0 and its column is left out of the
back-substitution, which gives the reference's minimum-norm y when the
Krylov space closes early (H's later columns are then exactly 0).

`_hessenberg_lstsq_plain` is the same algorithm in torch float64, one
operation at a time in the kernel's order, so the two agree bit for
bit; it runs on a CPU tensor. On a CUDA tensor the wrapper launches K15
or raises. Where K15's work area (its pivots, g and R's triangle) does
not fit in shared memory, the wrapper hands it a float64 scratch tensor
from the stream's pool (`_k15_scratch`), so that K15 stays capturable in
the cycle's graph.

`_k15_chain_probe` runs K15's dependent chain alone (2m float64 steps in
one thread, from registers), the floor its design cannot beat;
`chip_smoke.py` times it beside K15.
"""

from __future__ import annotations

import math

import torch

from spmv_tpu_torch.kernels import _cuda

EPS32 = 2.0 ** -23  # float32's machine epsilon: the zero-pivot rule's


def _hessenberg_lstsq_plain(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: y (m,) in H's dtype minimising ||H y - beta
    e1|| for an upper Hessenberg H (m+1, m), in float64: Givens rotations
    column by column (applied to g = beta e1 as they go), the zero-pivot
    rule, back-substitution by columns. No operation reads the host."""
    f64 = torch.float64
    m = H.shape[1]
    R = H.to(f64, copy=True)
    g = torch.zeros(m + 1, dtype=f64, device=H.device)
    g[0] = beta
    diag = torch.empty(m, dtype=f64, device=H.device)
    for j in range(m):
        a, b = R[j, j], R[j + 1, j]
        r = torch.sqrt(a * a + b * b)
        nz = r != 0
        c = torch.where(nz, a / r, 1.0)
        s = torch.where(nz, b / r, 0.0)
        u, v = R[j, j + 1:].clone(), R[j + 1, j + 1:].clone()
        R[j, j + 1:] = c * u + s * v
        R[j + 1, j + 1:] = -s * u + c * v
        diag[j] = r
        u, v = g[j].clone(), g[j + 1].clone()
        g[j] = c * u + s * v
        g[j + 1] = -s * u + c * v
    mx = torch.maximum(diag.abs().amax(), torch.triu(R[:m], 1).abs().amax())
    tol = (m + 1) * EPS32 * mx
    y = torch.zeros(m, dtype=f64, device=H.device)
    for j in range(m - 1, -1, -1):
        zero = diag[j].abs() <= tol
        yj = torch.where(zero, 0.0, g[j] / diag[j])
        y[j] = yj
        g[:j] = torch.where(zero, g[:j], g[:j] - R[:j, j] * yj)
    return y.to(H.dtype)


def _k15_scratch(m: int) -> int:
    """Doubles of float64 scratch K15 takes at m, as its launcher rules
    (csrc/krylov_kernels.cu:spmv_k15_scratch_doubles): 0 where its work
    area is in shared memory, else the work area and the carried row."""
    return _cuda.lib().spmv_k15_scratch_doubles(m)


def hessenberg_lstsq(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """K15: y (m,) float32 minimising ||H y - beta e1|| for H (m+1, m)
    float32, upper Hessenberg, m >= 1, and beta a 0-d float32, both on one
    device. On a CPU tensor its plain version runs; on a CUDA tensor one
    launch."""
    if H.device.type == "cpu":
        return _hessenberg_lstsq_plain(H, beta)
    if H.device.type != "cuda":
        raise ValueError(f"hessenberg_lstsq: unsupported device {H.device}")
    if H.dim() != 2 or H.shape[1] < 1:
        raise ValueError(f"hessenberg_lstsq: H of shape {tuple(H.shape)}; K15 takes "
                         f"(m + 1, m) with m >= 1")
    m, dev = H.shape[1], H.device
    _cuda.expect(H, "H", torch.float32, (m + 1, m), dev)
    _cuda.expect(beta, "beta", torch.float32, (), dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    n = _k15_scratch(m)
    scratch = torch.empty(n, dtype=torch.float64, device=dev) if n else None
    rc = _cuda.lib().spmv_hessenberg_lstsq(
        _cuda.ptr(H), _cuda.ptr(beta), _cuda.ptr(y),
        None if scratch is None else _cuda.ptr(scratch), n, m, _cuda.stream(dev))
    _cuda.check(rc, "spmv_hessenberg_lstsq")
    hessenberg_lstsq.launches += 1
    return y


hessenberg_lstsq.launches = 0


# the probe's constants, handed to its launcher: a0, b, p, q, d, e, f
_K15_CHAIN = (1.0, 0.5, 1.5, 0.75, 2.0, 1.25, -2.0)


def _k15_chain_plain(m: int) -> tuple:
    """K15's chain in Python floats (IEEE doubles, each operation rounded
    once, as the probe's): m rotation steps a -> c p + s q, with r =
    sqrt(a a + b b), c = a / r, s = b / r, then m back-substitution steps
    g -> e - f (g / d) from g = a (g + e exactly: g counts the steps).
    Returns (a, g)."""
    a, b, p, q, d, e, f = _K15_CHAIN
    for _ in range(m):
        r = math.sqrt(a * a + b * b)
        a = (a / r) * p + (b / r) * q
    g = a
    for _ in range(m):
        g = e - f * (g / d)
    return a, g


def _k15_chain_probe(m: int, device) -> torch.Tensor:
    """K15's dependent chain of 2m float64 steps alone, in one thread on
    the card, from registers -> (a, g) float64, which must equal
    `_k15_chain_plain(m)` bit for bit. A measurement probe, off the
    solve's path (`chip_smoke.py` times it)."""
    out = torch.empty(2, dtype=torch.float64, device=device)
    rc = _cuda.lib().spmv_k15_chain_probe(_cuda.ptr(out), m, *_K15_CHAIN,
                                          _cuda.stream(out.device))
    _cuda.check(rc, "spmv_k15_chain_probe")
    return out
