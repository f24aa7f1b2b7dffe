"""K11' as the card computes it, written here in NumPy, against its plain
version `_local_ell_plain` and against the reference's pieces of
`_local_ell_matvec` (the x gather, combine and mask, then the Pallas
`tree` group reduce in interpret mode).

K11' (csrc/dist_kernels.cu:local_ell_kernel) takes the launch's L*Tv*8
rows of 128 lanes one warp a row, each of the 32 threads 4 consecutive
lanes: v[i] = combine(ax, x[aj]) where valid, the ring's identity where
not. The `tree` steps d = W/2, ..., 4 are warp shuffles: thread k takes
reduce(v[i], v[i] of thread k + d/4) for each of its four values (a
thread past the warp's end reads its own value, which no leader uses).
The steps d = 2 and d = 1 run inside the thread: (v0 (+) v2) (+)
(v1 (+) v3). W = 1 writes the four values, W = 2 the pairs (v0 (+) v1,
v2 (+) v3), W >= 4 one leader from each group's first thread.

The model below takes the same steps, so the chunking, the shuffle
distances and the packing of the leaders are checked here on the CPU:
bit for bit (NaN as NaN), every W, every built-in ring, all-invalid
4-lane chunks and tiles, ±inf and NaN, 1 to 4 shards, one tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.parallel import dist_spmv as tds
from spmv_tpu_torch.parallel import partition as tpart

torch.set_num_threads(1)

WIDTHS = [1, 2, 4, 8, 16, 32, 64, 128]
RINGS = ("plus_times", "min_plus", "max_times", "or_and", "or_and_counting")
TORCH_RINGS = {**tsr.BUILTIN_SEMIRINGS, "or_and_counting": tsr.OR_AND_COUNTING}
SHAPES = [(1, 1), (2, 3), (4, 5)]  # (L, Tv)


def _or_and(a, x):
    return ((a != 0) & (x != 0)).astype(np.float32)


# ring -> (combine(a, x), reduce(earlier, later), identity), as ring.cuh
NP_RINGS = {
    "plus_times": (np.multiply, np.add, 0.0),
    "min_plus": (np.add, np.minimum, np.inf),
    "max_times": (np.multiply, np.maximum, 0.0),
    "or_and": (_or_and, np.maximum, 0.0),
    "or_and_counting": (_or_and, np.add, 0.0),
}


@np.errstate(invalid="ignore", over="ignore")
def k11p_model(aj, ax, valid, xsrc, W, ring):
    """K11' on (L, Tv, 8, 128) aj / ax / valid and (L, C) xsrc ->
    (L, Tv*8*128/W) leaders, in the kernel's steps."""
    combine, reduce, ident = NP_RINGS[ring]
    L = aj.shape[0]
    xg = np.take_along_axis(xsrc, aj.reshape(L, -1).astype(np.int64), 1).reshape(aj.shape)
    v = np.where(valid, combine(ax, xg), np.float32(ident)).astype(np.float32)
    v = v.reshape(L, -1, 32, 4)  # (shard, row, thread, value)
    d = W // 2
    while d >= 4:  # __shfl_down_sync by d/4 threads; past lane 31, the own value
        s = d // 4
        v = reduce(v, np.concatenate([v[:, :, s:], v[:, :, 32 - s:]], axis=2))
        d //= 2
    if W == 1:
        out = v
    elif W == 2:
        out = np.stack([reduce(v[..., 0], v[..., 1]), reduce(v[..., 2], v[..., 3])], -1)
    else:
        lead = reduce(reduce(v[..., 0], v[..., 2]), reduce(v[..., 1], v[..., 3]))
        out = lead[:, :, ::W // 4]  # each group's first thread
    return out.astype(np.float32).reshape(L, -1)


def made_block(L, Tv, ring, seed, C=257):
    """aj, ax, valid (L, Tv, 8, 128) and xsrc (L, C): ~20% of slots
    invalid, some 4-lane chunks and every fifth tile all invalid, ±inf
    and NaN in x (zeros too for the or-and rings)."""
    rng = np.random.default_rng(seed)
    shape = (L, Tv, 8, 128)
    aj = rng.integers(0, C, shape).astype(np.int32)
    ax = rng.standard_normal(shape).astype(np.float32)
    valid = rng.random(shape) < 0.8
    valid.reshape(L, Tv, 8, 32, 4)[rng.random((L, Tv, 8, 32)) < 0.1] = False
    valid[:, 2::5] = False
    xsrc = rng.standard_normal((L, C)).astype(np.float32)
    u = rng.random((L, C))
    xsrc[u < 0.02] = np.inf
    xsrc[(u >= 0.02) & (u < 0.04)] = -np.inf
    xsrc[(u >= 0.04) & (u < 0.05)] = np.nan
    if ring == "max_times":
        ax, xsrc = np.abs(ax), np.abs(xsrc)
    if ring.startswith("or_and"):
        ax[rng.random(shape) < 0.3] = 0.0
        xsrc[rng.random((L, C)) < 0.5] = 0.0
    return aj, ax, valid, xsrc


def _bits_equal_nan(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _plain(aj, ax, valid, xsrc, W, ring):
    t = [torch.from_numpy(a) for a in (aj, ax, valid, xsrc)]
    return tds._local_ell_plain(*t, W=W, sr=TORCH_RINGS[ring]).numpy()


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("W", WIDTHS)
def test_model_matches_plain_version_on_made_blocks(W, ring):
    ident = np.float32(NP_RINGS[ring][2])
    for i, (L, Tv) in enumerate(SHAPES):
        blk = made_block(L, Tv, ring, 10 * W + i)
        got = k11p_model(*blk, W, ring)
        assert got.shape == (L, Tv * 8 * 128 // W)
        _bits_equal_nan(got, _plain(*blk, W, ring))
        if Tv > 2:  # tile 2 is all invalid: every leader the identity
            assert (got.reshape(L, Tv, -1)[:, 2] == ident).all()


@pytest.mark.parametrize("ring", RINGS)
def test_all_invalid_chunks_give_the_identity(ring):
    """Every 4-lane chunk invalid but one lane a row: W = 4 leaders are
    the identity except that lane's group."""
    aj, ax, valid, xsrc = made_block(2, 2, ring, 3)
    valid[:] = False
    valid[..., 5] = True  # lane 5: group 1 of each row at W = 4
    xsrc[np.isnan(xsrc)] = 1.0
    got = k11p_model(aj, ax, valid, xsrc, 4, ring)
    _bits_equal_nan(got, _plain(aj, ax, valid, xsrc, 4, ring))
    lead = got.reshape(2, 2, 8, 32)
    ident = np.float32(NP_RINGS[ring][2])
    assert (np.delete(lead, 1, axis=3) == ident).all()


def _reference_pieces(aj, ax, valid, xsrc, W, ring):
    """The reference's _local_ell_matvec up to its leaders, per shard:
    jnp.take, the ring's combine, the identity where not valid, the
    Pallas `tree` group reduce (interpret mode), reduced[:, ::W]."""
    from jax.experimental import pallas as pl

    from spmv_tpu.kernels.ell import _group_reduce_kernel

    jring = jsr.BUILTIN_SEMIRINGS[ring]
    ident = float(jring.identity_for(np.float32))
    L, Tv = aj.shape[:2]
    kernel = _group_reduce_kernel(jring, ident, W, "tree")
    spec = pl.BlockSpec((1, 8, 128), lambda t: (t, 0, 0))
    outs = []
    for l in range(L):
        xg = jnp.take(jnp.asarray(xsrc[l]), jnp.asarray(aj[l]).reshape(-1)).reshape(aj[l].shape)
        prod = jnp.where(jnp.asarray(valid[l]), jring.combine(jnp.asarray(ax[l]), xg), ident)
        red = pl.pallas_call(kernel, grid=(Tv,), in_specs=[spec], out_specs=spec,
                             out_shape=jax.ShapeDtypeStruct((Tv, 8, 128), jnp.float32),
                             interpret=True)(prod)
        outs.append(np.asarray(red).reshape(Tv * 8, 128)[:, ::W].reshape(-1))
    return np.stack(outs)


@pytest.mark.parametrize("W,ring", [(W, "plus_times") for W in WIDTHS]
                         + [(8, r) for r in ("min_plus", "max_times", "or_and")])
def test_model_matches_the_reference_pieces(W, ring):
    blk = made_block(2, 3, ring, 7 * W)
    _bits_equal_nan(k11p_model(*blk, W, ring), _reference_pieces(*blk, W, ring))


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("block", ["self", "halo"])
def test_model_matches_plain_version_on_built_blocks(block, ring):
    """The stacked self and halo blocks of a 4-shard halo plan of a
    power-law matrix (its padding, its W) and the x tables the layer
    builds."""
    A = power_law_csr(3000, 3000, 24000, alpha=1.5, seed=2)
    plan = tpart.build_halo_plan(A, 4)
    rows, cols, vals = (getattr(plan, f"{k}_{block}") for k in ("rows", "cols", "vals"))
    b = tds._block_ell_plans(rows, cols, vals, plan.R, tds._block_width(rows, plan.R))
    C = plan.B if block == "self" else plan.n_shards * plan.M
    rng = np.random.default_rng(4)
    xsrc = rng.standard_normal((4, C)).astype(np.float32)
    ax = b["ax"]
    if ring == "max_times":
        ax, xsrc = np.abs(ax), np.abs(xsrc)
    if ring.startswith("or_and"):
        xsrc[rng.random(xsrc.shape) < 0.5] = 0.0
    args = (b["aj"], ax, b["valid"], xsrc)
    _bits_equal_nan(k11p_model(*args, b["W"], ring), _plain(*args, b["W"], ring))
