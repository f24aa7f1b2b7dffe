"""`merge_tiled` and K10 of the port on the CPU, against spmv_tpu.

- `build_merge_plan` emits the reference's plan arrays bit for bit,
  native planner on and off, under both policies, on a power-law matrix,
  one with empty rows and one whose single hub row spans every tile.
- K10's plain version matches the reference's Pallas kernel
  (`_merge_group_kernel`, built here as `_merge_spmv_device` builds it,
  merge.py:465-488, in interpret mode) on the same products: exactly in
  min-plus, max-times and or-and and on integer-valued plus-times data
  (every partial sum exact in float32); within rtol 2e-4 / atol 1e-5 on
  normal plus-times data, whose scan associates in another order (the
  reference scans lanes, then carries across sublanes).
- `merge_tiled` end to end in four rings against
  `spmv_tpu.spmv("merge_tiled", ...)` and the oracles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu import native as jnative
from spmv_tpu.formats import COO as JCOO
from spmv_tpu.formats import CSR as JCSR
from spmv_tpu.formats import coo_to_csr as jcoo_to_csr
from spmv_tpu.io.generate import power_law_csr
from spmv_tpu.kernels import merge as jmerge
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import merge as tmerge
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.ops.registry import plan_cache
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
RINGS = {"plus_times": (jsr.PLUS_TIMES, tsr.PLUS_TIMES),
         "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS),
         "max_times": (jsr.MAX_TIMES, tsr.MAX_TIMES),
         "or_and": (jsr.OR_AND, tsr.OR_AND)}
POLICIES = {"tuned": (jmerge.TUNED_POLICY, tmerge.TUNED_POLICY),
            "stock": (jmerge.STOCK_POLICY, tmerge.STOCK_POLICY)}


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _empty_rows():
    # nonzeros only in rows 0..999 of 3000: the owner map's identity slot
    rng = np.random.default_rng(7)
    return jcoo_to_csr(JCOO(3000, 2500, rng.integers(0, 1000, 15000).astype(np.int32),
                            rng.integers(0, 2500, 15000).astype(np.int32),
                            rng.standard_normal(15000).astype(np.float32)))


def _hub():
    # one row of 9000 nonzeros, between two short rows: every tile of the
    # hub is one row continuing the carry
    rng = np.random.default_rng(8)
    lens = np.zeros(600, np.int64)
    lens[[10, 11, 12]] = (5, 9000, 3)
    Ap = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nnz = int(Ap[-1])
    return JCSR(600, 4000, Ap, rng.integers(0, 4000, nnz).astype(np.int32),
                rng.standard_normal(nnz).astype(np.float32))


MATRICES = {"power_law": lambda: power_law_csr(3000, 3000, 20000, seed=1),
            "empty_rows": _empty_rows, "hub": _hub}
PLAN_FIELDS = ("aj_tiles", "ax_tiles", "rel_tiles", "r_start", "lrow", "cnt",
               "owner_idx", "pr1", "pr2", "pr3", "owner_valid")
PG_FIELDS = ("n", "n_chunks", "rounds", "k_max", "n_w", "qlo", "qhi", "s1", "s2",
             "s3", "pages", "pcnt", "pmask")


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _no_native(monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not tnative.available() and not jnative.available()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_merge_plan_matches_reference(monkeypatch, matrix, policy, native):
    if not native:
        _no_native(monkeypatch)
    A = MATRICES[matrix]()
    pol_j, pol_t = POLICIES[policy]
    pj, pt = jmerge.build_merge_plan(A, pol_j), tmerge.build_merge_plan(_port(A), pol_t)
    assert pj.n_tiles == pt.n_tiles and pt.policy == pol_t
    for f in PLAN_FIELDS:
        _eq(getattr(pj, f), getattr(pt, f), f)
    for name in ("pgather", "pgather_y"):
        gj, gt = getattr(pj, name), getattr(pt, name)
        assert gt is not None and gj is not None
        for f in PG_FIELDS:
            _eq(getattr(gj, f), getattr(gt, f), f"{name}.{f}")


def test_merge_plan_of_an_empty_matrix_matches_reference():
    A = JCSR(5, 4, np.zeros(6, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))
    pj = jmerge.build_merge_plan(A, jmerge.TUNED_POLICY)
    pt = tmerge.build_merge_plan(_port(A), tmerge.TUNED_POLICY)
    assert pj.n_tiles == pt.n_tiles == 0
    for f in ("aj_tiles", "ax_tiles", "rel_tiles", "r_start", "lrow", "cnt", "owner_idx"):
        _eq(getattr(pj, f), getattr(pt, f), f)
    assert pt.pgather is None and pt.pr1 is None and pt.owner_valid is None


def _products(plan, ring, data, seed=0):
    """(T*S, 128) products for K10, the identity beyond each tile's count,
    as phase A leaves them."""
    T, EN = plan.aj_tiles.shape
    rng = np.random.default_rng(seed)
    if data == "int":
        prod = rng.integers(-4, 5, (T, EN)).astype(np.float32)
    elif ring == "or_and":
        prod = (rng.random((T, EN)) < 0.3).astype(np.float32)
    else:
        prod = rng.standard_normal((T, EN)).astype(np.float32)
        if ring == "min_plus":
            prod[rng.random(prod.shape) < 0.2] = np.inf
        if ring == "max_times":
            # max-times is a semiring on the non-negatives, where its
            # identity 0 is one: the reference's scan folds the identity
            # into each sublane's first run, which moves a negative value
            prod = np.abs(prod)
    ident = float(RINGS[ring][0].identity_for(np.float32))
    prod[np.arange(EN)[None, :] >= np.asarray(plan.cnt)[:, None]] = ident
    return prod.reshape(-1, 128)


def _pallas_k10(pj, prod, sr, policy):
    """The reference's K10 through pl.pallas_call in interpret mode, as
    _merge_spmv_device (spmv_tpu/kernels/merge.py:465-488) runs it."""
    S, P = policy.nnz_per_tile // 128, policy.rows_per_tile // 128
    sbt, T = 128 // S, pj.n_tiles
    ident = float(sr.identity_for(np.float32))
    blk = pl.BlockSpec((128, 128), lambda g, *_: (g, 0))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(T // sbt,), in_specs=[blk] * 5,
        out_specs=pl.BlockSpec((sbt * P, 128), lambda g, *_: (g, 0)),
        scratch_shapes=[pltpu.SMEM((1,), jnp.int32), pltpu.SMEM((1,), jnp.float32)])
    return np.asarray(pl.pallas_call(
        jmerge._merge_group_kernel(sr, ident, S, P, sbt, P * 128),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T * P, 128), jnp.float32),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("arbitrary",)),
        interpret=True,
    )(pj.r_start, pj.lrow, pj.cnt, jnp.asarray(prod), pj.rel_tiles.reshape(-1, 128),
      pj.pr1, pj.pr2, pj.pr3))


K10_CASES = ([("power_law", p, r, "normal") for p in POLICIES for r in RINGS]
             + [("power_law", p, "plus_times", "int") for p in POLICIES]
             + [("hub", p, r, d) for p in POLICIES
                for r, d in (("plus_times", "int"), ("min_plus", "normal"))])


@pytest.mark.parametrize("matrix,policy,ring,data", K10_CASES)
def test_k10_plain_matches_pallas(matrix, policy, ring, data):
    A = MATRICES[matrix]()
    pol_j, pol_t = POLICIES[policy]
    jring, tring = RINGS[ring]
    pj = jmerge.build_merge_plan(A, pol_j)
    pt = tmerge.build_merge_plan(_port(A), pol_t).to("cpu")
    sbt = 128 // (pol_t.nnz_per_tile // 128)
    # the stock policy has no spare route row: the masked-reduction branch
    assert (sbt * 8 + sbt <= 128) == (policy == "tuned")
    prod = _products(pj, ring, data)
    want = _pallas_k10(pj, prod, jring, pol_j)
    got = tmerge._merge_group_pass(
        torch.from_numpy(prod), pt.rel_tiles.view(-1, 128), pt.pr1, pt.pr2, pt.pr3,
        pt.r_start, pt.lrow, pt.cnt, sr=tring, S=pol_t.nnz_per_tile // 128,
        P=pol_t.rows_per_tile // 128).numpy()
    if ring == "plus_times" and data == "normal":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_hub_carry_chain_runs_across_every_tile():
    pt = tmerge.build_merge_plan(_port(_hub()), tmerge.TUNED_POLICY)
    cnt, rs, lr = pt.cnt, pt.r_start, pt.lrow
    hub = (rs == 11) & (lr == 11)
    assert hub.sum() >= 3 and cnt[hub].min() > 0


@pytest.mark.parametrize("ring", list(RINGS))
def test_merge_tiled_matches_reference(ring):
    jring, tring = RINGS[ring]
    A = power_law_csr(3000, 3000, 20000, seed=1)
    x = np.random.default_rng(1).standard_normal(A.n_cols).astype(np.float32)
    if ring == "or_and":
        x[np.random.default_rng(2).random(A.n_cols) < 0.7] = 0
    y = spmv_tpu_torch.spmv("merge_tiled", _port(A), x, semiring=tring).numpy()
    yj = np.asarray(spmv_tpu.spmv("merge_tiled", A, x, semiring=jring))
    if ring == "plus_times":
        np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref(_port(A), x, y_dtype=np.float64),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(y, yj, rtol=2 * RTOL, atol=2 * ATOL)
    else:
        np.testing.assert_array_equal(y, spmv_tpu_torch.spmv_ref_semiring(_port(A), x, tring))
        np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("matrix", ["empty_rows", "hub"])
@pytest.mark.parametrize("ring", list(RINGS))
def test_merge_tiled_edge_matrices_match_oracle(matrix, ring):
    _, tring = RINGS[ring]
    A = _port(MATRICES[matrix]())
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    y = spmv_tpu_torch.spmv("merge_tiled", A, x, semiring=tring).numpy()
    if ring == "plus_times":
        np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(y, spmv_tpu_torch.spmv_ref_semiring(A, x, tring))


def test_merge_tiled_without_paged_gathers_matches_oracle():
    """The glue phase A (x[aj]) and phase C (take by owner_idx) where a
    plan has no paged-gather plan."""
    A = _port(power_law_csr(3000, 3000, 20000, seed=1))
    x = np.random.default_rng(4).standard_normal(A.n_cols).astype(np.float32)
    plan = tmerge.build_merge_plan(A, tmerge.TUNED_POLICY)
    bare = dataclasses.replace(plan, pgather=None, pgather_y=None)
    plan_cache(A, ("merge", tmerge.TUNED_POLICY), lambda: bare)
    y = spmv_tpu_torch.spmv("merge_tiled", A, x).numpy()
    np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64),
                               rtol=RTOL, atol=ATOL)
    ym = spmv_tpu_torch.spmv("merge_tiled", A, x, semiring=tsr.MIN_PLUS).numpy()
    np.testing.assert_array_equal(ym, spmv_tpu_torch.spmv_ref_semiring(A, x, tsr.MIN_PLUS))


def test_merge_tiled_empty_and_no_columns():
    for A in (CSR(6, 5, np.zeros(7, np.int32), np.zeros(0, np.int32),
                  np.zeros(0, np.float32)),
              CSR(3, 0, np.zeros(4, np.int32), np.zeros(0, np.int32),
                  np.zeros(0, np.float32))):
        x = np.ones(A.n_cols, np.float32)
        np.testing.assert_array_equal(spmv_tpu_torch.spmv("merge_tiled", A, x).numpy(),
                                      np.zeros(A.n_rows, np.float32))
        np.testing.assert_array_equal(
            spmv_tpu_torch.spmv("merge_tiled", A, x, semiring=tsr.MIN_PLUS).numpy(),
            np.full(A.n_rows, np.inf, np.float32))


def test_k10_rejects_shapes_it_cannot_group():
    z = torch.zeros(128, 128)
    i = torch.zeros(128, 128, dtype=torch.int32)
    u = torch.zeros(128, 128, dtype=torch.uint8)
    t = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        tmerge._merge_group_pass(z, i, u, u, u, t, t, t, sr=tsr.PLUS_TIMES, S=3, P=8)
    with pytest.raises(ValueError, match="exceed"):
        tmerge._merge_group_pass(z, i, u, u, u, t, t, t, sr=tsr.PLUS_TIMES, S=8, P=16)
    with pytest.raises(ValueError, match="whole groups"):
        tmerge._merge_group_pass(z, i, u, u, u, t[:12], t[:12], t[:12],
                                 sr=tsr.PLUS_TIMES, S=16, P=8)
    with pytest.raises(ValueError, match="multiples"):
        tmerge.MergePolicy(nnz_per_tile=1000)


# ---------------------------------------------------------------------------
# The carry chain as two scans: K10's second launch runs on the card the
# formulation below, written here in NumPy with Hillis-Steele doubling;
# it must give the sequential walk of the plain version (`_carry_walk`)
# its fold positions and carries, and so the same y windows.
# ---------------------------------------------------------------------------

NP_REDUCE = {"plus_times": np.add, "min_plus": np.minimum, "max_times": np.maximum,
             "or_and": np.maximum}


def _chain(kind, seed):
    """(r_start, lrow, cnt) of a tile chain in row order. `hub`: one row
    across 4200 tiles, past one 4096-tile chunk of the card's scan;
    `empty_inside`: empty tiles inside runs, some on the carry's row (so
    they fold), some on no row; `fresh_rows`: many one-row tiles that
    start a new row and do not continue the carry; `mixed`: all of it."""
    rng = np.random.default_rng(seed)
    rs, lr, cn = [], [], []
    last = 0  # lrow of the last non-empty tile

    def tile(r0, r1, c):
        rs.append(r0), lr.append(r1), cn.append(c)

    def fresh(one_row):
        nonlocal last
        r0 = last + int(rng.integers(1, 3))
        last = r0 if one_row else r0 + int(rng.integers(1, 5))
        tile(r0, last, int(rng.integers(1, 9)))

    def cont(one_row):
        nonlocal last
        r0 = last
        last = r0 if one_row else r0 + int(rng.integers(1, 5))
        tile(r0, last, int(rng.integers(1, 9)))

    def empty():
        r0 = (last, -2, last + 1)[int(rng.integers(0, 3))]
        tile(r0, r0, 0)

    fresh(False)
    if kind == "hub":
        for _ in range(4200):
            cont(True)
        cont(False)
    for _ in range(600):
        u = rng.random()
        if kind == "fresh_rows":
            fresh(u < 0.7) if u < 0.85 else cont(u < 0.95)
        elif kind == "empty_inside":
            empty() if u < 0.3 else cont(True) if u < 0.8 else fresh(False)
        else:
            (empty if u < 0.15 else (lambda: cont(True)) if u < 0.5
             else (lambda: cont(False)) if u < 0.7 else (lambda: fresh(u < 0.85)))()
    for _ in range(3):  # pad tiles, as the planner leaves them at the end
        tile(-2, -2, 0)
    return (np.asarray(a, np.int32) for a in (rs, lr, cn))


def _raw(ring, T, seed):
    rng = np.random.default_rng(seed)
    if ring == "plus_times":  # integer-valued: every partial sum exact
        return rng.integers(-4, 5, T).astype(np.float32)
    if ring == "or_and":
        return (rng.random(T) < 0.5).astype(np.float32)
    raw = rng.standard_normal(T).astype(np.float32)
    if ring == "max_times":
        raw = np.abs(raw)
    if ring == "min_plus":
        raw[rng.random(T) < 0.2] = np.inf
    return raw


def _carry_scan(r_start, lrow, cnt, raw, reduce, ident):
    """The parallel formulation: -> (fold flags, carry into each tile)."""
    T = cnt.size
    nonempty = cnt > 0
    # the last non-empty tile before each tile: a max-scan of indices
    last = np.maximum.accumulate(np.where(nonempty, np.arange(T), -1))
    prev = np.concatenate([[-1], last[:-1]])
    carry_row = np.where(prev >= 0, lrow[np.maximum(prev, 0)], -1)
    fold = carry_row == r_start
    # a non-empty tile heads a new run unless it is one row continuing
    # the carry
    head = ~(fold & (lrow == r_start))
    # exclusive segmented scan of raw over the non-empty tiles, seeded
    # with the identity; empty tiles pass the carry on. Element 0 is the
    # seed, element t + 1 tile t.
    v = np.concatenate([[ident], raw]).astype(np.float32)
    f = np.concatenate([[True], head])
    e = np.concatenate([[False], ~nonempty])
    d = 1
    while d <= T:
        ev, ef, ee, lv, lf, le = v[:-d], f[:-d], e[:-d], v[d:], f[d:], e[d:]
        joined = np.where(lf, lv, reduce(ev, lv))
        nv = np.where(le, ev, np.where(ee, lv, joined))
        nf = np.where(le, ef, np.where(ee, lf, lf | ef))
        v, f, e = (np.concatenate([a[:d], b]) for a, b in ((v, nv), (f, nf), (e, le & ee)))
        d *= 2
    return fold, v[:-1]


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("kind", ["hub", "empty_inside", "fresh_rows", "mixed"])
def test_carry_scan_matches_the_walk(kind, ring):
    tring = RINGS[ring][1]
    r_start, lrow, cnt = _chain(kind, seed=len(kind))
    T = cnt.size
    raw = _raw(ring, T, seed=T)
    ident = np.float32(tring.identity_for(np.float32))
    fold, carry_in = _carry_scan(r_start, lrow, cnt, raw, NP_REDUCE[ring], ident)
    fold_t, fold_v = tmerge._carry_walk(torch.from_numpy(r_start), torch.from_numpy(lrow),
                                        torch.from_numpy(cnt), torch.from_numpy(raw), sr=tring)
    np.testing.assert_array_equal(np.flatnonzero(fold), fold_t)
    np.testing.assert_array_equal(carry_in[fold], torch.stack(fold_v).numpy())
    if kind == "hub":
        assert ((r_start == lrow) & fold).sum() > 4096  # one run across chunks
    if kind == "empty_inside":
        assert (fold & (cnt == 0)).any()  # an empty tile on the carry's row folds
    if kind == "fresh_rows":
        assert ((r_start == lrow) & (cnt > 0) & ~fold).sum() > 100
    # the y windows the two fold into
    y0 = _raw(ring, T * 4, seed=1).reshape(T, 4)
    y_walk, y_scan = y0.copy(), y0.copy()
    y_walk[fold_t, 0] = tring.reduce(torch.stack(fold_v), torch.from_numpy(y0[fold_t, 0])).numpy()
    y_scan[fold, 0] = NP_REDUCE[ring](carry_in[fold], y0[fold, 0])
    np.testing.assert_array_equal(y_scan, y_walk)
