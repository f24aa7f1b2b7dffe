"""The direct tier's seam: the port's ELL and paged-gather planners emit
the reference's plan arrays bit for bit (native planner on and off), and
the plain PyTorch versions of K9 (paged gather) and K11 (ELL group
reduce) match the reference's Pallas kernels in interpret mode.

K9 only moves values and K11's leaders are reduced in the reference's
order, so both must match bit for bit: K11's plain version on the leader
lanes, which are all that is read downstream (the wrapper returns only
them), and on every lane for `broadcast`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spmv_tpu import native as jnative
from spmv_tpu.io.generate import power_law_csr
from spmv_tpu.kernels import ell as jell
from spmv_tpu.kernels import light as jlight
from spmv_tpu.kernels import pgather as jpg
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import ell as tell
from spmv_tpu_torch.kernels import light as tlight
from spmv_tpu_torch.kernels import pgather as tpg
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)


def _port_csr(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


PG_INTS = ("n", "n_chunks", "rounds", "k_max", "n_w")
PG_ARRAYS = ("qlo", "qhi", "s1", "s2", "s3", "pages", "pcnt", "pmask")


def assert_same_pgather(pj, pt):
    assert (pj is None) == (pt is None)
    if pj is None:
        return
    for f in PG_INTS:
        assert getattr(pj, f) == getattr(pt, f), f
    for f in PG_ARRAYS:
        _eq(getattr(pj, f), getattr(pt, f), f"pgather.{f}")


def assert_same_ell(pj, pt):
    for f in ("width", "n_vrows", "n_tiles"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("aj", "ax", "valid", "vrow_row"):
        _eq(getattr(pj, f), getattr(pt, f), f)
    assert_same_pgather(pj.pgather, pt.pgather)


def _matrix():
    # power-law rows: long and empty rows, several 16K-column windows
    return power_law_csr(3000, 40000, 24000, seed=5)


def _no_native(monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not tnative.available() and not jnative.available()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("W", [1, 4, 32, 128])
def test_ell_plan_matches_reference(monkeypatch, native, W):
    if not native:
        _no_native(monkeypatch)
    A = _matrix()
    rows = np.arange(A.n_rows, dtype=np.int64)
    pj = jell.build_ell_plan(A, rows, W)
    pt = tell.build_ell_plan(_port_csr(A), rows, W)
    assert_same_ell(pj, pt)
    assert pt.pgather is not None and pt.pgather.rounds >= 1


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_light_bin_plans_match_reference(monkeypatch, native):
    if not native:
        _no_native(monkeypatch)
    A = _matrix()
    At = _port_csr(A)
    bj = jlight._bin_rows(A, jlight.FINE_BINS)
    bt = tlight._bin_rows(At, tlight.FINE_BINS)
    assert [w for w, _ in bj] == [w for w, _ in bt]
    for (w, rj), (_, rt) in zip(bj, bt):
        _eq(rj, rt, f"bin {w} rows")
        assert_same_ell(jell.build_ell_plan(A, rj, w), tell.build_ell_plan(At, rt, w))
    assert tlight._skew(At) == jlight._skew(A)
    assert tlight._kappa_for(At, tlight.FINE_KAPPA) == \
        jlight._kappa_for(A, jlight.FINE_KAPPA)


def test_ell_chunks_matches_reference_native():
    assert tnative.available() and jnative.available()
    A = _matrix()
    Ap = np.asarray(A.Ap, np.int64)
    rows = np.sort(np.random.default_rng(3).choice(A.n_rows, 900, replace=False))
    for W in (2, 16, 128):
        for a, b, name in zip(jnative.ell_chunks(rows, Ap, W, A.nnz),
                              tnative.ell_chunks(rows, Ap, W, A.nnz),
                              ("flat_k", "valid", "vrow_row")):
            _eq(a, b, f"W={W} {name}")


def _stream_idx(seed, n=32768, n_cols=40000, dead=0.05):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cols, n)
    idx[rng.random(n) < dead] = -1
    return idx, n_cols


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_paged_gather_plan_matches_reference(monkeypatch, native):
    if not native:
        _no_native(monkeypatch)
    idx, n_cols = _stream_idx(0)
    pj = jpg.build_paged_gather_plan(idx, n_cols)
    pt = tpg.build_paged_gather_plan(idx, n_cols)
    assert pt.rounds == 2 and pt.n_chunks == 2 and pt.n_w == 3
    assert_same_pgather(pj, pt)


def test_paged_gather_plan_refusals_match_reference():
    # past 4096 windows, no live slot, an empty stream
    for idx, n_cols in ((np.arange(10), 4097 * 16384), (np.full(40, -1), 100),
                        (np.zeros(0, np.int64), 100)):
        assert jpg.build_paged_gather_plan(idx, n_cols) is None
        assert tpg.build_paged_gather_plan(idx, n_cols) is None
    # every element on one sublane: 129+ rounds of spill, past R_MAX
    idx = np.arange(0, 128 * 600, 128)
    assert tpg.build_paged_gather_plan(idx, 128 * 600) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_k9_plain_matches_pallas(seed):
    idx, n_cols = _stream_idx(seed)
    x = np.random.default_rng(seed + 10).standard_normal(n_cols).astype(np.float32)
    pj = jpg.build_paged_gather_plan(idx, n_cols)
    want = np.asarray(jpg.paged_gather(jnp.asarray(x), pj))
    pt = tpg.build_paged_gather_plan(idx, n_cols).to("cpu")
    got = tpg.paged_gather(torch.from_numpy(x), pt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.where(idx >= 0, x[idx.clip(0)], 0))


RINGS = {"plus_times": (jsr.PLUS_TIMES, tsr.PLUS_TIMES),
         "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS),
         "max_times": (jsr.MAX_TIMES, tsr.MAX_TIMES)}


def _pallas_group_reduce(prod, sr, W, strategy):
    """The reference's K11 body through pl.pallas_call in interpret mode,
    as _ell_spmv_device (spmv_tpu/kernels/ell.py:204-215) runs it."""
    Tv = prod.shape[0]
    ident = float(sr.identity_for(np.float32))
    return np.asarray(pl.pallas_call(
        jell._group_reduce_kernel(sr, ident, W, strategy),
        grid=(Tv,),
        in_specs=[pl.BlockSpec((1, 8, 128), lambda t: (t, 0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((Tv, 8, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(prod)))


@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("W", [1, 2, 4, 32, 128])
@pytest.mark.parametrize("strategy", ["linear", "tree", "broadcast"])
def test_k11_plain_matches_pallas(strategy, W, ring):
    jring, tring = RINGS[ring]
    rng = np.random.default_rng(W)
    prod = rng.standard_normal((2, 8, 128)).astype(np.float32)
    if ring == "min_plus":
        prod[rng.random(prod.shape) < 0.1] = np.inf
    want = _pallas_group_reduce(prod, jring, W, strategy)
    got = tell._group_reduce_plain(torch.from_numpy(prod.reshape(-1, 128)), W=W,
                                   strategy=strategy, sr=tring).numpy().reshape(want.shape)
    lanes = slice(None) if strategy == "broadcast" else slice(None, None, W)
    np.testing.assert_array_equal(got[..., lanes], want[..., lanes])
    if strategy == "broadcast":  # every lane of a group holds its leader
        np.testing.assert_array_equal(got, np.repeat(got[..., ::W], W, axis=-1))


def test_k11_rejects_bad_arguments():
    prod = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="strategy"):
        tell._group_reduce_pass(prod, W=4, strategy="scan", sr=tsr.PLUS_TIMES)
    with pytest.raises(ValueError, match="power of two"):
        tell._group_reduce_pass(prod, W=3, strategy="tree", sr=tsr.PLUS_TIMES)


@pytest.mark.parametrize("ring", list(RINGS) + ["or_and"])
def test_ell_spmv_matches_reference(ring):
    """One ELL call end to end (K9 -> K11 -> segment reduce) against the
    reference's ell_spmv in interpret mode, on the plans checked above."""
    jring, tring = RINGS.get(ring, (jsr.OR_AND, tsr.OR_AND))
    A = _matrix()
    x = np.random.default_rng(4).standard_normal(A.n_cols).astype(np.float32)
    rows = np.arange(A.n_rows, dtype=np.int64)
    W = tell.select_width(A.nnz / A.n_rows)
    want = np.asarray(jell.ell_spmv(A, jnp.asarray(x), jring,
                                    jell.build_ell_plan(A, rows, W), "tree"))
    At = _port_csr(A)
    got = tell.ell_spmv(At, torch.from_numpy(x), tring,
                        tell.build_ell_plan(At, rows, W).to("cpu"), "tree").numpy()
    if ring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_select_width_matches_reference():
    for m in (0.5, 2, 3, 4.5, 8, 9, 16, 17, 52.9, 64, 65, 128, 129, 1e6):
        assert tell.select_width(m) == jell.select_width(m), m
