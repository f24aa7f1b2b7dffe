"""The csr-vector, LightSpMV, DIA and baseline kinds of the port against
the reference's kinds (run in interpret mode) and the NumPy oracle, in
every built-in ring; their edge cases; the identity fold; the DIA
routing of the csr-vector kinds; and the fallback past the stream
planner's reach.

Plus-times is held to rtol 2e-4 / atol 1e-5 (sums run in another
order); min-plus, max-times and or-and bit for bit."""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import banded_csr, power_law_csr
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5

NEW_KINDS = ("cpu_naive", "csr_scalar", "csr_vector", "csr_vector_ell",
             "csr_vector_shfl", "csr_vector_shfl2", "csr_vector_shfl2_ell",
             "csr_vector_shfl_ell", "dense", "dia", "light_vec",
             "light_vec_ell", "light_warp", "light_warp_ell", "xla")
ALIASES = {"cusp": "csr_vector", "cusp1": "csr_vector_shfl",
           "cusp2": "csr_vector_shfl2", "cusparse": "xla",
           "cpu_navie": "cpu_naive"}
RINGS = ("plus_times", "min_plus", "max_times", "or_and")
ELL_KINDS = ("csr_scalar", "csr_vector_ell", "csr_vector_shfl_ell",
             "csr_vector_shfl2_ell", "light_vec_ell", "light_warp_ell")
STREAM_KINDS = ("csr_vector", "csr_vector_shfl", "csr_vector_shfl2",
                "light_vec", "light_warp")


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _x(n, seed, ring="plus_times"):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if ring == "or_and":
        x[np.random.default_rng(seed + 1).random(n) < 0.7] = 0.0
    return x


def _check(got, want, ring):
    if ring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def _oracle(A, x, ring):
    if ring == "plus_times":
        return spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    return spmv_tpu_torch.spmv_ref_semiring(A, x, tsr.BUILTIN_SEMIRINGS[ring])


def test_list_kinds_holds_19_reference_kinds():
    """Every kind of the reference, `merge_tiled` included: 20 of them."""
    ref = set(spmv_tpu.list_kinds())
    assert spmv_tpu_torch.list_kinds() == spmv_tpu.list_kinds() and len(ref) == 20
    port_aliases = set(spmv_tpu_torch.list_kinds(True)) - ref
    assert port_aliases == set(spmv_tpu.list_kinds(True)) - set(spmv_tpu.list_kinds())
    assert port_aliases == set(ALIASES) | {"cub_merge"}


@pytest.fixture(scope="module")
def power_law():
    # long rows and many empty rows; within the stream planner's reach
    A = power_law_csr(3000, 3000, 20000, seed=1)
    return A, _port(A)


@pytest.mark.parametrize("kind,ring", [
    (k, r) for k in NEW_KINDS for r in RINGS
    if k != "dense" or r == "plus_times"])  # dense: plus-times only
def test_kind_matches_reference_and_oracle(power_law, kind, ring):
    A, At = power_law
    x = _x(A.n_cols, 2, ring)
    jr, tr = jsr.BUILTIN_SEMIRINGS[ring], tsr.BUILTIN_SEMIRINGS[ring]
    got = spmv_tpu_torch.spmv(kind, At, torch.from_numpy(x), semiring=tr)
    assert got.dtype == torch.float32 and got.shape == (A.n_rows,)
    got = got.numpy()
    _check(got, _oracle(At, x, ring), ring)
    _check(got, np.asarray(spmv_tpu.spmv(kind, A, x, semiring=jr)), ring)


def test_dense_refuses_other_rings(power_law):
    _, At = power_law
    with pytest.raises(ValueError, match="does not support semirings"):
        spmv_tpu_torch.spmv("dense", At, torch.ones(At.n_cols), semiring=tsr.MIN_PLUS)


@pytest.mark.parametrize("alias", list(ALIASES))
def test_aliases_run_their_kind(power_law, alias):
    _, At = power_law
    x = torch.from_numpy(_x(At.n_cols, 3))
    for ring in ("plus_times", "min_plus"):
        sr = tsr.BUILTIN_SEMIRINGS[ring]
        np.testing.assert_array_equal(
            spmv_tpu_torch.spmv(alias, At, x, semiring=sr).numpy(),
            spmv_tpu_torch.spmv(ALIASES[alias], At, x, semiring=sr).numpy())
    assert spmv_tpu_torch.get_kernel(alias).name == ALIASES[alias]


def _edge_matrices():
    empty = CSR(40, 30, np.zeros(41, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 60, 45))
    Ap = np.searchsorted(rows, np.arange(61)).astype(np.int32)
    one_col = CSR(60, 1, Ap, np.zeros(45, np.int32),
                  rng.standard_normal(45).astype(np.float32))
    return {"empty": empty, "one_col": one_col}


@pytest.mark.parametrize("edge", ["empty", "one_col"])
@pytest.mark.parametrize("kind", NEW_KINDS)
def test_kind_on_edge_matrices(kind, edge):
    """The empty matrix (every row empty) and a single column with empty
    rows: plus-times and min-plus against the oracle."""
    A = _edge_matrices()[edge]
    x = _x(A.n_cols, 7)
    for ring in ("plus_times", "min_plus"):
        if kind == "dense" and ring != "plus_times":
            continue
        y = spmv_tpu_torch.spmv(kind, A, torch.from_numpy(x),
                                semiring=tsr.BUILTIN_SEMIRINGS[ring]).numpy()
        _check(y, _oracle(A, x, ring), ring)
        if ring == "min_plus":  # empty rows hold the identity
            empty_rows = np.diff(np.asarray(A.Ap)) == 0
            assert empty_rows.any() and np.isinf(y[empty_rows]).all()


@pytest.mark.parametrize("kind", ELL_KINDS + ("dia", "xla", "csr_vector"))
def test_identity_fold(kind):
    """max-times on rows whose products are all negative gives the
    identity 0, and min-plus on empty rows gives inf: the oracle's
    acc = initialize() takes part in every row."""
    n = 400
    rows = np.repeat(np.arange(0, n, 2), 3)  # odd rows empty
    cols = np.clip(rows + np.tile([-1, 0, 1], n // 2), 0, n - 1)
    vals = np.random.default_rng(1).uniform(0.5, 2.0, rows.size).astype(np.float32)
    A = spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(n, n, rows, cols, vals))
    x = -np.random.default_rng(2).uniform(0.5, 2.0, n).astype(np.float32)
    y = spmv_tpu_torch.spmv(kind, A, torch.from_numpy(x),
                            semiring=tsr.MAX_TIMES).numpy()
    assert (y == 0).all()
    y = spmv_tpu_torch.spmv(kind, A, torch.from_numpy(x),
                            semiring=tsr.MIN_PLUS).numpy()
    assert np.isinf(y[1::2]).all() and np.isfinite(y[::2]).all()


@pytest.mark.parametrize("kind", ["csr_vector", "csr_vector_shfl", "csr_vector_shfl2",
                                  "cusp", "cusp1", "cusp2"])
def test_csr_vector_on_banded_input_runs_dia(monkeypatch, kind):
    from spmv_tpu_torch.kernels import dia as tdia
    from spmv_tpu_torch.kernels import stream as tstream

    calls = []
    real = tdia._dia_pass

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_stream(*a, **k):
        raise AssertionError("the stream pipeline ran on a banded matrix")

    monkeypatch.setattr(tdia, "_dia_pass", counting)
    monkeypatch.setattr(tstream, "_stream_spmv", no_stream)
    A = _port(banded_csr(3000, 4, seed=3))
    x = _x(A.n_cols, 4)
    y = spmv_tpu_torch.spmv(kind, A, torch.from_numpy(x)).numpy()
    assert calls == [1]
    _check(y, _oracle(A, x, "plus_times"), "plus_times")


@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_fallback_warning_past_planner_reach(monkeypatch, power_law, kind):
    from spmv_tpu_torch.kernels import ell as tell
    from spmv_tpu_torch.kernels import stream as tstream

    def refuse(*a, **k):
        raise spmv_tpu_torch.PlanCapacityError("forced: past the planner's reach")

    monkeypatch.setattr(tstream, "_stream_spmv", refuse)
    _, At = power_law
    x = _x(At.n_cols, 6)
    ran = []
    real = tell._group_reduce_pass
    monkeypatch.setattr(tell, "_group_reduce_pass",
                        lambda *a, **k: ran.append(k["strategy"]) or real(*a, **k))
    for ring in ("plus_times", "min_plus"):
        with pytest.warns(spmv_tpu_torch.FallbackWarning, match="ELL"):
            y = spmv_tpu_torch.spmv(kind, At, torch.from_numpy(x),
                                    semiring=tsr.BUILTIN_SEMIRINGS[ring]).numpy()
        _check(y, _oracle(At, x, ring), ring)
    assert ran  # the direct ELL kernels ran


def test_user_defined_ring_on_the_direct_kinds(power_law):
    """A ring the CUDA kernels do not know runs on the CPU through the
    plain versions and the generic segment reduce (no identity fold)."""
    _, At = power_law
    x = _x(At.n_cols, 8)
    ring = tsr.Semiring("my_max_plus", lambda: float("-inf"),
                        lambda a, v: a + v, torch.maximum)
    want = spmv_tpu_torch.spmv_ref_semiring(At, x, ring)
    for kind in ELL_KINDS + ("xla",):
        y = spmv_tpu_torch.spmv(kind, At, torch.from_numpy(x), semiring=ring).numpy()
        np.testing.assert_array_equal(y, want)


def test_segment_reduce_sorted_and_reduce_array_match_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    seg = np.sort(rng.integers(0, 50, 400)).astype(np.int32)
    vals = rng.standard_normal((400, 3)).astype(np.float32)
    for ring in RINGS:
        jr, tr = jsr.BUILTIN_SEMIRINGS[ring], tsr.BUILTIN_SEMIRINGS[ring]
        ident = float(tr.identity_for(np.float32))
        want = np.asarray(jsr.segment_reduce_sorted(
            jnp.asarray(vals), jnp.asarray(seg), 60, jr, ident))
        got = tsr.segment_reduce_sorted(torch.from_numpy(vals), torch.from_numpy(seg),
                                        60, tr, ident).numpy()
        _check(got, want, ring)
        for axis in (None, 0, 1):
            _check(tr.reduce_array(torch.from_numpy(vals), axis).numpy(),
                   np.asarray(jr.reduce_array(jnp.asarray(vals), axis)), ring)
