"""The port's `spgemm` against `spmv_tpu.kernels.spgemm` on the cases of
tests/test_spgemm.py, on the CPU (device="cpu").

The symbolic arrays (Cp, Cj, v_ap, srcA, srcB) must equal the
reference's bit for bit, native against native and NumPy against NumPy,
and the port's native against the reference's NumPy fallback (the SPA
walk and the lexsort give the same arrays). C's values are held against
the reference's `xla` method: plus-times within rtol 2e-4 / atol 1e-4
(tests/test_spgemm.py), the other rings bit for bit."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_tpu import native as jnative
from spmv_tpu.formats import COO as JCOO
from spmv_tpu.formats import CSR as JCSR
from spmv_tpu.formats import coo_to_csr as j_coo_to_csr
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.kernels import spgemm as jsp
from spmv_tpu.ops.semiring import MAX_TIMES as J_MAX_TIMES
from spmv_tpu.ops.semiring import MIN_PLUS as J_MIN_PLUS
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.formats import CSR as TCSR
from spmv_tpu_torch.kernels import spgemm as tsp
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS

torch.set_num_threads(1)

SYM_KEYS = ("Cp", "Cj", "v_ap", "srcA", "srcB")


def _port(A):
    return TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                np.asarray(A.Ax))


def _to_scipy(A):  # copies: SciPy sums duplicates in place, through shared arrays
    return sp.csr_matrix((np.array(A.Ax), np.array(A.Aj), np.array(A.Ap)),
                         shape=A.shape)


def _no_native(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
        assert not mod.available()


def _same_symbolic(sj, st):
    assert sj["n_triples"] == st["n_triples"]
    for k in SYM_KEYS:
        a, b = np.asarray(sj[k]), np.asarray(st[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


PAIRS = {
    "random": lambda: (random_csr(300, 400, 3000, seed=1), random_csr(400, 250, 2800, seed=2)),
    "power_law": lambda: (power_law_csr(500, 500, 6000, alpha=1.5, seed=3),
                          power_law_csr(500, 500, 5000, alpha=1.5, seed=4)),
    "square_self": lambda: (random_csr(200, 200, 1500, seed=5),) * 2,
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_symbolic_native_matches_reference_native(name):
    assert tnative.available() and jnative.available()
    A, B = PAIRS[name]()
    _same_symbolic(jsp._spgemm_symbolic(A, B), tsp._spgemm_symbolic(_port(A), _port(B)))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_symbolic_numpy_matches_reference_numpy(name, monkeypatch):
    A, B = PAIRS[name]()
    _no_native(monkeypatch, jnative, tnative)
    _same_symbolic(jsp._spgemm_symbolic(A, B), tsp._spgemm_symbolic(_port(A), _port(B)))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_symbolic_port_native_matches_reference_numpy(name, monkeypatch):
    A, B = PAIRS[name]()
    st = tsp._spgemm_symbolic(_port(A), _port(B))
    _no_native(monkeypatch, jnative)
    _same_symbolic(jsp._spgemm_symbolic(A, B), st)


def _check_plus_times(A, B, method="auto"):
    """The port's C against SciPy's pattern and the reference's values."""
    C = tsp.spgemm(_port(A), _port(B), method=method, device="cpu")
    assert isinstance(C.Ax, np.ndarray) and C.Ax.dtype == np.float32
    C_ref = (_to_scipy(A) @ _to_scipy(B)).sorted_indices()
    np.testing.assert_array_equal(np.asarray(C.Ap), C_ref.indptr)
    np.testing.assert_array_equal(np.asarray(C.Aj), C_ref.indices)
    np.testing.assert_allclose(C.Ax, C_ref.data, rtol=2e-4, atol=1e-4)
    Cj = jsp.spgemm(A, B, method="xla")
    for f in ("Ap", "Aj"):
        a, b = np.asarray(getattr(Cj, f)), np.asarray(getattr(C, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(C.Ax, np.asarray(Cj.Ax), rtol=2e-4, atol=1e-4)
    return C


@pytest.mark.parametrize("method", ["xla", "stream", "auto"])
def test_spgemm_random(method):
    _check_plus_times(*PAIRS["random"](), method)


@pytest.mark.parametrize("method", ["xla", "stream"])
def test_spgemm_power_law(method):
    _check_plus_times(*PAIRS["power_law"](), method)


def test_spgemm_square_self():
    A = random_csr(200, 200, 1500, seed=5)
    _check_plus_times(A, A)


def test_spgemm_empty_result():
    # A's columns only hit empty rows of B
    A = JCOO(4, 6, np.array([0, 2], np.int32), np.array([5, 5], np.int32),
             np.array([1.0, 2.0], np.float32))
    B = JCOO(6, 3, np.array([0], np.int32), np.array([1], np.int32),
             np.array([3.0], np.float32))
    A, B = j_coo_to_csr(A), j_coo_to_csr(B)
    C = tsp.spgemm(_port(A), _port(B), device="cpu")
    Cj = jsp.spgemm(A, B)
    assert C.nnz == 0 and C.shape == (4, 3) == Cj.shape
    assert C.Ax.dtype == np.asarray(Cj.Ax).dtype
    np.testing.assert_array_equal(np.asarray(C.Ap), np.asarray(Cj.Ap))


def test_spgemm_shape_mismatch():
    A = _port(random_csr(10, 11, 30, seed=0))
    B = _port(random_csr(12, 10, 30, seed=0))
    with pytest.raises(ValueError, match="mismatch"):
        tsp.spgemm(A, B, device="cpu")


def test_spgemm_without_a_card_raises_naming_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    A = _port(random_csr(10, 10, 30, seed=0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsp.spgemm(A, A)


def _simple_digraph(n, seed):
    """tests/test_spgemm.py's APSP graph: random_csr's (i, k) pairs
    deduplicated, weights |Ax| + 0.1."""
    A = random_csr(n, n, 500, seed=seed)
    rr, cc = A.row_ids(), np.asarray(A.Aj)
    _, keep = np.unique(rr.astype(np.int64) * n + cc, return_index=True)
    W = np.abs(np.asarray(A.Ax)[keep]).astype(np.float32) + 0.1
    return j_coo_to_csr(JCOO(n, n, rr[keep], cc[keep], W)), W


@pytest.mark.parametrize("method", ["xla", "stream"])
def test_spgemm_min_plus_apsp_step(method):
    # one APSP relaxation: D2 = D (min.+) D, bit for bit with the reference
    n = 60
    D, W = _simple_digraph(n, 7)
    C = tsp.spgemm(_port(D), _port(D), semiring=MIN_PLUS, method=method, device="cpu")
    Cj = jsp.spgemm(D, D, semiring=J_MIN_PLUS, method="xla")
    np.testing.assert_array_equal(C.Ax, np.asarray(Cj.Ax))
    # the dense min-plus oracle on C's pattern (absent = +inf)
    Dd = np.full((n, n), np.inf, np.float64)
    Dd[np.asarray(D.row_ids()), np.asarray(D.Aj)] = W
    ref = (Dd[:, :, None] + Dd[None, :, :]).min(axis=1)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(C.Ap)))
    np.testing.assert_allclose(C.Ax, ref[rows, np.asarray(C.Aj)], rtol=0, atol=1e-4)


def test_spgemm_max_times_matches_reference_bit_for_bit():
    A, B = PAIRS["power_law"]()
    A = JCSR(A.n_rows, A.n_cols, A.Ap, A.Aj, np.abs(np.asarray(A.Ax)))
    C = tsp.spgemm(_port(A), _port(B), semiring=MAX_TIMES, method="stream", device="cpu")
    Cj = jsp.spgemm(A, B, semiring=J_MAX_TIMES, method="xla")
    np.testing.assert_array_equal(C.Ax, np.asarray(Cj.Ax))


def test_spgemm_plan_cached_and_value_correct_for_distinct_B():
    A = random_csr(50, 50, 300, seed=8)
    B1 = random_csr(50, 50, 280, seed=9)
    B2 = random_csr(50, 50, 280, seed=10)
    At, B1t, B2t = _port(A), _port(B1), _port(B2)
    for B, Bt in ((B1, B1t), (B2, B2t), (B1, B1t)):  # a plan per B's identity
        C = tsp.spgemm(At, Bt, device="cpu")
        np.testing.assert_allclose(C.Ax, np.asarray(jsp.spgemm(A, B, method="xla").Ax),
                                   rtol=2e-4, atol=1e-4)
    assert tsp._plan(At, B1t) is tsp._plan(At, B1t)
    assert tsp._plan(At, B1t) is not tsp._plan(At, B2t)


def test_auto_uses_xla_until_stream_planned():
    """'auto' does not pay the O(nnz) stream plan for a one-shot product;
    after one method='stream' call the same (A, B) rides the cached plan,
    found through plan_cached under the one policy both use."""
    from spmv_tpu_torch.kernels.stream import plan_cache_key
    from spmv_tpu_torch.ops.registry import plan_cached

    A = _port(random_csr(300, 200, 2000, seed=5))
    B = _port(random_csr(200, 250, 2000, seed=6))
    C1 = tsp.spgemm(A, B, method="auto", device="cpu")
    V = tsp._plan(A, B)["V"]
    assert not tsp._stream_planned(V)
    assert not plan_cached(V, plan_cache_key(tsp._POLICY))
    C2 = tsp.spgemm(A, B, method="stream", device="cpu")
    assert tsp._stream_planned(V) and plan_cached(V, plan_cache_key(tsp._POLICY))
    C3 = tsp.spgemm(A, B, method="auto", device="cpu")
    np.testing.assert_allclose(C1.Ax, C2.Ax, rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(C2.Ax, C3.Ax)  # the same stream plan


def test_auto_finds_a_plan_on_disk(tmp_path):
    """The on-disk probe keys the file by utils/plancache.plan_key under
    the same policy, so a plan saved by an earlier process is found."""
    from spmv_tpu_torch import config
    from spmv_tpu_torch.utils.plancache import stream_plan_cached

    A = _port(random_csr(120, 100, 700, seed=3))
    B = _port(random_csr(100, 90, 600, seed=4))
    V = tsp._plan(A, B)["V"]
    config.set_plan_dir(str(tmp_path))
    try:
        assert not tsp._stream_planned(V)
        stream_plan_cached(V, tsp._POLICY, str(tmp_path))
        assert tsp._stream_planned(V)
    finally:
        config.set_plan_dir(None)


def test_spgemm_returns_a_host_csr():
    """Recorded difference: C comes back as a host CSR (NumPy arrays),
    as every container of the port; the reference's C holds its values
    in a device array."""
    A = _port(random_csr(40, 40, 200, seed=1))
    C = tsp.spgemm(A, A, method="stream", device="cpu")
    for f in ("Ap", "Aj", "Ax"):
        assert isinstance(getattr(C, f), np.ndarray), f
