"""The port's interop (`spmv_tpu_torch.io.interop`) on the cases of
tests/test_interop.py: the SciPy round trips against the reference's
`from_scipy`/`to_scipy` (the same arrays), and the torch.sparse pair that
takes the place of the reference's BCOO pair: COO and CSR layouts,
duplicates summed as `from_bcoo` sums them, batched and hybrid tensors
refused."""

import warnings

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

from spmv_tpu.io import interop as jio
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu_torch import spmv, spmv_ref
from spmv_tpu_torch.formats import CSR as TCSR
from spmv_tpu_torch.io import interop as tio
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:Sparse")  # torch.sparse's beta notices


def _port(A):
    return TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                np.asarray(A.Ax))


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("Ap", "Aj", "Ax"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_scipy_roundtrip_matches_reference():
    A = random_csr(120, 90, nnz=800, seed=4)
    S = tio.to_scipy(_port(A))
    assert S.shape == (120, 90)
    Sj = jio.to_scipy(A)
    assert (S != Sj).nnz == 0
    _same_csr(jio.from_scipy(Sj), tio.from_scipy(S))
    np.testing.assert_allclose(tio.from_scipy(S).to_dense(), A.to_dense(), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["coo_matrix", "csc_matrix", "csr_matrix"])
def test_from_scipy_other_formats(fmt):
    rng = np.random.default_rng(0)
    D = (rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.1)).astype(np.float32)
    S = getattr(scipy_sparse, fmt)(D)
    _same_csr(jio.from_scipy(S), tio.from_scipy(S))
    np.testing.assert_allclose(tio.from_scipy(S).to_dense(), D, rtol=1e-6)


def test_from_scipy_dtype_override():
    S = scipy_sparse.random(50, 50, density=0.05, format="csr", random_state=1,
                            dtype=np.float64)
    A = tio.from_scipy(S, offset_dtype=np.int64, index_dtype=np.int64)
    _same_csr(jio.from_scipy(S, offset_dtype=np.int64, index_dtype=np.int64), A)
    assert A.Ap.dtype == A.Aj.dtype == np.int64 and A.Ax.dtype == np.float64


def test_from_scipy_rejects_dense():
    with pytest.raises(TypeError):
        tio.from_scipy(np.eye(3))


def test_spmv_on_converted_matches_scipy():
    S = scipy_sparse.random(300, 200, density=0.03, format="csr", random_state=7,
                            dtype=np.float32)
    x = np.random.default_rng(2).standard_normal(200).astype(np.float32)
    y = spmv("xla", tio.from_scipy(S), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), S @ x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_torch_sparse_roundtrip(layout):
    A = _port(power_law_csr(128, 128, nnz=900, alpha=1.4, seed=9))
    M = tio.to_torch_sparse(A, getattr(torch, f"sparse_{layout}"))
    assert M.shape == (128, 128) and M.layout == getattr(torch, f"sparse_{layout}")
    assert M.dtype == torch.float32
    np.testing.assert_array_equal(M.to_dense().numpy(), A.to_dense())
    B = tio.from_torch_sparse(M)
    np.testing.assert_allclose(B.to_dense(), A.to_dense(), rtol=1e-6)
    # the reference's BCOO round trip gives the same matrix
    Bj = jio.from_bcoo(jio.to_bcoo(power_law_csr(128, 128, nnz=900, alpha=1.4, seed=9)))
    np.testing.assert_allclose(B.to_dense(), Bj.to_dense(), rtol=1e-6)


@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_torch_sparse_matvec_agrees(layout):
    A = _port(random_csr(100, 80, nnz=500, seed=5))
    M = tio.to_torch_sparse(A, getattr(torch, f"sparse_{layout}"))
    x = np.random.default_rng(3).standard_normal(80).astype(np.float32)
    np.testing.assert_allclose((M @ torch.from_numpy(x)).numpy(), spmv_ref(A, x),
                               rtol=1e-4, atol=1e-5)


def test_from_torch_sparse_sums_duplicates_as_from_bcoo():
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    idx = np.array([[0, 1], [0, 1], [2, 0]], np.int32)
    data = np.array([1.0, 2.0, 5.0], np.float32)
    Aj = jio.from_bcoo(jsparse.BCOO((jnp.asarray(data), jnp.asarray(idx)), shape=(3, 3)))
    M = torch.sparse_coo_tensor(torch.from_numpy(idx.T.astype(np.int64)),
                                torch.from_numpy(data), (3, 3))
    A = tio.from_torch_sparse(M)
    assert A.nnz == 2
    _same_csr(Aj, A)
    kept = tio.from_torch_sparse(M, sum_duplicates=False)
    assert kept.nnz == 3 and kept.to_dense()[0, 1] == 3.0


@pytest.mark.parametrize("case", ["batched", "hybrid", "dense"])
def test_from_torch_sparse_rejects_batched_and_hybrid(case):
    if case == "batched":
        M = torch.ones(2, 3, 3).to_sparse()
    elif case == "hybrid":
        M = torch.ones(3, 3, 2).to_sparse(2)
    else:
        M = torch.ones(3, 3)
    with pytest.raises(ValueError, match="unbatched|layout"):
        tio.from_torch_sparse(M)


def test_to_torch_sparse_on_a_device_and_bad_layout():
    A = _port(random_csr(20, 20, nnz=60, seed=1))
    assert tio.to_torch_sparse(A, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="layout"):
        tio.to_torch_sparse(A, torch.strided)
