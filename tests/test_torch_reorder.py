"""The port's reverse Cuthill-McKee (`spmv_tpu_torch.ops.reorder`) against
`spmv_tpu.ops.reorder` on the cases of tests/test_reorder.py: the
permutations, the permuted matrices and the bandwidths bit for bit."""

import numpy as np
import pytest
import torch

from spmv_tpu.formats import COO as JCOO
from spmv_tpu.formats import coo_to_csr as j_coo_to_csr
from spmv_tpu.io.generate import banded_csr, power_law_csr, random_csr
from spmv_tpu.ops import reorder as jre
from spmv_tpu_torch import spmv, spmv_ref
from spmv_tpu_torch.formats import CSR as TCSR
from spmv_tpu_torch.ops import reorder as tre

torch.set_num_threads(1)


def _port(A):
    return TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                np.asarray(A.Ax))


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("Ap", "Aj", "Ax"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _shuffled_banded(n=200, bw=4, seed=0):
    A = banded_csr(n, bandwidth=bw, seed=seed)
    p = np.random.default_rng(seed + 1).permutation(n)
    return jre.permute(A, p), bw


MATS = {
    "random": lambda: random_csr(150, 150, nnz=900, seed=2),
    "power_law": lambda: power_law_csr(256, 256, nnz=2000, alpha=1.3, seed=6),
    "power_law_512": lambda: power_law_csr(512, 512, nnz=4000, alpha=1.4, seed=12),
    "shuffled_band": lambda: _shuffled_banded()[0],
    "shuffled_band_1024": lambda: _shuffled_banded(n=1024, bw=4, seed=5)[0],
    "islands": lambda: j_coo_to_csr(JCOO(8, 8, np.array([0, 1, 2, 5, 6, 7], np.int64),
                                         np.array([1, 2, 0, 6, 7, 5], np.int64),
                                         np.ones(6, np.float32))),
}


@pytest.mark.parametrize("name", sorted(MATS))
def test_rcm_matches_reference(name):
    A = MATS[name]()
    pj, pt = jre.rcm_permutation(A), tre.rcm_permutation(_port(A))
    assert pj.dtype == pt.dtype
    np.testing.assert_array_equal(pj, pt)
    assert sorted(pt) == list(range(A.n_rows))
    Bj, _ = jre.rcm_reorder(A)
    Bt, perm = tre.rcm_reorder(_port(A))
    _same_csr(Bj, Bt)
    np.testing.assert_array_equal(perm, pt)
    assert tre.bandwidth(Bt) == jre.bandwidth(Bj)


def test_rcm_recovers_banded_bandwidth():
    A, bw = _shuffled_banded()
    assert tre.bandwidth(_port(A)) > 10 * bw
    B, _ = tre.rcm_reorder(_port(A))
    assert tre.bandwidth(B) <= 3 * bw


def test_permute_spmv_equivalence():
    A = _port(MATS["power_law"]())
    x = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    B, perm = tre.rcm_reorder(A)
    np.testing.assert_allclose(spmv_ref(B, x[perm]), spmv_ref(A, x)[perm],
                               rtol=1e-5, atol=1e-6)


def test_permute_rectangular_rowcol():
    A = random_csr(60, 40, nnz=300, seed=8)
    rp = np.random.default_rng(1).permutation(60)
    cp = np.random.default_rng(2).permutation(40)
    _same_csr(jre.permute(A, rp, cp), tre.permute(_port(A), rp, cp))
    np.testing.assert_allclose(tre.permute(_port(A), rp, cp).to_dense(),
                               A.to_dense()[np.ix_(rp, cp)], rtol=1e-6)


def test_permute_preserves_dtypes():
    A = random_csr(50, 50, nnz=200, seed=3, index_dtype=np.int64, offset_dtype=np.int64)
    B = tre.permute(_port(A), np.arange(50)[::-1])
    _same_csr(jre.permute(A, np.arange(50)[::-1]), B)
    assert B.Ap.dtype == B.Aj.dtype == np.int64


def test_permute_length_check():
    with pytest.raises(ValueError, match="length"):
        tre.permute(_port(random_csr(10, 10, nnz=30, seed=0)), np.arange(9))


def test_rcm_rejects_rectangular():
    with pytest.raises(ValueError, match="square"):
        tre.rcm_permutation(_port(random_csr(10, 12, nnz=30, seed=0)))


def test_kernel_on_reordered_matrix():
    A = _port(MATS["power_law_512"]())
    B, perm = tre.rcm_reorder(A)
    x = np.random.default_rng(9).standard_normal(512).astype(np.float32)
    y = spmv("merge", B, torch.from_numpy(x[perm]))
    np.testing.assert_allclose(y.numpy(), spmv_ref(A, x)[perm], rtol=1e-3, atol=1e-4)


def test_rcm_shrinks_column_window_count():
    A = _port(MATS["shuffled_band_1024"]())
    B, _ = tre.rcm_reorder(A)

    def windows_touched(C, block=128, win=128):
        return len(set(zip((C.row_ids() // block).tolist(),
                           (np.asarray(C.Aj) // win).tolist())))

    assert windows_touched(B) < windows_touched(A) / 2
