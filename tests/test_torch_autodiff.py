"""The port's differentiable SpMV (`spmv_tpu_torch.ops.autodiff`) against
`spmv_tpu.ops.autodiff` on the cases of tests/test_autodiff.py: the same
seeded inputs through `torch.autograd.grad` and `jax.grad`, and through
`torch.func.jvp` and `jax.jvp`. The reference runs its `xla` kind (no
Pallas); the port runs `xla`, `stream` and `csr_vector_ell`, each on its
plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.ops import autodiff as jad
from spmv_tpu_torch.formats import CSR as TCSR
from spmv_tpu_torch.ops import autodiff as tad

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
KINDS = ["xla", "stream", "csr_vector_ell"]


def _port(A):
    return TCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                np.asarray(A.Ax))


@pytest.fixture(scope="module")
def small():
    A = random_csr(64, 48, nnz=400, seed=3)
    x = np.random.default_rng(7).standard_normal(48).astype(np.float32)
    return A, _port(A), x


def _t(v, grad=False):
    return torch.tensor(np.asarray(v), requires_grad=grad)


@pytest.mark.parametrize("kind", KINDS)
def test_operator_forward_matches_reference(small, kind):
    A, At, x = small
    y = tad.SparseOperator(At, kind=kind)(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jad.SparseOperator(A)(x)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_operator_grad_matches_jax_grad(small, kind):
    A, At, x = small
    gj = jax.grad(lambda v: jnp.sum(jad.SparseOperator(A)(v) ** 2))(jnp.asarray(x))
    xt = _t(x, grad=True)
    op = tad.SparseOperator(At, kind=kind)
    gt, = torch.autograd.grad((op(xt) ** 2).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)
    D = A.to_dense().astype(np.float64)
    np.testing.assert_allclose(gt.numpy(), 2 * D.T @ (D @ x), rtol=1e-4, atol=1e-4)


def test_operator_grad_of_sum_is_transpose_times_ones(small):
    A, At, x = small
    gj = jax.jit(jax.grad(lambda v: jnp.sum(jad.SparseOperator(A)(v))))(jnp.asarray(x))
    xt = _t(x, grad=True)
    gt, = torch.autograd.grad(tad.SparseOperator(At)(xt).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


def test_operator_power_law_grad_with_rkind():
    A = power_law_csr(512, 512, nnz=4096, alpha=1.3, seed=11)
    x = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(jad.SparseOperator(A)(v) ** 2))(jnp.asarray(x))
    op = tad.SparseOperator(_port(A), kind="stream", rkind="xla")
    xt = _t(x, grad=True)
    gt, = torch.autograd.grad((op(xt) ** 2).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-3, atol=1e-4)


def test_operator_transpose_and_rmatvec(small):
    A, At, _ = small
    op, opj = tad.SparseOperator(At), jad.SparseOperator(A)
    y = np.random.default_rng(1).standard_normal(A.n_rows).astype(np.float32)
    np.testing.assert_allclose(op.T(torch.from_numpy(y)).numpy(), np.asarray(opj.T(y)),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(op.rmatvec(np.ones(A.n_rows, np.float32)).numpy(),
                               np.asarray(opj.rmatvec(np.ones(A.n_rows, np.float32))),
                               rtol=RTOL, atol=ATOL)
    assert op.T.T is op and op.T.A is op._AT and op.T._AT is At
    assert op.T.shape == opj.T.shape == (A.n_cols, A.n_rows)
    assert op.dtype == opj.dtype and op.shape == opj.shape
    np.testing.assert_allclose(op.matvec(torch.ones(A.n_cols)).numpy(),
                               np.asarray(opj.matvec(np.ones(A.n_cols, np.float32))),
                               rtol=RTOL, atol=ATOL)


def test_spmv_values_forward_matches_reference(small):
    A, At, x = small
    y = tad.spmv_values(At, np.asarray(A.Ax), x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jad.spmv_values(A, np.asarray(A.Ax), x)),
                               rtol=RTOL, atol=ATOL)


def test_spmv_values_grads_match_jax_grad(small):
    A, At, x = small
    loss_j = lambda vals, v: jnp.sum(jad.spmv_values(A, vals, v) ** 2)
    gaj, gxj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(np.asarray(A.Ax)), jnp.asarray(x))
    Ax, xt = _t(A.Ax, grad=True), _t(x, grad=True)
    gat, gxt = torch.autograd.grad((tad.spmv_values(At, Ax, xt) ** 2).sum(), (Ax, xt))
    np.testing.assert_allclose(gat.numpy(), np.asarray(gaj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gxj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wrt", ["x", "Ax"])
def test_spmv_values_jvp_matches_jax_jvp(small, wrt):
    A, At, x = small
    Ax = np.asarray(A.Ax)
    if wrt == "x":
        fj = lambda v: jad.spmv_values(A, jnp.asarray(Ax), v)
        ft = lambda v: tad.spmv_values(At, torch.from_numpy(Ax), v)
        p, t = x, np.random.default_rng(4).standard_normal(x.size).astype(np.float32)
    else:
        fj = lambda v: jad.spmv_values(A, v, jnp.asarray(x))
        ft = lambda v: tad.spmv_values(At, v, torch.from_numpy(x))
        p, t = Ax, np.random.default_rng(5).standard_normal(Ax.size).astype(np.float32)
    yj, dyj = jax.jvp(fj, (jnp.asarray(p),), (jnp.asarray(t),))
    yt, dyt = torch.func.jvp(ft, (torch.from_numpy(p),), (torch.from_numpy(t),))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dyt.numpy(), np.asarray(dyj), rtol=RTOL, atol=ATOL)


def test_spmv_values_shape_check(small):
    A, At, x = small
    with pytest.raises(ValueError, match="pattern"):
        tad.spmv_values(At, np.ones(A.nnz + 1, np.float32), x)


def test_spmv_values_n_rows_pads(small):
    A, At, x = small
    y = tad.spmv_values(At, np.asarray(A.Ax), x, n_rows=A.n_rows + 5)
    yj = jad.spmv_values(A, np.asarray(A.Ax), x, n_rows=A.n_rows + 5)
    assert y.shape == yj.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)


def test_spmv_value_grad_matches_reference(small):
    A, At, x = small
    g = np.random.default_rng(5).standard_normal(A.n_rows).astype(np.float32)
    got = tad.spmv_value_grad(At, x, g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jad.spmv_value_grad(A, x, g)))


def test_spmv_values_folds_in_float64():
    """Recorded difference: the fold sums in float64 and rounds once (the
    reference folds in float32). On one row whose float32 running sum
    loses the small terms, the port's y is the float64 sum rounded."""
    n = 4097
    Ap = np.array([0, n], np.int64)
    A = TCSR(1, n, Ap, np.arange(n, dtype=np.int32), np.ones(n, np.float32))
    x = np.full(n, 1e-8, np.float32)
    x[0] = 1.0
    y = tad.spmv_values(A, np.ones(n, np.float32), x)
    assert y.item() == np.float32(1.0 + (n - 1) * np.float64(np.float32(1e-8)))
    assert y.item() != np.float32(1.0)
