"""The port's dtype contract at the dispatch seam against the reference's.

The reference's entry points run `jnp.asarray` on the caller's x (and
b, x0, X), which with JAX's x64 mode off (its default) narrows float64
to float32 and int64 to int32; the port's `as_input` does the same. So a
float64 x computes in float32 on every kind, and what raises is what the
reference raises: a float64 Ax, and an integer x against float values
(NumPy promotes int32 with float32 to float64) on the planned kinds.

Every kind and every `spmm` method runs on a tiny power-law matrix with
x in float64, float16, int32 and int64 and Ax in float32, float64,
float16 and int8, each pair its own case. Each case checks that the port
returns the reference's dtype, or raises where the reference raises,
and that the values agree within rtol 2e-4 / atol 1e-5 (the data are
multiples of 1/2 in [-2, 2], so every product and sum is exact in
float16 and both sides give the same values). A float16 compute dtype on
the stream path is held to the reference like every other: the port's
stream kernels compute it in float32 and round at each write.
"""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu import solvers as jsolvers
from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import power_law_csr
from spmv_tpu_torch import solvers as tsolvers
from spmv_tpu_torch.formats import CSR
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
X_DTYPES = ("float64", "float16", "int32", "int64")
AX_DTYPES = ("float32", "float64", "float16", "int8")
KINDS = ("cpu_naive", "csr_scalar", "csr_vector", "csr_vector_ell",
         "csr_vector_shfl", "csr_vector_shfl2", "csr_vector_shfl2_ell",
         "csr_vector_shfl_ell", "dense", "dia", "light_vec", "light_vec_ell",
         "light_warp", "light_warp_ell", "merge", "merge_genl", "merge_stock",
         "merge_tiled", "stream", "xla")
BASE = power_law_csr(40, 36, 150, seed=3)


def test_kinds_cover_the_registry():
    assert list(KINDS) == spmv_tpu.list_kinds() == spmv_tpu_torch.list_kinds()


def _halves(shape, dtype, seed):
    v = np.random.default_rng(seed).integers(-4, 5, shape)
    return (v / 2 if np.dtype(dtype).kind == "f" else v).astype(dtype)


def _matrices(ax_dtype):
    Ax = _halves(np.asarray(BASE.Ax).shape, ax_dtype, 1)
    Ap, Aj = np.asarray(BASE.Ap), np.asarray(BASE.Aj)
    return (spmv_tpu.CSR(BASE.n_rows, BASE.n_cols, Ap, Aj, Ax),
            CSR(BASE.n_rows, BASE.n_cols, Ap, Aj, Ax))


def _run(fn):
    """(result as a NumPy array, None) or (None, the exception)."""
    try:
        y = fn()
    except Exception as e:  # noqa: BLE001 - a raise is one of the outcomes compared
        return None, e
    return (y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)), None


def _compare(name, ref, port, ax_dtype, x_dtype):
    (yj, ej), (yt, et) = ref, port
    assert (ej is None) == (et is None), (
        f"{name} Ax {ax_dtype} x {x_dtype}: reference "
        f"{'raised ' + repr(ej) if ej else 'returned ' + str(yj.dtype)}, port "
        f"{'raised ' + repr(et) if et else 'returned ' + str(yt.dtype)}")
    if ej is None:
        assert yt.dtype == yj.dtype and yt.shape == yj.shape
        np.testing.assert_allclose(yt.astype(np.float64), yj.astype(np.float64),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("x_dtype", X_DTYPES)
@pytest.mark.parametrize("ax_dtype", AX_DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_spmv_dtype_matches_reference(kind, ax_dtype, x_dtype):
    Aj, At = _matrices(ax_dtype)
    x = _halves(BASE.n_cols, x_dtype, 2)
    _compare(kind, _run(lambda: spmv_tpu.spmv(kind, Aj, x)),
             _run(lambda: spmv_tpu_torch.spmv(kind, At, x)), ax_dtype, x_dtype)


@pytest.mark.parametrize("x_dtype", X_DTYPES)
@pytest.mark.parametrize("ax_dtype", AX_DTYPES)
@pytest.mark.parametrize("method", ["auto", "window", "stream", "xla"])
def test_spmm_dtype_matches_reference(method, ax_dtype, x_dtype):
    Aj, At = _matrices(ax_dtype)
    X = _halves((BASE.n_cols, 3), x_dtype, 2)
    _compare(f"spmm/{method}", _run(lambda: spmv_tpu.spmm(Aj, X, method=method)),
             _run(lambda: spmv_tpu_torch.spmm(At, X, method=method)), ax_dtype, x_dtype)


@pytest.mark.parametrize("y_dtype", [np.float32, np.float16, np.int32, "float16",
                                     torch.float16])
@pytest.mark.parametrize("kind", ["stream", "xla"])
def test_y_dtype_takes_numpy_dtypes_and_names(kind, y_dtype):
    Aj, At = _matrices("float32")
    x = _halves(BASE.n_cols, "float32", 2)
    yj = np.asarray(spmv_tpu.spmv(kind, Aj, x, y_dtype=(
        np.float16 if y_dtype is torch.float16 else y_dtype)))
    yt = spmv_tpu_torch.spmv(kind, At, x, y_dtype=y_dtype).numpy()
    assert yt.dtype == yj.dtype
    np.testing.assert_allclose(yt.astype(np.float64), yj.astype(np.float64),
                               rtol=RTOL, atol=ATOL)


def _poisson2d(m):
    """The 5-point Laplacian on an m x m grid (tests/test_solvers.py:16)."""
    rows, cols, vals = [], [], []
    for i in range(m):
        for j in range(m):
            k = i * m + j
            for di, dj, v in ((0, 0, 4.0), (-1, 0, -1.0), (1, 0, -1.0),
                              (0, -1, -1.0), (0, 1, -1.0)):
                if 0 <= i + di < m and 0 <= j + dj < m:
                    rows.append(k), cols.append((i + di) * m + j + dj), vals.append(v)
    A = coo_to_csr(COO(m * m, m * m, np.array(rows), np.array(cols),
                       np.array(vals, np.float32)))
    return A, CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
                  np.asarray(A.Ax))


@pytest.mark.parametrize("kind", ["xla", "csr_vector", "dia"])
def test_cg_with_a_float64_b_solves_in_float32(kind):
    """A float64 b: the reference solves in float32 (jnp.asarray); so
    does the port, in as many iterations, within one (its sums run in
    another order), to the same solution within rtol 1e-4."""
    Aj, At = _poisson2d(20)
    b = np.random.default_rng(0).standard_normal(Aj.n_rows)  # float64
    xj, ij = jsolvers.cg(Aj, b, kind=kind)
    xt, it = tsolvers.cg(At, b, kind=kind)
    assert xt.dtype == torch.float32 and np.asarray(xj).dtype == np.float32
    assert it["converged"] and ij["converged"]
    assert abs(it["iters"] - ij["iters"]) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_shard_x_narrows_a_float64_x():
    """The multi-device layer takes a float64 x as the reference's
    matvec does (jnp.asarray): narrowed to float32, the same blocks and
    the same y as a float32 x, whole or already sharded, and the
    reference's y on a 2-device mesh."""
    import jax
    from jax.sharding import Mesh

    from spmv_tpu.parallel import dist_spmv as jds
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh

    Aj, At = _matrices("float32")
    d = distribute_csr(At, make_mesh("shards", n_shards=2, device="cpu"))
    x64 = _halves(BASE.n_cols, "float64", 2)
    xs = d.shard_x(x64)
    assert xs.dtype == torch.float32
    assert torch.equal(xs, d.shard_x(x64.astype(np.float32)))
    y = d.matvec(x64)
    assert y.dtype == torch.float32
    assert torch.equal(y, d.matvec(torch.from_numpy(x64.astype(np.float32))))
    sharded = torch.nn.functional.pad(torch.from_numpy(x64), (0, d.x_pad - x64.size))
    assert torch.equal(y, d.matvec(sharded.view(2, -1)))
    yj = np.asarray(jds.distribute_csr(Aj, Mesh(np.array(jax.devices()[:2]), ("shards",)))
                    .matvec(x64))
    assert yj.dtype == np.float32
    np.testing.assert_allclose(y.numpy(), yj, rtol=RTOL, atol=ATOL)
