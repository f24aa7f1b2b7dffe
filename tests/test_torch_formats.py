"""spmv_tpu_torch foundations against the JAX reference: generators,
containers, semirings, the oracle and the registry surface."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io import generate as jgen
from spmv_tpu.ops import reference as jref
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.ops import reference as tref

torch.set_num_threads(1)

GENERATORS = [
    ("power_law_csr", (4000, 5000, 30000)),
    ("random_csr", (3000, 2000, 20000)),
    ("banded_csr", (5000,)),
]


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("Ap", "Aj", "Ax"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,args", GENERATORS)
def test_generators_match_reference(name, args, seed):
    _same_csr(getattr(jgen, name)(*args, seed=seed),
              getattr(tgen, name)(*args, seed=seed))


def test_coo_to_csr_and_dense_match_reference():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 300, 4000).astype(np.int32)
    cols = rng.integers(0, 200, 4000).astype(np.int32)
    vals = rng.standard_normal(4000).astype(np.float32)
    for dup in (False, True):
        a = spmv_tpu.coo_to_csr(spmv_tpu.COO(300, 200, rows, cols, vals),
                                sum_duplicates=dup)
        b = spmv_tpu_torch.coo_to_csr(
            spmv_tpu_torch.COO(300, 200, rows, cols, vals), sum_duplicates=dup)
        _same_csr(a, b)
        np.testing.assert_array_equal(spmv_tpu.csr_to_dense(a),
                                      spmv_tpu_torch.csr_to_dense(b))


def test_native_and_numpy_coo_to_csr_agree(monkeypatch):
    from spmv_tpu_torch import native

    A = tgen.power_law_csr(2000, 2000, 15000, seed=3)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    _same_csr(A, tgen.power_law_csr(2000, 2000, 15000, seed=3))


def test_spmv_ref_matches_reference_oracle():
    A = tgen.power_law_csr(5000, 4000, 40000, seed=4)
    x = np.random.default_rng(4).standard_normal(4000).astype(np.float32)
    for y_dtype in (np.float64, None):
        np.testing.assert_array_equal(jref.spmv_ref(A, x, y_dtype=y_dtype),
                                      tref.spmv_ref(A, x, y_dtype=y_dtype))


@pytest.mark.parametrize("ring", ["PLUS_TIMES", "MIN_PLUS", "MAX_TIMES", "OR_AND"])
def test_semiring_oracle_matches_reference(ring):
    A = tgen.power_law_csr(400, 300, 1500, seed=5)
    x = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    x[::7] = 0.0  # or_and sees false inputs
    yj = jref.spmv_ref_semiring(A, x, getattr(spmv_tpu, ring))
    yt = tref.spmv_ref_semiring(A, x, getattr(spmv_tpu_torch, ring))
    assert yj.dtype == yt.dtype
    if ring == "PLUS_TIMES":  # f32 sums; the reference adds in row order
        np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(yt, yj)


def test_custom_ring_oracle_runs_row_loop():
    ring = spmv_tpu_torch.Semiring(
        "abs_max", lambda: 0.0, lambda a, x: a * x,
        lambda acc, v: torch.maximum(acc.abs(), v.abs()))
    A = tgen.random_csr(50, 40, 300, seed=6)
    x = np.random.default_rng(6).standard_normal(40).astype(np.float32)
    y = tref.spmv_ref_semiring(A, x, ring)
    prod = np.abs(np.asarray(A.Ax) * x[np.asarray(A.Aj)])
    Ap = np.asarray(A.Ap)
    want = [prod[Ap[i]:Ap[i + 1]].max(initial=0.0) for i in range(50)]
    np.testing.assert_allclose(y, want, rtol=1e-6)


def test_correctness_delta_matches_reference():
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal(100), rng.standard_normal(100)
    assert jref.correctness_delta(a, b) == tref.correctness_delta(a, b)


@pytest.mark.parametrize("ring", ["PLUS_TIMES", "MIN_PLUS", "MAX_TIMES", "OR_AND"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_semiring_identity_matches_reference(ring, dtype):
    assert getattr(spmv_tpu, ring).identity_for(dtype) == \
        getattr(spmv_tpu_torch, ring).identity_for(dtype)


def test_registry_surface():
    assert spmv_tpu_torch.list_kinds() == ["stream"]
    with pytest.raises(KeyError, match="valid kinds"):
        spmv_tpu_torch.get_kernel("nope")
    A = tgen.random_csr(10, 8, 20, seed=0)
    with pytest.raises(ValueError, match="shape"):
        spmv_tpu_torch.spmv("stream", A, np.zeros(9, np.float32))
    with pytest.raises(ValueError, match="float64"):
        spmv_tpu_torch.spmv("stream", A, np.zeros(8, np.float64))
    with pytest.raises(ValueError, match="n_rows"):
        spmv_tpu_torch.SpMV("stream", 10, 8, 20, np.zeros(3), A.Aj, A.Ax,
                            np.zeros(8, np.float32))


def test_empty_matrix_gives_identity():
    A = spmv_tpu_torch.CSR(5, 4, np.zeros(6, np.int32),
                           np.zeros(0, np.int32), np.zeros(0, np.float32))
    y = spmv_tpu_torch.spmv("stream", A, torch.ones(4))
    assert y.dtype == torch.float32 and y.tolist() == [0.0] * 5
    y = spmv_tpu_torch.spmv("stream", A, torch.ones(4),
                            semiring=spmv_tpu_torch.MIN_PLUS)
    assert y.tolist() == [float("inf")] * 5


def test_import_leaves_jax_out():
    code = ("import sys, numpy as np, spmv_tpu_torch as st\n"
            "from spmv_tpu_torch.io.generate import power_law_csr\n"
            "A = power_law_csr(4096, 4096, 30000, seed=1)\n"
            "y = st.spmv('stream', A, np.ones(4096, np.float32))\n"
            "assert y.shape == (4096,)\n"
            "assert 'jax' not in sys.modules and 'spmv_tpu' not in sys.modules\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
