"""The merge kinds and the shortest-paths example of the port on the
CPU, against spmv_tpu's same kinds (Pallas interpret mode) and the
reference example."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import power_law_csr
from spmv_tpu_torch.examples import shortest_paths as tsp
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import merge as tmerge
from spmv_tpu_torch.kernels import stream as tstream
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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


@pytest.fixture(scope="module")
def jsp():
    """The reference example (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "ref_shortest_paths", os.path.join(ROOT, "examples", "shortest_paths.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["merge", "merge_stock", "cub_merge",
                                  "merge_genl"])
def test_merge_kinds_match_reference(kind):
    A = power_law_csr(8192, 8192, 50000, seed=15)
    x = np.random.default_rng(1).standard_normal(A.n_cols).astype(np.float32)
    yt = spmv_tpu_torch.spmv(kind, _port(A), x).numpy()
    yj = np.asarray(spmv_tpu.spmv(kind, A, x))
    np.testing.assert_allclose(yt, spmv_tpu_torch.spmv_ref(
        _port(A), x, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(yt, yj, rtol=2 * RTOL, atol=2 * ATOL)
    ym = spmv_tpu_torch.spmv(kind, _port(A), x, semiring=spmv_tpu_torch.MIN_PLUS)
    np.testing.assert_array_equal(ym.numpy(), np.asarray(
        spmv_tpu.spmv(kind, A, x, semiring=spmv_tpu.MIN_PLUS)))


def test_merge_kinds_use_the_reference_kappas():
    assert tmerge._stream_policy_for(14336, "cpu").kappa == 14336
    assert spmv_tpu_torch.get_kernel("cub_merge").name == "merge_stock"
    for kind in ("merge", "merge_stock", "merge_genl"):
        assert spmv_tpu_torch.get_kernel(kind).supports_semiring


def test_merge_past_planner_reach_names_k10(monkeypatch):
    """Past the stream planner's reach, `merge` and `merge_genl` warn with
    FallbackWarning and run merge_tiled's path (K10) under the tuned
    policy, `merge_stock` under the stock policy, as the reference does
    (merge.py:584-624)."""
    def refuse(A, policy):
        raise spmv_tpu_torch.PlanCapacityError("too large")

    A = _port(power_law_csr(4096, 4096, 20000, seed=2))
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    want = {p: tmerge._merge_impl(A, x, spmv_tpu_torch.PLUS_TIMES, p).numpy()
            for p in (tmerge.TUNED_POLICY, tmerge.STOCK_POLICY)}
    np.testing.assert_array_equal(spmv_tpu_torch.spmv("merge_tiled", A, x).numpy(),
                                  want[tmerge.TUNED_POLICY])
    monkeypatch.setattr(tstream, "build_stream_plan", refuse)
    for kind, policy in (("merge", tmerge.TUNED_POLICY), ("merge_genl", tmerge.TUNED_POLICY),
                         ("merge_stock", tmerge.STOCK_POLICY)):
        with pytest.warns(spmv_tpu_torch.FallbackWarning, match="too large"):
            y = spmv_tpu_torch.spmv(kind, A, x).numpy()
        np.testing.assert_array_equal(y, want[policy])
        np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64),
                                   rtol=RTOL, atol=ATOL)


def test_random_graph_matches_reference(jsp):
    Aj, At = jsp.random_graph(3000, seed=4), tsp.random_graph(3000, seed=4)
    for f in ("Ap", "Aj", "Ax"):
        np.testing.assert_array_equal(np.asarray(getattr(Aj, f)),
                                      np.asarray(getattr(At, f)))


def test_sssp_matches_reference_example(jsp):
    """Bellman-Ford through merge_genl (the no-reduction branch: K3, K5,
    K8) against the reference example's sssp on the stream kind and its
    Dijkstra."""
    A = jsp.random_graph(2000)
    d_ref, it_ref = jsp.sssp(A, 0, kind="stream")
    d, it = tsp.sssp(_port(A), 0, device="cpu")
    assert isinstance(d, torch.Tensor) and d.device.type == "cpu"
    assert it == it_ref
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    dj = jsp.dijkstra_ref(A, 0)
    np.testing.assert_array_equal(tsp.dijkstra_ref(_port(A), 0), dj)
    reach = np.isfinite(dj)
    assert np.array_equal(np.isfinite(d.numpy()), reach)
    assert np.abs(d.numpy()[reach] - dj[reach]).max() < 1e-4


def test_sssp_each_relaxation_equals_the_oracle():
    A = tsp.random_graph(1500, seed=3)
    seen = []

    def check(d, relaxed):
        np.testing.assert_array_equal(
            relaxed.numpy(), spmv_tpu_torch.spmv_ref_semiring(
                A, d.numpy(), spmv_tpu_torch.MIN_PLUS))
        seen.append(1)

    _, it = tsp.sssp(A, 0, kind="merge_genl", device="cpu", on_relax=check)
    assert len(seen) == it > 1


def test_shortest_paths_module_runs(capsys):
    tsp.main(800, "merge_genl", device="cpu")
    assert "converged" in capsys.readouterr().out
