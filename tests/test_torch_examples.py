"""The port's PageRank and BFS examples (`spmv_tpu_torch.examples`) on the
CPU at tests/test_examples.py's sizes, held against the reference
examples' own functions (examples/pagerank.py, examples/bfs.py) on the
same graphs: the BFS levels bit for bit, the ranks within 1e-6 and the
iteration counts within one."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from spmv_tpu_torch.examples import bfs as tbfs
from spmv_tpu_torch.examples import pagerank as tpr
from spmv_tpu_torch.formats import CSR as TCSR

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_csr(A):
    from spmv_tpu.formats import CSR

    return CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, A.Ax)


@pytest.mark.parametrize("kind", ["xla", "stream"])
def test_pagerank_matches_reference(kind, capsys):
    out = tpr.main(["--kind", kind, "--nodes", "800", "--edges", "4000", "--device", "cpu"])
    assert "dense-oracle max abs diff" in capsys.readouterr().out
    rj, it_j = _reference("pagerank").pagerank(_jax_csr(out["A_t"]), out["out_deg"], "xla")
    assert abs(out["iters"] - it_j) <= 1, (out["iters"], it_j)
    np.testing.assert_allclose(out["ranks"], np.asarray(rj), rtol=0, atol=1e-6)
    assert abs(out["ranks"].sum() - 1.0) < 1e-4


def test_pagerank_graph_is_the_reference_graph():
    from spmv_tpu.io.generate import power_law_csr

    W, A_t, out_deg = tpr.build(800, 4000)
    G = power_law_csr(800, 800, 4000, alpha=1.6, seed=7)
    np.testing.assert_array_equal(W.Ap, np.asarray(G.Ap))
    np.testing.assert_array_equal(W.Aj, np.asarray(G.Aj))
    np.testing.assert_array_equal(out_deg, G.row_lengths())
    assert isinstance(A_t, TCSR) and A_t.nnz == G.nnz


@pytest.mark.parametrize("kind", ["xla", "merge_genl"])
def test_bfs_matches_reference(kind, capsys):
    out = tbfs.main(["--kind", kind, "--nodes", "600", "--edges", "3000", "--device", "cpu"])
    assert "host-BFS oracle: exact match" in capsys.readouterr().out
    ref = _reference("bfs")
    lj, dj = ref.bfs(_jax_csr(out["A_t"]), out["source"], "xla")
    np.testing.assert_array_equal(out["level"], lj)
    assert out["depth"] == dj
    np.testing.assert_array_equal(out["level"], ref.bfs_ref(out["A_t"], out["source"]))


def test_bfs_from_a_given_source():
    G, A_t, _ = tbfs.build(600, 3000)
    level, depth = tbfs.bfs(A_t, 3, "xla", device="cpu")
    np.testing.assert_array_equal(level, tbfs.bfs_ref(A_t, 3))
    assert level[3] == 0 and depth == level.max()
