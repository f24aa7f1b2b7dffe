"""The port's bench path on the CPU: `spmv_tpu_torch.bench.harness` (the
counterpart of tests/test_harness.py, with `--device cpu`), its timing
and roofline against the reference's fields and byte model, the refusal
of `--device cuda` without a card, and `autotune_stream`'s structure."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from spmv_tpu.bench import harness as jharness
from spmv_tpu.utils import roofline as jroof
from spmv_tpu.utils import timing as jtiming
from spmv_tpu_torch.bench import harness
from spmv_tpu_torch.io.generate import banded_csr, random_csr
from spmv_tpu_torch.io.matrix_market import write_matrix_market
from spmv_tpu_torch.ops import tuning
from spmv_tpu_torch.utils import roofline, timing

SMALL = ["--device", "cpu", "--synthetic", "random", "--rows", "512", "--nnz", "4096",
         "--iters", "3"]


def test_harness_cli():
    results = harness.main(SMALL + ["xla", "merge"])
    assert [r.kind for r in results] == ["xla", "merge"]
    for r in results:
        assert r.kernel_s > 0 and r.total_s > 0 and r.iters == 3
        assert (r.nnz, r.n_rows) == (4096, 512)
        assert r.delta is not None and r.delta["max_abs"] < 1e-2
        assert r.delta["within_gate"] is True
        assert r.sol_fraction is not None and r.sol_fraction > 0


def test_harness_mtx_file(tmp_path):
    p = tmp_path / "m.mtx"
    write_matrix_market(p, banded_csr(200, 2, seed=0))
    results = harness.main([str(p), "xla", "stream", "--iters", "2", "--device", "cpu"])
    assert [r.kind for r in results] == ["xla", "stream"]
    assert all(r.nnz == 200 * 5 - 6 and r.delta["within_gate"] for r in results)


def test_harness_json_lines_and_trace(tmp_path, capsys):
    results = harness.main(SMALL + ["--json", "--trace", str(tmp_path), "csr_vector"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [json.loads(l) for l in lines] == [dataclasses.asdict(r) for r in results]
    assert (tmp_path / "csr_vector" / "trace.json").stat().st_size > 0


def test_harness_reports_a_failed_kind_and_goes_on(monkeypatch, capsys):
    real = harness.benchmark_spmv

    def flaky(kind, *a, **kw):
        if kind == "merge":
            raise RuntimeError("made to fail")
        return real(kind, *a, **kw)

    monkeypatch.setattr(harness, "benchmark_spmv", flaky)
    results = harness.main(SMALL + ["xla", "merge", "stream"])
    assert [r.kind for r in results] == ["xla", "stream"]
    err = capsys.readouterr().err
    assert "merge" in err and "FAILED" in err and "['merge']" in err


def test_harness_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        harness.main(["--synthetic", "random", "--rows", "512", "--nnz", "4096", "xla"])
    with pytest.raises(SystemExit, match="unknown kinds"):
        harness.main(SMALL + ["no_such_kind"])


def test_harness_keeps_the_reference_cli():
    assert harness.DEFAULT_KINDS == jharness.DEFAULT_KINDS
    for kind in ("banded", "random", "powerlaw", "kron"):
        ns = type("Args", (), dict(matrix=None, synthetic=kind, rows=4096, nnz=30000,
                                   alpha=1.5))
        got, want = harness.load_matrix(ns), jharness.load_matrix(ns)
        for f in ("Ap", "Aj", "Ax"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))


def test_bench_result_has_the_reference_fields():
    assert [(f.name, f.default) for f in dataclasses.fields(timing.BenchResult)] == \
        [(f.name, f.default) for f in dataclasses.fields(jtiming.BenchResult)]
    kw = dict(kind="xla", total_s=1e-3, kernel_s=2e-4, iters=5, nnz=100, n_rows=10,
              gnnz_per_s=0.5, gflops=1.0, gbytes_per_s=6.0, sol_fraction=0.25,
              delta={"mean_abs": 1e-7})
    assert timing.BenchResult(**kw).row() == jtiming.BenchResult(**kw).row()


@pytest.mark.parametrize("widths", [(4, 4, 4), (8, 4, 8), (2, 4, 4)])
def test_speed_of_light_has_the_reference_byte_model(widths):
    v, i, o = widths
    got = roofline.speed_of_light(1000, 100, v, i, o, device="cpu")
    want = jroof.speed_of_light(1000, 100, v, i, o)
    assert (got.bytes_per_nnz, got.bytes_per_row) == (want.bytes_per_nnz,
                                                     want.bytes_per_row)
    assert (got.chip, got.hbm_gbps) == ("cpu", jroof.CHIP_HBM_GBPS["cpu"])
    for mean in (0.5, 3.3, 40.0):
        assert got.sol_nnz_per_s(mean) == want.sol_nnz_per_s(mean)
        assert got.sol_gflops(mean) == want.sol_gflops(mean)


def test_benchmark_fn_on_the_cpu_is_the_host_clock():
    calls = []
    total, per = timing.benchmark_fn(lambda v: calls.append(v) or v, torch.ones(3),
                                     iters=4)
    assert total > 0 and per > 0
    assert len(calls) == 2 + 4 * timing._REPEATS  # warm-up, total, the windows


def test_autotune_stream_returns_the_reference_structure(tmp_path):
    A = random_csr(2048, 2048, 20000, seed=2)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(2048).astype(np.float32))
    best, results = tuning.autotune_stream(A, x, kappas=(12288,), iters=1, verbose=False)
    assert best == {"kappa": 12288, "scan_sbt": min(results, key=lambda r: r["kernel_s"])
                    ["scan_sbt"]}
    assert [(r["kappa"], r["scan_sbt"]) for r in results] == [(12288, 8), (12288, 16)]
    assert all(set(r) == {"kappa", "scan_sbt", "kernel_s"} and r["kernel_s"] > 0
               for r in results)
    path = tmp_path / "t" / "tables.json"
    tuning.save_table(best, str(path), chip="cpu")
    try:
        assert tuning.load_table(str(path), chip="cpu") == best
        assert tuning.policy_for().kappa == 12288
    finally:
        tuning.set_active(None)
    assert tuning.default_table_path().endswith("tuned_tables_torch.json")
