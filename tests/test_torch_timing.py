"""The port's chained-iteration timing (`spmv_tpu_torch.utils.timing`) on
the CPU: `_device_loop` makes its calls eagerly here, the same chain
that a CUDA graph captures on the card (tests/test_torch_cuda.py times
it there). It must run fn exactly n times in order on an x it leaves as
it is, bit for bit, and give a finite checksum where y[0] is a ring's
infinite identity; `timing_of` names the timing each kind gets."""

import numpy as np
import pytest
import torch

from spmv_tpu_torch import CSR, spmv
from spmv_tpu_torch.bench import harness
from spmv_tpu_torch.ops.semiring import MIN_PLUS
from spmv_tpu_torch.utils import timing


@pytest.mark.parametrize("n", [1, 4, 13])
def test_device_loop_runs_fn_n_times_in_order_on_an_unchanged_x(n):
    x0 = torch.tensor([-0.0, 1.5, -2.0, 3.0])
    seen = []

    def fn(v):
        seen.append(v.clone())
        return v * 2 + len(seen)  # y[0] of call i is i: the checksum is the order's sum

    run = timing._device_loop(fn, x0, n)
    assert seen == []  # nothing runs before run()
    s = run()
    assert len(seen) == n
    for v in seen:  # every call saw x0, bit for bit (x[0] is -0.0)
        assert torch.equal(v.view(torch.int32), x0.view(torch.int32))
    assert s.dtype == torch.float32 and float(s) == n * (n + 1) / 2
    # a second run starts its checksum at 0: calls n + 1 .. 2n
    assert float(run()) == n * (3 * n + 1) / 2 and len(seen) == 2 * n


def test_device_loop_checksum_is_finite_for_a_min_plus_identity_row():
    # row 0 is empty, so min-plus gives it the identity +inf
    A = CSR(3, 3, np.array([0, 0, 2, 3]), np.array([0, 2, 1]),
            np.array([1.0, 2.0, 3.0], np.float32))
    x0 = torch.tensor([0.5, 1.0, 2.0])
    fn = lambda v: spmv("xla", A, v, semiring=MIN_PLUS)
    assert torch.isinf(fn(x0)[0])
    s = timing._device_loop(fn, x0, 5)()
    assert torch.isfinite(s) and float(s) == 5 * 1.0 + 0.5  # inf counts 1, plus x[0]


def test_timing_of_names_the_timing():
    assert timing.timing_of("stream", "cpu") == "calls, host clock"
    assert timing.timing_of("cpu_naive", torch.device("cpu")) == "calls, host clock"
    assert timing.timing_of("cpu_navie", "cuda") == "calls, CUDA events"
    assert timing.timing_of("merge_tiled", "cuda") == "graph chain"


def test_harness_rows_say_how_they_were_timed(capsys):
    harness.main(["--device", "cpu", "--synthetic", "random", "--rows", "256", "--nnz",
                  "2048", "--iters", "2", "xla", "cpu_naive"])
    rows = [l for l in capsys.readouterr().out.splitlines() if "Gnnz/s" in l]
    assert len(rows) == 2 and all(l.endswith("[calls, host clock]") for l in rows)


@pytest.mark.parametrize("kind, device, want", [
    ("stream", "cuda", True), ("xla", torch.device("cuda", 0), True),
    ("cpu_naive", "cuda", False), ("cpu_navie", "cuda", False),
    ("stream", "cpu", False), ("cpu_naive", "cpu", False)])
def test_graph_timed_is_a_device_kind_on_the_card(kind, device, want):
    """The one rule behind benchmark_spmv's timing; timing_of labels it."""
    assert timing.graph_timed(kind, device) is want
    assert (timing.timing_of(kind, device) == "graph chain") is want


def test_benchmark_fn_by_calls_when_not_chained():
    calls = []
    total, per = timing.benchmark_fn(lambda v: calls.append(v) or v, torch.ones(3),
                                     iters=4, chained=False)
    assert total > 0 and per > 0 and len(calls) == 2 + 4 * timing._REPEATS
