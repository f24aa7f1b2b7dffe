"""The plus-times row fold in float64, K11's leaders-only wrapper on the
CPU, and the user-facing messages of what is not ported yet.

- `segment_reduce_sorted` sums float32 plus-times values in float64 and
  rounds once, so a hub row whose float32 running sum misses the
  oracle's rtol 2e-4 comes out as the exact sum rounded once;
- `_group_reduce_pass` on a CPU tensor returns the plain version's
  leaders, `_group_reduce_plain(...)[:, ::W]`, in every strategy;
- the messages name the missing feature, not a ROADMAP queue number,
  which changes whenever the ROADMAP is renumbered."""

import math
import re

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import ell as tell
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)


def _hub_row(seed=0, n=100_000):
    """n mixed-sign products whose large terms cancel: partial sums reach
    ~1e6 while the row's sum is ~5e2."""
    rng = np.random.default_rng(seed)
    m = n // 10
    big = (rng.standard_normal((n - m) // 2) * 1e4).astype(np.float32)
    small = rng.uniform(0.0, 0.1, n - 2 * big.size).astype(np.float32)
    vals = np.concatenate([big, -big, small])
    return vals[rng.permutation(vals.size)]


def _exact(vals):
    """The exact sum, rounded once to float32."""
    return np.float32(math.fsum(np.asarray(vals, np.float64)))


def test_segment_reduce_sorted_folds_float32_sums_in_float64():
    hub = _hub_row()
    rng = np.random.default_rng(1)
    short = rng.standard_normal(6).astype(np.float32)
    vals = np.concatenate([short[:3], hub, short[3:]])
    seg = np.concatenate([[0, 0, 2], np.full(hub.size, 3), [3, 5, 5]]).astype(np.int32)
    got = tsr.segment_reduce_sorted(torch.from_numpy(vals), torch.from_numpy(seg), 7,
                                    tsr.PLUS_TIMES, 0.0)
    assert got.dtype == torch.float32
    want = np.array([_exact(vals[seg == s]) for s in range(7)], np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the hub row's float32 running sum misses the oracle's tolerance
    running = np.cumsum(vals[seg == 3], dtype=np.float32)[-1]
    assert not np.isclose(running, want[3], rtol=2e-4, atol=1e-5)
    # a block of values (n, B) folds the same way, column by column
    block = np.stack([vals, -vals], axis=1)
    got2 = tsr.segment_reduce_sorted(torch.from_numpy(block), torch.from_numpy(seg), 7,
                                     tsr.PLUS_TIMES, 0.0)
    assert got2.dtype == torch.float32
    np.testing.assert_array_equal(got2.numpy(), np.stack([want, -want], axis=1))
    # the or-and counting ring takes the same fold (exact either way)
    ones = torch.ones(seg.size)
    cnt = tsr.segment_reduce_sorted(ones, torch.from_numpy(seg), 7, tsr.OR_AND_COUNTING, 0.0)
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(seg, minlength=7))


def test_ell_and_xla_kinds_fold_rows_in_float64():
    """`xla` folds a hub row of cancelling products to its exact sum
    rounded once; the ELL path folds its float32 chunk leaders (K11's
    output, in the reference's order) the same way."""
    hub = _hub_row(seed=2, n=20_000)
    n = hub.size
    A = CSR(2, n, np.array([0, n, n + 2], np.int64),
            np.concatenate([np.arange(n), [0, 1]]).astype(np.int32),
            np.concatenate([hub, [1.0, 2.0]]).astype(np.float32))
    x = torch.ones(n)
    y = spmv_tpu_torch.spmv("xla", A, x).numpy()
    np.testing.assert_array_equal(y, [_exact(hub), 3.0])
    rows = np.arange(2, dtype=np.int64)
    plan = tell.build_ell_plan(A, rows, 32).to("cpu")
    prod = tell.ell_products(A, x, tsr.PLUS_TIMES, plan)
    leaders = tell._group_reduce_pass(prod, W=32, strategy="tree", sr=tsr.PLUS_TIMES)
    leaders = leaders.reshape(-1)[:plan.n_vrows].numpy()
    vrow = plan.vrow_row.numpy()
    y = tell.ell_spmv(A, x, tsr.PLUS_TIMES, plan, "tree").numpy()
    np.testing.assert_array_equal(y, [_exact(leaders[vrow == r]) for r in rows])


@pytest.mark.parametrize("ring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("strategy", ["linear", "tree", "broadcast"])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 32, 128])
def test_group_reduce_pass_returns_plain_leaders(W, strategy, ring):
    sr = tsr.BUILTIN_SEMIRINGS[ring]
    rng = np.random.default_rng(W)
    prod = rng.standard_normal((3 * 8, 128)).astype(np.float32)
    if ring == "min_plus":
        prod[rng.random(prod.shape) < 0.1] = np.inf
    prod = torch.from_numpy(prod)
    got = tell._group_reduce_pass(prod, W=W, strategy=strategy, sr=sr)
    want = tell._group_reduce_plain(prod, W=W, strategy=strategy, sr=sr)[:, ::W]
    assert got.shape == (3 * 8, 128 // W) and got.is_contiguous()
    assert torch.equal(got, want)
    if strategy == "broadcast":  # the same leaders as the tree
        assert torch.equal(got, tell._group_reduce_pass(prod, W=W, strategy="tree", sr=sr))


def _bf16_on(kernel):
    """The value check K9-K13 and K11' run before they launch
    (`_cuda.value_code`, its default menu): float64 values, which the
    reference computes in only with JAX's x64 mode on, are not ported."""
    from spmv_tpu_torch.kernels import _cuda

    return lambda: _cuda.value_code(torch.zeros(1, dtype=torch.float64), kernel)


def _user_ring():
    ring = tsr.Semiring("sine_plus", lambda: 0.0, lambda a, x: torch.sin(a) * x,
                        lambda acc, v: acc + v)
    tsr.device_ring_code(ring)


MESSAGES = {
    "bfloat16": (_bf16_on("K9 (pgather)"),
                 r"K9 \(pgather\): torch.float64 values are not ported yet"),
    "user_ring": (_user_ring, "torch.sin is not on the menu of operations a "
                              "user-defined ring can take into a CUDA kernel"),
    "stream_dtype": (_bf16_on("K11' (local_ell)"),
                     r"K11' \(local_ell\): torch.float64 values are not ported"),
    "bf16_k10": (_bf16_on("K10 (merge_group)"), r"K10 \(merge_group\): torch.float64"),
    "bf16_k11": (_bf16_on("K11 (group_reduce)"), r"K11 \(group_reduce\): torch.float64"),
    "bf16_k12": (_bf16_on("K12 (dia)"), r"K12 \(dia\): torch.float64"),
    "bf16_k13": (_bf16_on("K13 (spmm_window)"), r"K13 \(spmm_window\): torch.float64"),
}


@pytest.mark.parametrize("case", list(MESSAGES))
def test_not_ported_messages_name_the_feature(case):
    run, pattern = MESSAGES[case]
    with pytest.raises(NotImplementedError, match=pattern) as err:
        run()
    text = str(err.value)
    assert not re.search(r"queue|item \d", text), text
