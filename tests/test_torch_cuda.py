"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the 'stream' kind on a CUDA tensor against the oracle,
planned under the card's measured row of the tuning table (on an H100:
the `h100` row, and no "no measured tuning row" hint).
K1, K2, K3, K5, K6 and K8 also on made inputs: window sets, gather
tiles, split geometries, final tiles, row-id patterns. K1, K3, K4, K5, K7
and K8 also in bfloat16 and float16, and every ring-templated kernel under
user-defined rings (their own libraries).

K9-K13 and K11' also in bfloat16 and float16 against their plain
versions, each refusing a misaligned 2-byte tensor, and every path over
them with 2-byte values against the CPU.

Also K9, K11 and K12 against their plain versions, the direct ELL,
csr-vector, Light, DIA and baseline kinds against the oracle with their
launch counts, and CG through csr_vector -> dia; K10 in both branches and
K13 against their plain versions, `merge_tiled`, the merge kinds'
fallback and `spmm` against the oracles with their launch counts; K11'
against its plain version, and `distribute_csr` and `distribute_stream`
on a 4-shard local mesh on the card against the same call on the CPU.

The device loops: every device kind (the harness's default kinds, `dia`,
`dense`, `csr_vector`'s dia branch, the built-in rings) captured in a
CUDA graph after one eager call, its replay equal to the eager call (bit
for bit);
K14 against its plain version in float32, bfloat16 and float16 (one
launch a solve, two an `ilu0_apply` by the wrapper's count and by the
kernel nodes of an apply captured as a graph), on one CTA and on
clusters (a level wider than a cluster, W >= 9, row 0 in a wide level,
small models of the card), a cluster launch replayed in a graph, and
the chain probe; `cg` and `bicgstab` by
replayed graph against the same chunks run eagerly, each chunk graph's
K12 and K14 nodes counted; `benchmark_spmv` by graph chain. K15 against
its plain version bit for bit (random and early-closing Hessenbergs,
beta 0, m from 1 to 1000: its register bodies, the work area in shared
memory, and its wide body, the work area in a scratch), replayed in a
graph, its scratch rule, and its chain probe;
`gmres` by a graph a cycle against the same cycles run eagerly (the same
iters and x, the host's reads, K15, K12 and K14 nodes, no
`torch.linalg.lstsq`), and gmres(200) against the port's CPU run; the
multi-device matvec's replay against
`_matvec_eager`, and each y a fresh tensor; `graph_edges` on a graph
captured with a fork and a join over two streams, and the halo graph of
a one-rank NCCL process group, whose exchange has no path to or from the
self block (`exchange_order`).

K16, the row fold: bit for bit with its order in NumPy
(`tests/k16_model.py`) on every seg shape of the CPU tests, a hub row
past one look-back step and wide_row's 16.7M row ids, and with its plain
version (or within one ulp); one kernel node and one memset a B = 1
call, ten calls and a replay bit for bit; integer values through every
fold path (`xla`, `spmm` by auto, window and xla; int8 A with int32 or
int64 x gives int32 y, products and sums wrapping; narrower integers
through K13's and K16's int32 bodies) with the CPU port's dtype and
bits, or its raise.

Needs an NVIDIA GPU: every test here is marked `cuda` and skips without
one. It imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch.bench.harness import DEFAULT_KINDS
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import csr_vector as tcv
from spmv_tpu_torch.kernels import dia as tdia
from spmv_tpu_torch.kernels import ell as tell
from spmv_tpu_torch.kernels import fold as tfold
from spmv_tpu_torch.kernels import light as tlight
from spmv_tpu_torch.kernels import merge as tmerge
from spmv_tpu_torch.kernels import pgather as tpg
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import spmm as tspmm
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.examples.shortest_paths import random_graph, sssp
from spmv_tpu_torch.examples.solve_poisson import poisson2d
from spmv_tpu_torch.io.generate import random_csr
from spmv_tpu_torch.ops import tuning
from spmv_tpu_torch.ops.registry import plan_cached
from spmv_tpu_torch.ops.semiring import (MAX_TIMES, MIN_PLUS, OR_AND,
                                         OR_AND_COUNTING, PLUS_TIMES, Semiring)

# user-defined rings (tests/test_custom_semiring.py's), traced into CUDA
MAX_PLUS = Semiring("max_plus", lambda: float("-inf"), lambda a, x: a + x,
                    lambda acc, v: torch.maximum(acc, v))
SAT_ADD_TIMES = Semiring("sat_add_times", lambda: 0.0, lambda a, x: a * x,
                         lambda acc, v: torch.clamp(acc + v, max=4.0))

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["normal", "int"])
def case(request, cuda):
    A = power_law_csr(16384, 16384, 90000, seed=11)
    rng = np.random.default_rng(0)
    if request.param == "int":  # every sum exact in float32
        A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                               rng.integers(-4, 5, A.nnz).astype(np.float32))
        x = rng.integers(-4, 5, A.n_cols).astype(np.float32)
    else:
        x = rng.standard_normal(A.n_cols).astype(np.float32)
    plan = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    return request.param, A, plan.to(cuda), torch.from_numpy(x).to(cuda)


def _same(kind, got, want, exact=False):
    if exact or kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_kernels_match_plain_versions(case):
    kind, A, plan, x = case
    g, rd, sc = plan.gather, plan.reduce, plan.scan
    xnat = torch.nn.functional.pad(
        x, (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
    n_w = plan.x_rows_pad // 128
    before = tstream._xprep_pass.launches
    x2d = tstream._xprep_pass(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w)
    assert tstream._xprep_pass.launches == before + 1
    _same(kind, x2d, tstream._xprep_plain(xnat, g["g0"], g["xr1"], g["xr2"],
                                          g["xr3"], n_w=n_w), exact=True)

    kw = dict(sr=PLUS_TIMES, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
              out_rows=rd["out_rows"])
    args = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"])
    part = tstream._reduce_pass(*args, **kw)  # K2 for plus-times
    _same(kind, part, tstream._reduce_diff_plain(*args, **kw))

    data = part
    for p, d in zip(plan.shuffle.passes, plan.shuffle_dev):
        skw = dict(n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                   rows_per_g=p.out_rows // p.K)
        sargs = (data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"])
        out = tshuffle._run_split(*sargs, gaps=d["gaps"], **skw)
        _same(kind, out, tshuffle._split_plain(*sargs, **skw), exact=True)
        data = out.reshape(p.out_rows, 128)

    F_pad = sc["counts"].shape[0]
    prod = torch.nn.functional.pad(data, (0, 0, 0, F_pad * 128 - data.shape[0]))
    keys = ("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1", "q2s2",
            "q2s3", "valid2", "counts")
    _same(kind, tstream._scan_diff_pass(prod, *[sc[k] for k in keys], F_pad=F_pad),
          tstream._scan_diff_plain(prod, *[sc[k] for k in keys], F_pad=F_pad))
    torch.cuda.synchronize()


def test_stream_on_cuda_matches_oracle_and_counts_launches(case):
    kind, A, _, x = case
    y = spmv_tpu_torch.spmv("stream", A, x)  # builds and caches the plan
    counters = (tstream._xprep_pass, tstream._reduce_diff_pass,
                tshuffle._run_split, tstream._scan_diff_pass)
    for k in counters:
        k.launches = 0
    y = spmv_tpu_torch.spmv("stream", A, x)
    torch.cuda.synchronize()
    plan = spmv_tpu_torch.plan_cache(
        A, tstream.plan_cache_key(tuning.policy_for(4, tuning.detect_chip(x.device))), None)
    assert [k.launches for k in counters] == \
        [1, 1, len(plan.shuffle.passes), 1]
    assert y.device.type == "cuda" and torch.isfinite(y).all()
    y_ref = spmv_tpu_torch.spmv_ref(A, x.cpu().numpy(), y_dtype=np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=RTOL, atol=ATOL)
    y_cpu = spmv_tpu_torch.spmv("stream", A, x.cpu())
    _same(kind, y.cpu(), y_cpu)


def test_stream_on_cuda_plans_under_the_h100_row(cuda, capsys, monkeypatch):
    """The stream kind reads the card's measured row: its plan sits under
    the h100 row's key, and no "no measured tuning row" hint is printed."""
    if tuning.detect_chip(cuda) != "h100":
        pytest.skip(f"the card is {torch.cuda.get_device_name(0)}, not an H100")
    monkeypatch.setattr(tuning, "_warned_unmeasured", set())
    A = power_law_csr(16384, 16384, 90000, seed=11)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n_cols)
                         .astype(np.float32)).to(cuda)
    y = spmv_tpu_torch.spmv("stream", A, x)
    torch.cuda.synchronize()
    assert plan_cached(A, tstream.plan_cache_key(tuning.policy_for(4, "h100")))
    assert "no measured tuning row" not in capsys.readouterr().err
    assert not tuning._warned_unmeasured
    np.testing.assert_allclose(y.cpu().numpy(), spmv_tpu_torch.spmv_ref(
        A, x.cpu().numpy(), y_dtype=np.float64), rtol=RTOL, atol=ATOL)


def _empty_rows():
    # power-law rows in the top 20000 of 50000 rows with a 1024-row gap
    rng = np.random.default_rng(6)
    w = (1.0 + np.arange(20000)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(20000, size=80000, p=w / w.sum())
    rows = np.where((rows >= 5000) & (rows < 6024), rows + 1024, rows)
    cols = rng.integers(0, 50000, 80000)
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        50000, 50000, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(80000).astype(np.float32)))


def _hot_columns():
    # power-law rows, a tenth of the nnz on 4 columns (broadcast pages)
    rng = np.random.default_rng(21)
    n, nnz = 32768, 200000
    w = (1.0 + np.arange(n)) ** -1.5
    rng.shuffle(w)
    rows = rng.choice(n, size=nnz, p=w / w.sum())
    cols = np.where(rng.random(nnz) < 0.1, rng.integers(0, 4, nnz),
                    rng.integers(0, n, nnz))
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, rows.astype(np.int32), cols.astype(np.int32),
        rng.standard_normal(nnz).astype(np.float32)))


EDGE_CASES = {
    "empty_rows": (_empty_rows, {}),
    "hot_columns": (_hot_columns, {}),
    # the last shuffle pass pads past the scan's F_pad
    "shuffle_rows_past_scan": (
        lambda: power_law_csr(1 << 16, 1 << 16, 300000, seed=42), {"kappa": 2048}),
    "no_remap": (lambda: power_law_csr(16384, 16384, 60000, seed=12),
                 {"kappa": 8192, "remap": False}),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_stream_edge_cases_on_cuda(cuda, name):
    make, policy = EDGE_CASES[name]
    A = make()
    x = np.random.default_rng(1).standard_normal(A.n_cols).astype(np.float32)
    pol = tstream.StreamPolicy(**policy)
    y = tstream._stream_spmv(A, torch.from_numpy(x).to(cuda), PLUS_TIMES, pol)
    y_cpu = tstream._stream_spmv(A, torch.from_numpy(x), PLUS_TIMES, pol)
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=RTOL, atol=ATOL)


def test_stream_or_and_and_bands_on_cuda(cuda, monkeypatch):
    A = power_law_csr(1 << 16, 1 << 16, 120000, alpha=1.5, seed=1)
    rng = np.random.default_rng(3)
    x = np.where(rng.random(A.n_cols) < 0.7, 0.0,
                 rng.standard_normal(A.n_cols)).astype(np.float32)
    y = spmv_tpu_torch.spmv("stream", A, torch.from_numpy(x).to(cuda),
                            semiring=spmv_tpu_torch.OR_AND)
    np.testing.assert_array_equal(
        y.cpu().numpy(), spmv_tpu_torch.spmv_ref_semiring(A, x, spmv_tpu_torch.OR_AND))
    monkeypatch.setattr(tstream, "BAND_NNZ", 40000)
    yb = tstream._stream_spmv(A, torch.from_numpy(x).to(cuda), PLUS_TIMES,
                              tstream.StreamPolicy(kappa=4096))
    np.testing.assert_allclose(
        yb.cpu().numpy(), spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64),
        rtol=2e-4, atol=1e-4)


def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((1024, 128), device=cuda)
    g0 = torch.zeros(8, dtype=torch.int32, device=cuda)
    r = torch.zeros((1024, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        tstream._xprep_pass(x, g0.long(), r, r, r, n_w=8)
    with pytest.raises(ValueError, match="on cpu"):
        tstream._xprep_pass(x, g0.cpu(), r, r, r, n_w=8)
    with pytest.raises(ValueError, match="contiguous"):
        tstream._xprep_pass(x, g0, r.t().contiguous().t(), r, r, n_w=8)


# --- the generic-ring kernels K3, K4, K7, K8 and the no-reduction branch

RINGS = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS,
         "max_times": MAX_TIMES, "or_and_counting": OR_AND_COUNTING}
ALL = [(r, k) for r in RINGS for k in ("normal", "int")]
COUNTERS = ("_xprep_pass", "_reduce_diff_pass", "_reduce_roll_pass",
            "_gather_pass", "_gather_split_pass", "_scan_diff_pass",
            "_scan_roll_pass")


def _values(A, kind, seed):
    """(A, x) with normal or integer-valued data, made from a seed."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                               rng.integers(-4, 5, A.nnz).astype(np.float32))
        return A, rng.integers(-4, 5, A.n_cols).astype(np.float32)
    return A, rng.standard_normal(A.n_cols).astype(np.float32)


def _exact(ring, kind):
    return kind == "int" or ring in ("min_plus", "max_times")


@pytest.fixture(scope="module")
def random_plan(cuda):
    A = random_csr(20000, 30000, 150000, seed=1)
    plan = tstream.build_stream_plan(A, tstream.StreamPolicy())
    assert plan.reduce is None
    return A, plan, plan.to(cuda)


@pytest.mark.parametrize("ring,kind", ALL)
def test_gather_kernels_match_plain_versions(random_plan, ring, kind):
    """K4 and K3 against their plain versions, and K3 == K4 + one K5 pass
    bit for bit, on a no-reduction plan."""
    A0, plan, dplan = random_plan
    A, x = _values(A0, kind, 3)
    dev = dplan.gather["q"].device
    sr = RINGS[ring]
    g = dplan.gather
    ax = torch.from_numpy(np.asarray(tstream.build_stream_plan(
        A, tstream.StreamPolicy()).gather["Ax"])).to(dev)
    x2d = tstream._x_table(dplan, torch.from_numpy(x).to(dev), A.n_cols)
    gt = plan.n_gather_tiles
    before = tstream._gather_pass.launches
    prod = tstream._gather_pass(x2d, ax, g["q"], g["xb"], sr=sr, n_tiles=gt)
    assert tstream._gather_pass.launches == before + 1
    assert torch.equal(prod, tstream._gather_plain(x2d, ax, g["q"], g["xb"],
                                                   sr=sr, n_tiles=gt))
    p0, d0 = plan.shuffle.passes[0], dplan.shuffle_dev[0]
    kw = dict(sr=sr, sbt=8, n_tiles=gt, K=p0.K, Q=p0.Q,
              rows_per_g=p0.out_rows // p0.K)
    args = (x2d, ax, g["q"], g["xb"], d0["s1"], d0["s2"], d0["s3"],
            d0["starts"], d0["pos"])
    fused = tstream._gather_split_pass(*args, gaps=d0["gaps"], **kw)
    assert torch.equal(fused, tstream._gather_split_plain(*args, **kw))
    ident = float(sr.identity_for(np.float32))
    split = tshuffle._run_split(
        prod, d0["s1"], d0["s2"], d0["s3"], d0["starts"], d0["pos"],
        n_steps=p0.n_steps, sbt=8, K=p0.K, Q=p0.Q,
        rows_per_g=p0.out_rows // p0.K, gaps=d0["gaps"], fill=ident)
    assert torch.equal(fused, split)
    if d0["gaps"].numel():
        assert (fused[:, d0["gaps"]] == ident).all()
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def reduce_plan(cuda):
    A = power_law_csr(16384, 16384, 90000, seed=11)
    plan = tstream.build_stream_plan(A, tstream.StreamPolicy(kappa=12288))
    assert plan.reduce is not None
    return A, plan, plan.to(cuda)


@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
def test_reduce_roll_matches_plain_version(reduce_plan, ring):
    """K7 (min, max and or rings: exact) on a power-law plan."""
    A, plan, dplan = reduce_plan
    sr = {"or_and": OR_AND, **RINGS}[ring]
    dev = dplan.gather["q"].device
    g, rd = dplan.gather, dplan.reduce
    xn = np.random.default_rng(4).standard_normal(A.n_cols).astype(np.float32)
    if ring == "or_and":
        xn[np.random.default_rng(5).random(A.n_cols) < 0.7] = 0.0
    x = torch.from_numpy(xn).to(dev)
    x2d = tstream._x_table(dplan, x, A.n_cols)
    kw = dict(sr=sr, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
              out_rows=rd["out_rows"])
    args = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"],
            rd["rs"])
    before = tstream._reduce_roll_pass.launches
    got = tstream._reduce_pass(*args, **kw)
    assert tstream._reduce_roll_pass.launches == before + 1
    assert torch.equal(got, tstream._reduce_roll_plain(*args, **kw))
    ident = float(sr.identity_for(np.float32))
    assert (got[plan.n_gather_tiles * rd["Qp"]:] == ident).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("ring,kind", [("min_plus", "normal"),
                                       ("max_times", "normal"),
                                       ("plus_times", "normal"),
                                       ("plus_times", "int")])
def test_scan_roll_matches_plain_version(random_plan, ring, kind):
    """K8 on random products: exact for min and max and for integer
    data; plus-times ("roll") sums in float32 in another order."""
    _, plan, dplan = random_plan
    sc = dplan.scan
    F_pad = sc["counts"].shape[0]
    rng = np.random.default_rng(5)
    prod = (rng.integers(-4, 5, (F_pad * 128, 128)) if kind == "int"
            else rng.standard_normal((F_pad * 128, 128))).astype(np.float32)
    prod = torch.from_numpy(prod).to(sc["relid"].device)
    keys = ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "valid2")
    args = (prod, *[sc[k] for k in keys])
    sr = RINGS[ring]
    before = tstream._scan_roll_pass.launches
    got = tstream._scan_pass(*args[:8], sc["q2s1"], sc["q2s2"], sc["q2s3"],
                             sc["valid2"], sc["counts"], sr=sr, F_pad=F_pad,
                             strategy="roll")
    assert tstream._scan_roll_pass.launches == before + 1
    want = tstream._scan_roll_plain(*args, sr=sr, F_pad=F_pad)
    if _exact(ring, kind):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


# --- K5 and K3 on made geometries: each tile's route and values staged in
# shared memory (csrc/split_tile.cuh), a tile split over several CTAs when
# a pass has fewer tiles than the card has SMs

# (n_steps, sbt, K, Q, output blocks no step writes: gap rows)
SPLIT_GEOMETRIES = {
    "q8": (4, 8, 15, 8, 0),
    "q16": (4, 8, 8, 16, 0),
    "overlapping_windows": (8, 8, 10, 16, 0),  # K*Q = 160 > 128, as bench pass 2
    "single_step": (1, 8, 24, 8, 0),
    "gap_rows": (3, 8, 6, 16, 2),
    "one_tile_a_step": (5, 1, 3, 16, 1),
    "one_group": (2, 8, 1, 16, 0),
    "more_tiles_than_sms": (20, 8, 24, 8, 0),  # one CTA per tile
}


def _split_pass(dev, name, seed=0):
    """A pass of geometry `name`: random route bytes, window starts in
    [0, 128 - Q] with a fifth of them at 128 - Q, pos a random choice of
    the output blocks; its (s1, s2, s3, starts, pos), keywords and gaps."""
    n_steps, sbt, K, Q, extra = SPLIT_GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    rows = n_steps * sbt * 128
    stages = [rng.integers(0, 128, (rows, 128)).astype(np.uint8) for _ in range(3)]
    starts = rng.integers(0, 129 - Q, (n_steps, sbt * K)).astype(np.int32)
    starts[rng.random(starts.shape) < 0.2] = 128 - Q
    table = np.zeros((-(-n_steps // 8) * 8, -(-(sbt * K) // 128) * 128), np.int32)
    table[:n_steps, :sbt * K] = starts
    pos = rng.permutation(n_steps + extra)[:n_steps].astype(np.int32)
    kw = dict(sbt=sbt, K=K, Q=Q, rows_per_g=(n_steps + extra) * sbt * Q)
    gaps = tshuffle.gap_rows(pos, sbt, Q, kw["rows_per_g"])
    assert (gaps.size > 0) == (extra > 0)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in (*stages, table, pos))
    return arrays, kw, torch.from_numpy(gaps).to(dev)


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", list(SPLIT_GEOMETRIES))
@pytest.mark.parametrize("fill", [0.0, float("inf")])
def test_split_matches_plain_version_on_made_geometries(cuda, name, fill):
    """K5 bit for bit against its plain version, ±inf in the data."""
    arrays, kw, gaps = _split_pass(cuda, name)
    n_steps = arrays[4].numel()
    data = np.random.default_rng(1).standard_normal(
        (n_steps * kw["sbt"] * 128, 128)).astype(np.float32)
    data[np.random.default_rng(2).random(data.shape) < 0.05] = np.inf
    data[np.random.default_rng(3).random(data.shape) < 0.05] = -np.inf
    data = torch.from_numpy(data).to(cuda)
    before = tshuffle._run_split.launches
    got = tshuffle._run_split(data, *arrays, n_steps=n_steps, gaps=gaps, fill=fill, **kw)
    assert tshuffle._run_split.launches == before + 1
    _bits_equal(got, tshuffle._split_plain(data, *arrays, n_steps=n_steps, fill=fill, **kw))
    if gaps.numel():
        assert (got[:, gaps] == fill).all()
    torch.cuda.synchronize()


def test_split_refuses_a_misaligned_tensor(cuda):
    arrays, kw, gaps = _split_pass(cuda, "q16")
    rows = arrays[4].numel() * kw["sbt"] * 128
    buf = torch.zeros(rows * 128 + 1, device=cuda)
    data = buf[1:].view(rows, 128)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="spmv_split: CUDA error"):
        tshuffle._run_split(data, *arrays, n_steps=arrays[4].numel(), gaps=gaps, **kw)


def _bits_equal_nan(a, b):
    """Equal bits, NaN matching NaN whatever its payload."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan)
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


# --- K1 on made window sets: split_tile.cuh's body in its whole-tile mode,
# a launch of fewer windows than SMs split over several CTAs a window

@pytest.mark.parametrize("n_w", [1, 72, 131, 133, 300])
def test_xprep_matches_plain_version_on_made_windows(cuda, n_w):
    """K1 bit for bit against its plain version: ±inf and NaNs of several
    payloads in x, a window at the end of the natural x table, repeated
    and overlapping windows, random route bytes."""
    rng = np.random.default_rng(n_w)
    rows = 128 + 24 * n_w
    xnat = rng.standard_normal((rows, 128)).astype(np.float32)
    u = rng.random(xnat.shape)
    xnat[u < 0.03] = np.inf
    xnat[(u >= 0.03) & (u < 0.06)] = -np.inf
    nan = (u >= 0.06) & (u < 0.09)
    xnat.view(np.int32)[nan] = rng.choice(np.array([0x7FC00000, 0x7FC00123, -0x400000],
                                                   np.int32), int(nan.sum()))
    g0 = rng.integers(0, rows - 127, n_w).astype(np.int32)
    g0[-1] = rows - 128  # the last window ends at the table's end
    if n_w >= 4:
        g0[0] = g0[-1]  # repeated
        g0[2] = g0[1] + 5  # overlapping
    xr = [rng.integers(0, 128, (n_w * 128, 128)).astype(np.uint8) for _ in range(3)]
    args = [torch.from_numpy(a).to(cuda) for a in (xnat, g0, *xr)]
    before = tstream._xprep_pass.launches
    got = tstream._xprep_pass(*args, n_w=n_w)
    assert tstream._xprep_pass.launches == before + 1
    _bits_equal(got, tstream._xprep_plain(*args, n_w=n_w))
    torch.cuda.synchronize()


def test_xprep_refuses_a_misaligned_tensor(cuda):
    buf = torch.zeros(256 * 128 + 1, device=cuda)
    xnat = buf[1:].view(256, 128)  # contiguous, 4 bytes past a 16-byte boundary
    g0 = torch.zeros(1, dtype=torch.int32, device=cuda)
    r = torch.zeros((128, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="spmv_xprep: CUDA error"):
        tstream._xprep_pass(xnat, g0, r, r, r, n_w=1)


# --- K8 on made row-id patterns: 512 threads of 32 positions a tile, two
# tiles per SM; segment starts on and beside the thread (32) and warp
# (1024) boundaries

K8_PATTERNS = ["one_segment", "every_position", "threads_0", "threads_-1", "threads_1",
               "warps_0", "warps_-1", "warps_1", "all_junk", "no_valid", "runs"]


def _k8_relid(name, rng):
    """One tile's relid: keys that never decrease, junk flagged by +16384;
    and whether the tile has valid y slots."""
    p = np.arange(16384)
    junk = np.zeros(16384, bool)
    if name == "one_segment":
        key = np.full(16384, 3)
        junk[0] = junk[16100:] = True
    elif name == "every_position":
        key = p
    elif name == "all_junk":
        key, junk[:] = np.full(16384, 9), True
    elif name in ("runs", "no_valid"):  # runs of 1-40, junk at 0 and the tail
        ends = np.cumsum(rng.integers(1, 40, 16384))
        starts = np.zeros(16384, bool)
        starts[ends[ends < 16384]] = True
        key = np.cumsum(starts)
        junk[0] = junk[int(rng.integers(12000, 16384)):] = True
    else:
        where, shift = name.rsplit("_", 1)
        width = {"threads": 32, "warps": 1024}[where]
        key = np.cumsum((p - int(shift)) % width == 0)
    return (key + 16384 * junk).astype(np.int16), name != "no_valid"


@pytest.fixture(scope="module")
def k8_tiles(cuda):
    """F tiles of made inputs (tile f takes pattern f % 11), made once per
    F: random route bytes, valid2 at random, integer-valued products with
    ±inf (every ring's sums then exact) and normal ones."""
    made = {}

    def make(F):
        if F not in made:
            rng = np.random.default_rng(F)
            pats = [_k8_relid(n, rng) for n in K8_PATTERNS]
            pick = np.arange(F) % len(pats)
            relid = np.stack([pats[i][0] for i in pick]).reshape(F * 128, 128)
            valid2 = (rng.random((F, 16384)) < 0.6) & np.array(
                [pats[i][1] for i in pick])[:, None]
            routes = [rng.integers(0, 128, (F * 128, 128)).astype(np.uint8) for _ in range(6)]
            ints = rng.integers(-4, 5, (F * 128, 128)).astype(np.float32)
            normal = rng.standard_normal((F * 128, 128)).astype(np.float32)
            for v in (ints, normal):
                u = rng.random(v.shape)
                v[u < 0.03] = np.inf
                v[(u >= 0.03) & (u < 0.06)] = -np.inf
            made[F] = {k: torch.from_numpy(a).to(cuda) for k, a in (
                ("int", ints), ("normal", normal), ("relid", relid),
                ("valid2", valid2.astype(np.int8).reshape(F * 128, 128)),
                *zip(("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3"), routes))}
        return made[F]
    return make


@pytest.mark.parametrize("F", [1, 80, 132, 352, 600])
@pytest.mark.parametrize("ring,data", [(r, "int") for r in ("plus_times", "min_plus",
                                                             "max_times", "or_and_counting",
                                                             "or_and")]
                         + [("plus_times", "normal")])
def test_scan_roll_matches_plain_version_on_made_patterns(k8_tiles, F, ring, data):
    """K8 against its plain version, bit for bit (NaN as NaN) on
    integer-valued products in every built-in ring, within rtol 2e-4 /
    atol 1e-5 for plus-times on normal ones."""
    t = k8_tiles(F)
    sr = ALL_RINGS[ring]
    args = (t[data], *[t[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2",
                                      "r2s3", "valid2")])
    before = tstream._scan_roll_pass.launches
    got = tstream._scan_roll_pass(*args, sr=sr, F_pad=F)
    assert tstream._scan_roll_pass.launches == before + 1
    want = tstream._scan_roll_plain(*args, sr=sr, F_pad=F)
    if data == "int":
        _bits_equal_nan(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    ident = float(sr.identity_for(np.float32))
    assert (got[t["valid2"] == 0] == ident).all()
    torch.cuda.synchronize()


def test_scan_roll_refuses_a_misaligned_tensor(cuda, k8_tiles):
    t = k8_tiles(1)
    buf = torch.zeros(16384 + 1, device=cuda)
    prod = buf[1:].view(128, 128)
    args = [t[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "valid2")]
    with pytest.raises(RuntimeError, match="spmv_scan_roll: CUDA error"):
        tstream._scan_roll_pass(prod, *args, sr=MIN_PLUS, F_pad=1)


ALL_RINGS = {**RINGS, "or_and": OR_AND}


# --- K2 on made geometries: split_tile.cuh's body with a row scan in the
# product load and a predecessor subtraction in the epilogue; a launch of
# fewer tiles than SMs splits each tile's Qp rows over several CTAs

def _k2_inputs(dev, n_tiles, Qp, flags, data, seed=0):
    """Gather tiles of made inputs: 7 x windows with rare ±inf and NaN
    and a fifth zeros, q with a fifth junk and every 7th tile all junk,
    random route bytes, c3's bit 7 at column 0 of every row ("lane0"),
    nowhere ("none") or at random ("random")."""
    rng = np.random.default_rng(seed)
    n_win, rows = 7, n_tiles * 128
    ints = data == "int"
    x2d = (rng.integers(-4, 5, (n_win * 128, 128)) if ints
           else rng.standard_normal((n_win * 128, 128))).astype(np.float32)
    u = rng.random(x2d.shape)
    x2d[u < 0.2] = 0.0
    x2d[(u >= 0.2) & (u < 0.202)] = np.inf
    x2d[(u >= 0.202) & (u < 0.204)] = -np.inf
    x2d[(u >= 0.204) & (u < 0.206)] = np.nan
    ax = (rng.integers(-4, 5, (rows, 128)) if ints
          else rng.standard_normal((rows, 128))).astype(np.float32)
    q = rng.integers(0, 128, (rows, 128)).astype(np.int8)
    q[rng.random(q.shape) < 0.2] = -1
    q.reshape(n_tiles, 128, 128)[::7] = -1
    xb = rng.integers(0, n_win, n_tiles).astype(np.int32)
    c1, c2, c3 = (rng.integers(0, 128, (rows, 128)).astype(np.uint8) for _ in range(3))
    if flags == "lane0":
        c3[:, 0] |= 128
    elif flags == "random":
        c3[rng.random(c3.shape) < 0.3] |= 128
    return tuple(torch.from_numpy(a).to(dev) for a in (x2d, ax, q, xb, c1, c2, c3))


def _same_nan(got, want, exact):
    """NaN where the plain version has NaN; elsewhere equal values, or
    within rtol 2e-4 / atol 1e-5."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if exact:
        assert torch.equal(got[~nan], want[~nan])
    else:
        torch.testing.assert_close(got[~nan], want[~nan], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_tiles", [1, 80, 131, 133, 300])
@pytest.mark.parametrize("Qp", [1, 17, 64])
@pytest.mark.parametrize("flags", ["lane0", "none", "random"])
@pytest.mark.parametrize("ring,data", [("plus_times", "int"), ("plus_times", "normal"),
                                       ("or_and_counting", "normal")])
def test_reduce_diff_matches_plain_version_on_made_geometries(cuda, n_tiles, Qp, flags,
                                                             ring, data):
    """K2 against its plain version: bit for bit on integer-valued data
    and for the or-and counting ring, within rtol on normal data; NaN
    where the plain version has NaN; rows past n_tiles*Qp zero."""
    args = _k2_inputs(cuda, n_tiles, Qp, flags, data, seed=n_tiles + Qp)
    sr = RINGS[ring]
    kw = dict(sr=sr, n_tiles=n_tiles, Qp=Qp, out_rows=n_tiles * Qp + 8)
    before = tstream._reduce_diff_pass.launches
    got = tstream._reduce_diff_pass(*args, **kw)
    assert tstream._reduce_diff_pass.launches == before + 1
    want = tstream._reduce_diff_plain(*args, **kw)
    _same_nan(got, want, exact=data == "int" or sr is OR_AND_COUNTING)
    assert (got[n_tiles * Qp:] == 0).all()
    assert torch.isfinite(got).float().mean() > 0.5
    torch.cuda.synchronize()


def test_reduce_diff_refuses_a_misaligned_tensor(cuda):
    x2d, ax, q, xb, c1, c2, c3 = _k2_inputs(cuda, 1, 64, "none", "int")
    buf = torch.zeros(ax.numel() + 1, device=cuda)
    ax = buf[1:].view(128, 128)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="spmv_reduce: CUDA error"):
        tstream._reduce_diff_pass(x2d, ax, q, xb, c1, c2, c3, sr=PLUS_TIMES,
                                  n_tiles=1, Qp=64, out_rows=64)


# --- K7 on made geometries: split_tile.cuh's body with a segmented row
# scan on the run-start flags in the product load and c3's flag bit masked
# in the epilogue; one CTA per tile, in launches of fewer and of more tiles
# than SMs

def _k7_inputs(dev, n_tiles, Qp, flags, seed=0):
    """K2's made gather tiles (normal data with ±inf, NaN and zeros in x,
    c3's bit 7 at random) with ±inf, NaN and zeros in Ax too, a fifth of
    the slots junk and every 7th tile from tile 3 on all junk (tile 0
    holds data, so a 1-tile launch is not all identity), and run starts
    at every lane ("every"), at lane 0 of every row ("lane0") or at
    random ("random")."""
    x2d, ax, q, xb, c1, c2, c3 = _k2_inputs(dev, n_tiles, Qp, "random", "normal", seed)
    rng = np.random.default_rng(seed + 1)
    qn = rng.integers(0, 128, tuple(q.shape)).astype(np.int8)
    qn[rng.random(qn.shape) < 0.2] = -1
    qn.reshape(n_tiles, 128, 128)[3::7] = -1
    q = torch.from_numpy(qn).to(dev)
    u = torch.from_numpy(rng.random(tuple(ax.shape))).to(dev)
    ax = ax.clone()
    ax[u < 0.1] = 0.0
    ax[(u >= 0.1) & (u < 0.11)] = float("inf")
    ax[(u >= 0.11) & (u < 0.12)] = float("-inf")
    ax[(u >= 0.12) & (u < 0.13)] = float("nan")
    rows = n_tiles * 128
    rs = {"every": np.ones((rows, 128)), "lane0": np.tile(np.eye(1, 128), (rows, 1)),
          "random": rng.random((rows, 128)) < 0.25}[flags].astype(np.int8)
    return x2d, ax, q, xb, c1, c2, c3, torch.from_numpy(rs).to(dev)


@pytest.mark.parametrize("n_tiles", [1, 80, 300])
@pytest.mark.parametrize("Qp", [1, 17, 64])
@pytest.mark.parametrize("flags", ["every", "lane0", "random"])
@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
def test_reduce_roll_matches_plain_version_on_made_geometries(cuda, n_tiles, Qp, flags,
                                                             ring):
    """K7 against its plain version, exact in its three rings: NaN where
    the plain version has NaN, equal values elsewhere; rows past
    n_tiles*Qp the identity."""
    args = _k7_inputs(cuda, n_tiles, Qp, flags, seed=n_tiles + Qp)
    sr = {"or_and": OR_AND, **RINGS}[ring]
    kw = dict(sr=sr, n_tiles=n_tiles, Qp=Qp, out_rows=n_tiles * Qp + 8)
    before = tstream._reduce_roll_pass.launches
    got = tstream._reduce_pass(*args, **kw)
    assert tstream._reduce_roll_pass.launches == before + 1
    _same_nan(got, tstream._reduce_roll_plain(*args, **kw), exact=True)
    ident = float(sr.identity_for(np.float32))
    assert (got[n_tiles * Qp:] == ident).all()
    assert (got[:n_tiles * Qp] != ident).any()
    torch.cuda.synchronize()


def test_reduce_roll_refuses_a_misaligned_tensor_and_the_sum_rings(cuda):
    x2d, ax, q, xb, c1, c2, c3, rs = _k7_inputs(cuda, 1, 64, "random")
    kw = dict(n_tiles=1, Qp=64, out_rows=64)
    buf = torch.zeros(rs.numel() + 1, dtype=torch.int8, device=cuda)
    bad = buf[1:].view(128, 128)  # contiguous, 1 byte past a 16-byte boundary
    with pytest.raises(RuntimeError, match="spmv_reduce_roll: CUDA error"):
        tstream._reduce_roll_pass(x2d, ax, q, xb, c1, c2, c3, bad, sr=MIN_PLUS, **kw)
    # the sum rings, which `_reduce_pass` gives K2 on float32, run on K7
    # too (bfloat16 and float16 plus-times take it), within rtol
    for sr in (PLUS_TIMES, OR_AND_COUNTING):
        got = tstream._reduce_roll_pass(x2d, ax, q, xb, c1, c2, c3, rs, sr=sr, **kw)
        _same_nan(got, tstream._reduce_roll_plain(x2d, ax, q, xb, c1, c2, c3, rs,
                                                  sr=sr, **kw), exact=False)


# --- K6 on made final tiles: products and routes staged in shared memory,
# a float64 scan of 1024 threads of 16 positions

K6_COUNTS = [0, 1, 127, 128, 16383]


def _k6_inputs(dev, F, valid, data, seed=0):
    """F final tiles: random route bytes, counts cycling through
    K6_COUNTS, valid2 all 0, all 1 or at random, integer-valued or normal
    products."""
    rng = np.random.default_rng(seed)
    rows = F * 128
    prod = (rng.integers(-4, 5, (rows, 128)) if data == "int"
            else rng.standard_normal((rows, 128))).astype(np.float32)
    routes = [rng.integers(0, 128, (rows, 128)).astype(np.uint8) for _ in range(9)]
    valid2 = {"all0": np.zeros((rows, 128)), "all1": np.ones((rows, 128)),
              "random": rng.random((rows, 128)) < 0.6}[valid].astype(np.int8)
    counts = np.array([K6_COUNTS[f % len(K6_COUNTS)] for f in range(F)], np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (prod, *routes, valid2, counts))


@pytest.mark.parametrize("F", [1, 48, 80, 133, 300])
@pytest.mark.parametrize("valid", ["all0", "all1", "random"])
@pytest.mark.parametrize("data", ["int", "normal"])
def test_scan_diff_matches_plain_version_on_made_tiles(cuda, F, valid, data):
    """K6 against its plain version: bit for bit on integer-valued
    products, within rtol on normal ones; 0 wherever valid2 is 0."""
    args = _k6_inputs(cuda, F, valid, data, seed=F)
    before = tstream._scan_diff_pass.launches
    got = tstream._scan_diff_pass(*args, F_pad=F)
    assert tstream._scan_diff_pass.launches == before + 1
    want = tstream._scan_diff_plain(*args, F_pad=F)
    if data == "int":
        _bits_equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (got[args[10] == 0] == 0).all()
    if valid == "all1" and F >= 5:
        assert (got != 0).any()
    torch.cuda.synchronize()


def test_scan_diff_refuses_a_misaligned_tensor(cuda):
    args = list(_k6_inputs(cuda, 1, "all1", "int"))
    buf = torch.zeros(16384 + 1, device=cuda)
    args[0] = buf[1:].view(128, 128)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="spmv_scan_diff: CUDA error"):
        tstream._scan_diff_pass(*args, F_pad=1)


@pytest.mark.parametrize("name", list(SPLIT_GEOMETRIES))
@pytest.mark.parametrize("ring", list(ALL_RINGS))
def test_gather_split_matches_plain_version_on_made_geometries(cuda, name, ring):
    """K3 bit for bit against its plain version and against K4 + one K5
    pass, in every built-in ring: junk slots (q < 0), ±inf and zeros in
    x, x windows chosen at random."""
    arrays, kw, gaps = _split_pass(cuda, name, seed=4)
    n_tiles = arrays[4].numel() * kw["sbt"]
    rng = np.random.default_rng(5)
    n_win = 7
    x2d = rng.standard_normal((n_win * 128, 128)).astype(np.float32)
    u = rng.random(x2d.shape)
    x2d[u < 0.05] = np.inf
    x2d[(u >= 0.05) & (u < 0.1)] = -np.inf
    x2d[(u >= 0.1) & (u < 0.3)] = 0.0
    ax = rng.uniform(0.5, 2.0, (n_tiles * 128, 128)).astype(np.float32)
    ax *= np.where(rng.random(ax.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    q = rng.integers(0, 128, ax.shape).astype(np.int8)
    q[rng.random(ax.shape) < 0.2] = -1
    xb = rng.integers(0, n_win, n_tiles).astype(np.int32)
    sr = ALL_RINGS[ring]
    gather = tuple(torch.from_numpy(a).to(cuda) for a in (x2d, ax, q, xb))
    before = tstream._gather_split_pass.launches
    fused = tstream._gather_split_pass(*gather, *arrays, sr=sr, n_tiles=n_tiles,
                                       gaps=gaps, **kw)
    assert tstream._gather_split_pass.launches == before + 1
    _bits_equal(fused, tstream._gather_split_plain(*gather, *arrays, sr=sr,
                                                   n_tiles=n_tiles, **kw))
    prod = tstream._gather_pass(*gather, sr=sr, n_tiles=n_tiles)
    ident = float(sr.identity_for(np.float32))
    _bits_equal(fused, tshuffle._run_split(prod, *arrays, n_steps=arrays[4].numel(),
                                           gaps=gaps, fill=ident, **kw))
    torch.cuda.synchronize()


def _positive(A, seed):
    rng = np.random.default_rng(seed)
    A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                           rng.uniform(0.1, 1.0, A.nnz).astype(np.float32))
    return A, rng.uniform(0.1, 1.0, A.n_cols).astype(np.float32)


BRANCHES = {
    "no_reduction": lambda: random_csr(20000, 30000, 150000, seed=1),
    "reduction": lambda: power_law_csr(16384, 16384, 90000, seed=11),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
def test_stream_rings_on_cuda_match_oracle(cuda, branch, ring):
    """Each built-in ring end to end on both branches, exact against the
    semiring oracle (all-positive data: a junk 0 would change min-plus),
    with the kernels the reference picks for it."""
    A, x = _positive(BRANCHES[branch](), 7)
    sr = {"or_and": OR_AND, **RINGS}[ring]
    if ring == "or_and":
        x[np.random.default_rng(8).random(A.n_cols) < 0.7] = 0.0
    xt = torch.from_numpy(x).to(cuda)
    spmv_tpu_torch.spmv("stream", A, xt, semiring=sr)  # plan + upload
    for name in COUNTERS:
        getattr(tstream, name).launches = 0
    y = spmv_tpu_torch.spmv("stream", A, xt, semiring=sr)
    torch.cuda.synchronize()
    counts = {n: getattr(tstream, n).launches for n in COUNTERS}
    np.testing.assert_array_equal(
        y.cpu().numpy(), spmv_tpu_torch.spmv_ref_semiring(A, x, sr))
    reduce_body, scan_body = (("_reduce_diff_pass", "_scan_diff_pass")
                              if ring == "or_and" else
                              ("_reduce_roll_pass", "_scan_roll_pass"))
    want = {n: 0 for n in COUNTERS}
    want[scan_body] = 1
    if branch == "reduction":
        want.update({"_xprep_pass": 1, reduce_body: 1})
    else:
        want["_gather_split_pass"] = 1
    assert counts == want


def test_stream_plus_times_no_reduction_and_roll_on_cuda(cuda):
    A, x = _values(random_csr(20000, 30000, 150000, seed=1), "normal", 9)
    y_ref = spmv_tpu_torch.spmv_ref(A, x, y_dtype=np.float64)
    xt = torch.from_numpy(x).to(cuda)
    for strategy in ("auto", "roll"):
        pol = tstream.StreamPolicy(scan_strategy=strategy)
        y = tstream._stream_spmv(A, xt, PLUS_TIMES, pol)
        np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=RTOL, atol=ATOL)


def test_user_ring_raises_on_cuda(cuda):
    """A user-defined ring runs on the card through its own library
    (K1 -> K7 -> K5 -> K8 on this plan), and equals the CPU's plain
    versions bit for bit (a max ring); an off-menu op raises naming it.
    The name is kept from when every user ring raised here."""
    A = power_law_csr(8192, 8192, 50000, seed=15)
    x = np.random.default_rng(2).standard_normal(A.n_cols).astype(np.float32)
    before = tstream._reduce_roll_pass.launches, tstream._scan_roll_pass.launches
    y = spmv_tpu_torch.spmv("merge_genl", A, torch.from_numpy(x).to(cuda),
                            semiring=MAX_PLUS)
    torch.cuda.synchronize()
    assert (tstream._reduce_roll_pass.launches - before[0],
            tstream._scan_roll_pass.launches - before[1]) == (1, 1)
    np.testing.assert_array_equal(y.cpu().numpy(), spmv_tpu_torch.spmv(
        "merge_genl", A, torch.from_numpy(x), semiring=MAX_PLUS).numpy())
    sine = Semiring("sine", lambda: 0.0, lambda a, x: torch.sin(a) * x,
                    lambda acc, v: acc + v)
    with pytest.raises(NotImplementedError, match="torch.sin is not on the menu"):
        spmv_tpu_torch.spmv("merge_genl", A, torch.from_numpy(x).to(cuda),
                            semiring=sine)


def test_sssp_on_cuda_matches_cpu(cuda):
    A = random_graph(3000, seed=2)
    d, iters = sssp(A, 0, device=cuda)
    d_cpu, iters_cpu = sssp(A, 0, device="cpu")
    assert iters == iters_cpu and d.device.type == "cuda"
    assert torch.equal(d.cpu(), d_cpu)


# --- the direct tier (K9, K11), DIA (K12), the new kinds and CG

def _direct_counts():
    return (tpg._pgather_pass.launches, tell._group_reduce_pass.launches,
            tdia._dia_pass.launches)


@pytest.fixture(scope="module")
def ell_case(cuda):
    """A power-law matrix (long and empty rows) with its csr-vector ELL
    plan and its fine Light bins, on the card."""
    A = power_law_csr(20000, 40000, 150000, seed=5)
    x = np.random.default_rng(2).standard_normal(A.n_cols).astype(np.float32)
    plans = [tcv.csr_ell_plan(A, cuda)] + tlight.light_plans(
        A, tlight.FINE_BINS, "light_vec", cuda)
    assert all(p.pgather is not None for p in plans)
    return A, torch.from_numpy(x).to(cuda), plans


def test_pgather_matches_plain_version(ell_case):
    """K9 moves values only: bit for bit on every plan, and x[idx] with 0
    on dead slots."""
    A, x, plans = ell_case
    for plan in plans:
        pg = plan.pgather
        args = (x, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
        before = tpg._pgather_pass.launches
        got = tpg._pgather_pass(*args, C=pg.n_chunks, R=pg.rounds)
        assert tpg._pgather_pass.launches == before + 1
        assert torch.equal(got, tpg._pgather_plain(*args, C=pg.n_chunks, R=pg.rounds))
        flat = got.reshape(-1)[:pg.n].view(plan.aj.shape)
        want = torch.where(plan.valid, x[plan.aj.long()], torch.zeros_like(flat))
        assert torch.equal(flat, want)
    torch.cuda.synchronize()


def _bucketed_idx(n, n_cols, n_subs, seed):
    """An idx stream whose elements fall on only n_subs of the 128
    sublanes (idx mod 128), so each chunk's buckets spill into several
    rounds; 2% dead slots."""
    rng = np.random.default_rng(seed)
    subs = rng.choice(128, n_subs, replace=False)
    idx = rng.integers(0, n_cols // 128, n) * 128 + subs[rng.integers(0, n_subs, n)]
    idx[rng.random(n) < 0.02] = -1
    return idx


@pytest.mark.parametrize("plan_kind", ["rounds4", "partial_wave", "merge_y"])
def test_pgather_matches_plain_version_on_more_plans(cuda, merge_case, plan_kind):
    """K9 bit for bit on a plan of R_MAX rounds, on 265 chunks (one CTA
    per chunk and per SM: on a 132-SM card the last wave holds one CTA)
    and on a merge plan's phase-C gather (y assembly)."""
    if plan_kind == "merge_y":
        A, x, plans = merge_case
        pg = plans[tmerge.TUNED_POLICY].pgather_y
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            pg.n_w * 128 * 128).astype(np.float32)).to(cuda)
    else:
        n, n_cols, n_subs = ((3 * 16384, 160000, 40) if plan_kind == "rounds4"
                             else (265 * 16384 - 100, 1 << 20, 128))
        pg = tpg.build_paged_gather_plan(_bucketed_idx(n, n_cols, n_subs, 0), n_cols)
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(
            n_cols).astype(np.float32)).to(cuda)
        pg = pg.to(cuda)
    if plan_kind == "rounds4":
        assert pg.rounds == tpg.R_MAX
    if plan_kind == "partial_wave":
        assert pg.n_chunks == 265
    args = (x, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
    before = tpg._pgather_pass.launches
    got = tpg._pgather_pass(*args, C=pg.n_chunks, R=pg.rounds)
    assert tpg._pgather_pass.launches == before + 1
    assert torch.equal(got, tpg._pgather_plain(*args, C=pg.n_chunks, R=pg.rounds))
    torch.cuda.synchronize()


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
@pytest.mark.parametrize("strategy", ["linear", "tree", "broadcast"])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32, 64, 128])
def test_group_reduce_matches_plain_version(cuda, W, strategy, ring):
    """K11's leaders, (rows, 128/W), bit for bit against the plain
    version's leader lanes; broadcast gives the tree's leaders."""
    sr = RINGS[ring]
    rng = np.random.default_rng(W)
    prod = rng.standard_normal((64 * 8 + 24, 128)).astype(np.float32)
    if ring == "min_plus":
        prod[rng.random(prod.shape) < 0.1] = np.inf
    prod = torch.from_numpy(prod).to(cuda)
    before = tell._group_reduce_pass.launches
    got = tell._group_reduce_pass(prod, W=W, strategy=strategy, sr=sr)
    assert tell._group_reduce_pass.launches == before + 1
    want = tell._group_reduce_plain(prod, W=W, strategy=strategy, sr=sr)[:, ::W]
    torch.cuda.synchronize()
    assert got.shape == (prod.shape[0], 128 // W)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["csr_vector_ell", "xla"])
def test_row_fold_repeats_bit_for_bit(cuda, kind):
    """The plus-times row fold (K16) sums in float64 in a fixed order and
    rounds once: two calls on a matrix with hub rows give the same y bit
    for bit, and pass the oracle."""
    A = power_law_csr(30000, 30000, 400000, alpha=1.5, seed=13)
    assert np.diff(np.asarray(A.Ap)).max() > 10000  # hub rows
    xn = np.random.default_rng(8).standard_normal(A.n_cols).astype(np.float32)
    x = torch.from_numpy(xn).to(cuda)
    y1 = spmv_tpu_torch.spmv(kind, A, x)
    y2 = spmv_tpu_torch.spmv(kind, A, x)
    assert torch.equal(y1, y2)
    np.testing.assert_allclose(y1.cpu().numpy(),
                               spmv_tpu_torch.spmv_ref(A, xn, y_dtype=np.float64),
                               rtol=RTOL, atol=ATOL)


def _diag(n, offsets, seed):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(max(0, -d), min(n, n - d)) for d in offsets])
    cols = np.concatenate([np.arange(max(0, -d), min(n, n - d)) + d for d in offsets])
    keep = rng.random(rows.size) >= 0.1
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, rows[keep], cols[keep], rng.standard_normal(int(keep.sum())).astype(np.float32)))


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-9000, -88, -1, 0, 1, 88, 12000)])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_dia_matches_plain_version(cuda, offsets, ring):
    """K12 folds in the plain version's order with no FMA: bit for bit
    in every ring, past the reference's +-8000 halo too."""
    A = _diag(30000, offsets, seed=len(offsets))
    vals, valid, offs = tdia.device_dia_plan(A, cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.n_cols).astype(np.float32)).to(cuda)
    before = tdia._dia_pass.launches
    got = tdia._dia_pass(vals, valid, x, offs, sr=RINGS[ring])
    assert tdia._dia_pass.launches == before + 1
    assert torch.equal(got, tdia._dia_plain(vals, valid, x, offs, sr=RINGS[ring]))
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [1, 64])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_dia_edge_shapes_match_plain_version(cuda, D, ring):
    """n = 30001, not a multiple of 4 (K12's scalar plan loads and a
    short last thread), with 1 and 64 random diagonals reaching past
    either end: bit for bit."""
    rng = np.random.default_rng(D)
    n = 30001
    offs = np.sort(rng.choice(np.arange(-n + 1, n), D, replace=False)).astype(np.int32)
    cols = np.arange(n)[None, :] + offs[:, None]
    # as in every plan, no slot is valid where row + offset leaves the matrix
    valid = ((rng.random((D, n)) < 0.7) & (cols >= 0) & (cols < n)).astype(np.int8)
    vals = rng.standard_normal((D, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (vals, valid, x, offs)]
    before = tdia._dia_pass.launches
    got = tdia._dia_pass(*args, sr=RINGS[ring])
    assert tdia._dia_pass.launches == before + 1
    assert torch.equal(got, tdia._dia_plain(*args, sr=RINGS[ring]))
    torch.cuda.synchronize()


ELL_KINDS = {"csr_vector_ell": 1, "csr_vector_shfl_ell": 1, "csr_vector_shfl2_ell": 1,
             "csr_scalar": 1, "light_vec_ell": None, "light_warp_ell": None}


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_ell_kinds_on_cuda_match_oracle(ell_case, ring):
    """Each direct kind: one K9 and one K11 per plan (bin), nothing else,
    and the oracle (bit for bit outside plus-times)."""
    A, x, _ = ell_case
    sr = {"or_and": OR_AND, **RINGS}[ring]
    if ring == "or_and":
        x = torch.where(torch.rand(x.shape, device=x.device,
                                   generator=torch.Generator(x.device).manual_seed(1)) < 0.7,
                        torch.zeros_like(x), x)
    xn = x.cpu().numpy()
    bins = {"light_vec_ell": len(tlight.light_plans(A, tlight.FINE_BINS, "light_vec", x.device)),
            "light_warp_ell": len(tlight.light_plans(A, tlight.COARSE_BINS, "light_warp",
                                                     x.device))}
    for kind, nb in ELL_KINDS.items():
        nb = nb or bins[kind]
        spmv_tpu_torch.spmv(kind, A, x, semiring=sr)
        before = _direct_counts()
        y = spmv_tpu_torch.spmv(kind, A, x, semiring=sr)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_direct_counts(), before)] == [nb, nb, 0], kind
        if ring == "plus_times":
            np.testing.assert_allclose(
                y.cpu().numpy(), spmv_tpu_torch.spmv_ref(A, xn, y_dtype=np.float64),
                rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(
                y.cpu().numpy(), spmv_tpu_torch.spmv_ref_semiring(A, xn, sr))


@pytest.mark.parametrize("kind", ["dia", "csr_vector", "csr_vector_shfl", "csr_vector_shfl2"])
def test_banded_kinds_on_cuda_run_only_k12(cuda, kind):
    A = poisson2d(64)
    xn = np.random.default_rng(4).standard_normal(A.n_cols).astype(np.float32)
    x = torch.from_numpy(xn).to(cuda)
    for sr in (PLUS_TIMES, MIN_PLUS, MAX_TIMES):
        spmv_tpu_torch.spmv(kind, A, x, semiring=sr)
        for name in COUNTERS:
            getattr(tstream, name).launches = 0
        before = _direct_counts()
        y = spmv_tpu_torch.spmv(kind, A, x, semiring=sr)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_direct_counts(), before)] == [0, 0, 1]
        assert all(getattr(tstream, n).launches == 0 for n in COUNTERS)
        if sr is PLUS_TIMES:
            np.testing.assert_allclose(
                y.cpu().numpy(), spmv_tpu_torch.spmv_ref(A, xn, y_dtype=np.float64),
                rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(
                y.cpu().numpy(), spmv_tpu_torch.spmv_ref_semiring(A, xn, sr))


@pytest.mark.parametrize("kind", ["csr_vector", "csr_vector_shfl", "light_vec", "light_warp",
                                  "xla", "dense"])
def test_stream_and_baseline_kinds_on_cuda_match_oracle(cuda, kind):
    A = power_law_csr(4096, 4096, 30000, seed=11)
    xn = np.random.default_rng(6).standard_normal(A.n_cols).astype(np.float32)
    y = spmv_tpu_torch.spmv(kind, A, torch.from_numpy(xn).to(cuda))
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(),
                               spmv_tpu_torch.spmv_ref(A, xn, y_dtype=np.float64),
                               rtol=RTOL, atol=ATOL)


def test_cg_poisson_on_cuda(cuda):
    """CG through csr_vector -> dia on the card: its chunks replayed as
    one CUDA graph whose kernel nodes are CHUNK K12s and no other of the
    port's kernels, one K12 launched eagerly for the first residual (so
    1 + CHUNK per chunk run), the CPU run's iteration count within one,
    and a small true residual."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.examples.solve_poisson import true_relative_residual
    from spmv_tpu_torch.kernels import dia as tdia

    A = poisson2d(48)
    b = np.random.default_rng(0).standard_normal(A.n_rows).astype(np.float32)
    bt = torch.from_numpy(b).to(cuda)
    spmv_tpu_torch.cg(A, bt, rtol=1e-6, kind="csr_vector")  # captures the chunk
    graph = _solver_graph(A, "cg", "csr_vector", None, bt.device)
    assert _port_kernels(graph) == {"dia_kernel": solvers.CHUNK}
    reads, eager = solvers.host_reads, tdia._dia_pass.launches
    x, info = spmv_tpu_torch.cg(A, bt, rtol=1e-6, kind="csr_vector")
    chunks = solvers.host_reads - reads - 1
    assert info["converged"] and x.device.type == "cuda"
    assert chunks == -(-info["iters"] // solvers.CHUNK)
    assert tdia._dia_pass.launches - eager == 1
    _, info_cpu = spmv_tpu_torch.cg(A, torch.from_numpy(b), rtol=1e-6, kind="csr_vector")
    assert abs(info["iters"] - info_cpu["iters"]) <= 1
    assert true_relative_residual(A, b, x.cpu().numpy()) < 1e-5


# --- merge_tiled (K10, with K9 on both sides) and spmm (K13)

ALL_RINGS = {"or_and": OR_AND, **RINGS}


def _merge_counts():
    return tpg._pgather_pass.launches, tmerge._merge_group_pass.launches


@pytest.fixture(scope="module")
def merge_case(cuda):
    """A power-law matrix with hub rows (the carry chain runs across
    tiles) and its merge plans under both policies, on the card."""
    A = power_law_csr(16384, 16384, 90000, seed=11)
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    plans = {p: tmerge.device_merge_plan(A, p, cuda)
             for p in (tmerge.TUNED_POLICY, tmerge.STOCK_POLICY)}
    return A, torch.from_numpy(x).to(cuda), plans


@pytest.mark.parametrize("policy", ["tuned", "stock"])
@pytest.mark.parametrize("ring,data", [("plus_times", "normal"), ("plus_times", "int"),
                                       ("min_plus", "normal"), ("max_times", "normal"),
                                       ("or_and", "normal")])
def test_merge_group_matches_plain_version(merge_case, policy, ring, data):
    """K10 in the spare-row branch (tuned) and the masked-reduction branch
    (stock): bit for bit but on normal plus-times data, which is held
    within rtol 2e-4 / atol 1e-5."""
    A, x, plans = merge_case
    pol = tmerge.TUNED_POLICY if policy == "tuned" else tmerge.STOCK_POLICY
    plan, sr = plans[pol], ALL_RINGS[ring]
    if data == "int":
        x = torch.randint(-4, 5, x.shape, device=x.device).float()
        plan = dataclasses.replace(plan, ax_tiles=torch.randint(
            -4, 5, plan.ax_tiles.shape, device=x.device).float())
    elif ring == "max_times":  # the ring of non-negative values
        x = x.abs()
    prod = tmerge.merge_products(A, x, sr, plan)
    S, P = pol.nnz_per_tile // 128, pol.rows_per_tile // 128
    args = (prod, plan.rel_tiles.view(-1, 128), plan.pr1, plan.pr2, plan.pr3,
            plan.r_start, plan.lrow, plan.cnt)
    before = tmerge._merge_group_pass.launches
    got = tmerge._merge_group_pass(*args, sr=sr, S=S, P=P)
    assert tmerge._merge_group_pass.launches == before + 1
    want = tmerge._merge_group_plain(*args, sr=sr, S=S, P=P)
    torch.cuda.synchronize()
    if ring == "plus_times" and data == "normal":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert torch.equal(got, want)


def _chain_plan(S, P, seed, hub=4200, n_mixed=300):
    """K10's inputs for a hand-built chain of tiles in row order (EN =
    128*S products, RW = 128*P rows a tile): one row across `hub` tiles,
    past one 4096-tile chunk of the carry scan; then tiles that continue
    the carry's row or start new rows, one-row tiles among them, and
    empty tiles inside the chain, some on the carry's row (they fold) and
    some on none; pad tiles up to whole groups. -> (rel, pr1, pr2, pr3,
    r_start, lrow, cnt), CPU tensors."""
    rng = np.random.default_rng(seed)
    EN, RW, sbt = 128 * S, 128 * P, 128 // S
    tiles = []  # (r_start, lrow, cnt)
    last = 0    # lrow of the last non-empty tile

    def add(r0, span):
        nonlocal last
        c = int(rng.integers(1, EN + 1))
        last = r0 + (span if c > 1 else 0)
        tiles.append((r0, last, c))

    add(0, 3)
    for _ in range(hub):
        add(last, 0)
    for _ in range(n_mixed):
        u = rng.random()
        if u < 0.2:
            r0 = (last, -2)[int(rng.integers(0, 2))]
            tiles.append((r0, r0, 0))
        elif u < 0.6:
            add(last, int(rng.integers(0, 4)))
        else:
            add(last + int(rng.integers(1, 3)), int(rng.integers(0, 4)))
    tiles += [(-2, -2, 0)] * (-len(tiles) % sbt)
    T = len(tiles)
    rel = np.zeros((T, EN), np.int32)
    pend = np.full((T, RW), -1, np.int32)
    for t, (r0, r1, c) in enumerate(tiles):
        if c == 0:
            continue
        mid = np.sort(rng.integers(0, r1 - r0 + 1, max(c - 2, 0)))
        rows = np.concatenate([[0], mid, [r1 - r0]])[:c] if c > 1 else np.zeros(1)
        rel[t, :c], rel[t, c:] = rows, rows[-1]
        for r in np.unique(rows).astype(np.int64):
            pend[t, r] = np.flatnonzero(rows == r)[-1]
    r_start, lrow, cnt = (np.asarray(a, np.int32) for a in zip(*tiles))
    routes = tmerge._pend_routes(pend.reshape(T, P, 128), cnt, S, P, sbt)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (rel.reshape(-1, 128), *routes, r_start, lrow, cnt))


@pytest.mark.parametrize("shape", ["masked", "spare_row"])
@pytest.mark.parametrize("ring,data", [("plus_times", "normal"), ("plus_times", "int"),
                                       ("min_plus", "normal"), ("max_times", "normal"),
                                       ("or_and", "normal")])
def test_merge_group_on_hand_built_chains(cuda, shape, ring, data):
    """K10 on chain arrays fed straight to the wrapper: a hub run longer
    than one chunk of the carry scan, empty tiles inside the chain, and
    both last-row branches (S 1: no spare route row; S 2: the spare row).
    Bit for bit but on normal plus-times data, held within rtol 2e-4 /
    atol 1e-5."""
    S, P = (1, 1) if shape == "masked" else (2, 1)
    assert (128 // S * P + 128 // S <= 128) == (shape == "spare_row")
    plan = _chain_plan(S, P, seed=S)
    cnt = plan[-1]
    sr = ALL_RINGS[ring]
    rng = np.random.default_rng(7)
    T, EN = cnt.shape[0], 128 * S
    if data == "int":
        prod = rng.integers(-4, 5, (T, EN)).astype(np.float32)
    elif ring == "or_and":
        prod = (rng.random((T, EN)) < 0.3).astype(np.float32)
    else:
        prod = rng.standard_normal((T, EN)).astype(np.float32)
        if ring == "max_times":
            prod = np.abs(prod)
        if ring == "min_plus":
            prod[rng.random(prod.shape) < 0.2] = np.inf
    prod[np.arange(EN)[None, :] >= cnt.numpy()[:, None]] = sr.identity_for(np.float32)
    args = [torch.from_numpy(prod.reshape(-1, 128)).to(cuda)] + [a.to(cuda) for a in plan]
    before = tmerge._merge_group_pass.launches
    got = tmerge._merge_group_pass(*args, sr=sr, S=S, P=P)
    assert tmerge._merge_group_pass.launches == before + 1
    want = tmerge._merge_group_plain(*args, sr=sr, S=S, P=P)
    torch.cuda.synchronize()
    if ring == "plus_times" and data == "normal":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_merge_tiled_on_cuda_matches_oracle(merge_case, ring):
    A, x, _ = merge_case
    sr = ALL_RINGS[ring]
    xn = x.cpu().numpy()
    if ring == "or_and":
        xn = np.where(np.random.default_rng(4).random(xn.size) < 0.7, 0, xn).astype(np.float32)
    before = _merge_counts()
    y = spmv_tpu_torch.spmv("merge_tiled", A, torch.from_numpy(xn).to(x.device), semiring=sr)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _merge_counts())) == (2, 1)
    if ring == "plus_times":
        np.testing.assert_allclose(y.cpu().numpy(), spmv_tpu_torch.spmv_ref(
            A, xn, y_dtype=np.float64), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(y.cpu().numpy(),
                                      spmv_tpu_torch.spmv_ref_semiring(A, xn, sr))


def test_merge_fallback_on_cuda_runs_k10(merge_case, monkeypatch):
    A, x, _ = merge_case

    def refuse(A, policy):
        raise spmv_tpu_torch.PlanCapacityError("too large")

    monkeypatch.setattr(tstream, "build_stream_plan", refuse)
    for kind in ("merge", "merge_stock"):
        before = _merge_counts()
        with pytest.warns(spmv_tpu_torch.FallbackWarning):
            y = spmv_tpu_torch.spmv(kind, A, x)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(before, _merge_counts())) == (2, 1)
        np.testing.assert_allclose(y.cpu().numpy(), spmv_tpu_torch.spmv_ref(
            A, x.cpu().numpy(), y_dtype=np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_spmm_window_matches_plain_version(cuda, ring):
    """K13 bit for bit, on a column block read in place with row stride
    256 (the second block of a 256-column X)."""
    A = power_law_csr(8000, 7000, 60000, seed=9)
    d = tspmm.device_window_plan(A, np.dtype(np.float32), cuda)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (d["rows_pad"], 256)).astype(np.float32)).to(cuda)
    blk = X[:, 128:]
    before = tspmm._spmm_window_pass.launches
    got = tspmm._spmm_window_pass(blk, d["ax"], d["q"], d["xb"], sr=ALL_RINGS[ring])
    assert tspmm._spmm_window_pass.launches == before + 1
    assert torch.equal(got, tspmm._spmm_window_plain(blk, d["ax"], d["q"], d["xb"],
                                                     sr=ALL_RINGS[ring]))
    with pytest.raises(ValueError, match="row stride"):
        tspmm._spmm_window_pass(X[:, 1:129], d["ax"], d["q"], d["xb"], sr=ALL_RINGS[ring])


@pytest.mark.parametrize("method,B", [("window", 200), ("window", 40), ("xla", 128),
                                      ("stream", 128), ("auto", 64)])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus"])
def test_spmm_on_cuda_matches_oracle(cuda, method, B, ring):
    A = power_law_csr(3000, 2500, 20000, seed=4)
    Xn = np.random.default_rng(2).standard_normal((A.n_cols, B)).astype(np.float32)
    sr = ALL_RINGS[ring]
    before = tspmm._spmm_window_pass.launches
    Y = spmv_tpu_torch.spmm(A, torch.from_numpy(Xn).to(cuda), semiring=sr, method=method)
    torch.cuda.synchronize()
    blocks = -(-B // 128) if method in ("window", "auto") else 0
    assert tspmm._spmm_window_pass.launches - before == blocks
    assert Y.device.type == "cuda" and tuple(Y.shape) == (A.n_rows, B)
    if ring == "plus_times":
        np.testing.assert_allclose(Y.cpu().numpy(), spmv_tpu_torch.spmv_ref(
            A, Xn, y_dtype=np.float64), rtol=RTOL, atol=1e-4)
    else:
        np.testing.assert_array_equal(Y.cpu().numpy(),
                                      spmv_tpu_torch.spmv_ref_semiring(A, Xn, sr))


# ---------------------------------------------------------------------------
# The multi-device layer: K11' and the distributed SpMVs on a 4-shard local
# mesh on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_case(cuda):
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh

    A = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7)
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    d = distribute_csr(A, make_mesh("shards", n_shards=4, device=cuda))
    assert d.plan.export_flag.any()  # hub rows split across shards
    return A, x, d


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
@pytest.mark.parametrize("block", ["self", "halo"])
def test_local_ell_matches_plain_version(dist_case, block, ring):
    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import dist_spmv as tds

    A, x, d = dist_case
    sr = BUILTIN_SEMIRINGS[ring]
    xv = np.abs(x) if ring == "max_times" else x
    if ring == "or_and":
        xv = np.where(np.random.default_rng(1).random(x.size) < 0.7, 0.0, x)
    xs = d.shard_x(torch.from_numpy(xv.astype(np.float32)).to(d.mesh.device))
    xsrc = xs if block == "self" else d.x_table(xs)
    b = d.dev[block]
    ax = b["ax"].abs() if ring == "max_times" else b["ax"]
    before = tds._local_ell_pass.launches
    got = tds._local_ell_pass(b["aj"], ax, b["valid"], xsrc, W=b["W"], sr=sr)
    assert tds._local_ell_pass.launches == before + 1
    want = tds._local_ell_plain(b["aj"], ax, b["valid"], xsrc, W=b["W"], sr=sr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("impl", ["csr_halo", "csr_allgather", "stream"])
def test_distributed_on_cuda_matches_cpu(dist_case, impl, ring):
    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import (dist_spmv as tds, distribute_csr,
                                         distribute_stream, make_mesh)

    A, x, _ = dist_case
    sr = BUILTIN_SEMIRINGS[ring]
    xv = np.abs(x) if ring == "min_plus" else x

    def run(device):
        mesh = make_mesh("shards", n_shards=4, device=device)
        if impl == "stream":
            return distribute_stream(A, mesh).matvec(
                torch.from_numpy(xv).to(device), semiring=sr)
        return distribute_csr(A, mesh).matvec(
            torch.from_numpy(xv).to(device), semiring=sr, mode=impl[4:])

    before = tds._local_ell_pass.launches
    y = run(torch.device("cuda"))
    torch.cuda.synchronize()
    # a key's first call on the card runs eagerly (K11' twice) and is then
    # captured, which records K11' twice more into the call's graph
    assert tds._local_ell_pass.launches - before == (0 if impl == "stream" else 4)
    y_cpu = run(torch.device("cpu"))
    if ring == "min_plus":
        assert torch.equal(y.cpu(), y_cpu)
    else:
        torch.testing.assert_close(y.cpu(), y_cpu, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            y.cpu().numpy(), spmv_tpu_torch.spmv_ref(A, xv, y_dtype=np.float64),
            rtol=RTOL, atol=1e-4)


# --- K11' on made blocks: a warp per 128-lane row, 4 lanes a thread loaded
# as vectors, the `tree` steps d >= 4 as warp shuffles and d = 2, 1 in the
# thread

K11P_SHAPES = [(1, 1), (2, 17), (4, 33), (3, 131), (4, 300)]  # (L, Tv)


def _k11p_made(L, Tv, ring, seed, C=999):
    """aj, ax, valid (L, Tv, 8, 128) and xsrc (L, C): ~20% of slots
    invalid, some 4-lane chunks and every fifth tile all invalid, ±inf and
    NaN in x (and zeros for or-and)."""
    rng = np.random.default_rng(seed)
    shape = (L, Tv, 8, 128)
    aj = rng.integers(0, C, shape).astype(np.int32)
    ax = rng.standard_normal(shape).astype(np.float32)
    valid = rng.random(shape) < 0.8
    chunks = valid.reshape(L, Tv, 8, 32, 4)
    chunks[rng.random((L, Tv, 8, 32)) < 0.1] = False
    valid[:, 2::5] = False
    xsrc = rng.standard_normal((L, C)).astype(np.float32)
    u = rng.random((L, C))
    xsrc[u < 0.02] = np.inf
    xsrc[(u >= 0.02) & (u < 0.04)] = -np.inf
    xsrc[(u >= 0.04) & (u < 0.05)] = np.nan
    if ring in ("max_times",):
        ax, xsrc = np.abs(ax), np.abs(xsrc)
    if ring.startswith("or_and"):
        ax[rng.random(shape) < 0.3] = 0.0
        xsrc[rng.random((L, C)) < 0.5] = 0.0
    return aj, ax, valid, xsrc


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and",
                                  "or_and_counting"])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32, 64, 128])
def test_local_ell_matches_plain_version_on_made_blocks(cuda, W, ring):
    """K11' bit for bit (NaN as NaN) against its plain version, every W
    and ring, 1 to 4 shards of 1 to 300 tiles (below the SM count and
    over several waves)."""
    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import dist_spmv as tds

    sr = OR_AND_COUNTING if ring == "or_and_counting" else BUILTIN_SEMIRINGS[ring]
    for i, (L, Tv) in enumerate(K11P_SHAPES):
        args = tuple(torch.from_numpy(a).to(cuda) for a in _k11p_made(L, Tv, ring, i))
        before = tds._local_ell_pass.launches
        got = tds._local_ell_pass(*args, W=W, sr=sr)
        assert tds._local_ell_pass.launches == before + 1
        assert got.shape == (L, Tv * 8 * 128 // W)
        _bits_equal_nan(got, tds._local_ell_plain(*args, W=W, sr=sr))
        ident = float(sr.identity_for(np.float32))
        assert (got.view(L, Tv, -1)[:, 2::5] == ident).all()  # all-invalid tiles
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["aj", "ax", "valid"])
def test_local_ell_refuses_a_misaligned_tensor(cuda, name):
    from spmv_tpu_torch.parallel import dist_spmv as tds

    args = dict(zip(("aj", "ax", "valid", "xsrc"),
                    (torch.from_numpy(a).to(cuda) for a in _k11p_made(1, 2, "plus_times", 0))))
    t = args[name]
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=cuda)
    args[name] = buf[1:1 + t.numel()].view(t.shape)  # contiguous, not 16-byte aligned
    args[name].copy_(t)
    with pytest.raises(ValueError, match=f"{name}: not 16-byte aligned"):
        tds._local_ell_pass(*args.values(), W=2, sr=PLUS_TIMES)


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_distribute_csr_launches_k11p_twice_and_matches_the_oracle(dist_case, ring):
    """distribute_csr on 4 local shards, both modes: K11' launched exactly
    twice a call and nothing else (the first call of a (ring, mode) runs
    eagerly, twice by the wrapper's count; the graph captured after it
    holds two K11' nodes, and its replays launch nothing through the
    wrapper), y within rtol of the float64 oracle (plus-times) or equal to
    the semiring oracle bit for bit, by the eager call and by a replay."""
    from spmv_tpu_torch.utils.timing import graph_kernels

    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import dist_spmv as tds

    A, x, d = dist_case
    sr = BUILTIN_SEMIRINGS[ring]
    xv = np.abs(x) if ring == "max_times" else x
    if ring == "or_and":
        xv = np.where(np.random.default_rng(1).random(x.size) < 0.7, 0.0, x)
    xv = xv.astype(np.float32)
    Ar = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, np.abs(A.Ax)) \
        if ring == "max_times" else A
    if ring == "max_times":
        from spmv_tpu_torch.parallel import distribute_csr

        d = distribute_csr(Ar, d.mesh)
    want = (spmv_tpu_torch.spmv_ref(Ar, xv, y_dtype=np.float64) if ring == "plus_times"
            else spmv_tpu_torch.spmv_ref_semiring(Ar, xv, sr))
    xt = torch.from_numpy(xv).to(d.mesh.device)
    for mode in ("halo", "allgather"):
        d.graphs.pop((sr, mode, torch.float32, 1), None)
        before = tds._local_ell_pass.launches
        y = d._matvec_eager(xt, semiring=sr, mode=mode)
        torch.cuda.synchronize()
        assert tds._local_ell_pass.launches - before == 2
        d.matvec(xt, semiring=sr, mode=mode)  # eager, then captured
        graph = d.graphs[(sr, mode, torch.float32, 1)][0]
        assert graph_kernels(graph, ("local_ell_kernel",)) == {"local_ell_kernel": 2}
        before = tds._local_ell_pass.launches
        y_replay = d.matvec(xt, semiring=sr, mode=mode)
        torch.cuda.synchronize()
        assert tds._local_ell_pass.launches == before
        for got in (y, y_replay):
            if ring == "plus_times":
                np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(got.cpu().numpy(), want)


# --- the bench path on the card

def test_harness_on_cuda_runs_its_kernels_and_passes_the_gate(cuda, tmp_path):
    """`stream` and `xla` through the harness on the card, from
    --synthetic and from a written .mtx file: every kind in the results,
    within PERF.md's gate, timed by CUDA events; `stream` launches K2."""
    from spmv_tpu_torch.bench import harness
    from spmv_tpu_torch.io.generate import banded_csr
    from spmv_tpu_torch.io.matrix_market import write_matrix_market

    before = tstream._reduce_diff_pass.launches
    res = harness.main(["--synthetic", "powerlaw", "--rows", "16384", "--nnz", "90000",
                        "--iters", "5", "stream", "xla"])
    assert [r.kind for r in res] == ["stream", "xla"]
    assert tstream._reduce_diff_pass.launches > before
    p = tmp_path / "banded.mtx"
    write_matrix_market(p, banded_csr(3000, 3, seed=1))
    res += harness.main([str(p), "stream", "xla", "--iters", "5"])
    for r in res:
        assert r.kernel_s > 0 and r.delta["within_gate"], r.row()


def test_chip_specs_names_the_card(cuda):
    from spmv_tpu_torch.utils.roofline import CHIP_HBM_GBPS, chip_specs

    name, gbps = chip_specs()
    assert name == torch.cuda.get_device_name(0)
    assert gbps == CHIP_HBM_GBPS.get(name, CHIP_HBM_GBPS["NVIDIA H100 80GB HBM3"])
    assert chip_specs("cpu") == ("cpu", CHIP_HBM_GBPS["cpu"])


# --- spgemm, autograd, triangular solves and the graph examples on the card

def _stream_launches():
    return sum(k.launches for k in (tstream._reduce_diff_pass, tstream._reduce_roll_pass,
                                    tstream._gather_split_pass, tstream._gather_pass,
                                    tstream._scan_diff_pass, tstream._scan_roll_pass))


@pytest.mark.parametrize("ring", ["plus_times", "min_plus"])
def test_spgemm_stream_on_cuda_matches_xla(cuda, ring):
    """spgemm(method="stream") launches the stream kernels on the virtual
    CSR and agrees with method="xla" on the same card: plus-times within
    rtol 2e-4 / atol 1e-4, min-plus bit for bit; C is a host CSR."""
    from spmv_tpu_torch.kernels.spgemm import spgemm

    sr = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS}[ring]
    A = random_csr(3000, 2500, 24000, seed=1)
    B = random_csr(2500, 2000, 20000, seed=2)
    if sr is MIN_PLUS:
        A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, np.abs(A.Ax) + 0.1)
    before = _stream_launches()
    Cs = spgemm(A, B, semiring=sr, method="stream")
    assert _stream_launches() >= before + 2
    Cx = spgemm(A, B, semiring=sr, method="xla")
    Ca = spgemm(A, B, semiring=sr, method="auto")  # rides the stream plan
    assert isinstance(Cs.Ax, np.ndarray)
    np.testing.assert_array_equal(Cs.Ap, Cx.Ap)
    np.testing.assert_array_equal(Cs.Aj, Cx.Aj)
    np.testing.assert_array_equal(Cs.Ax, Ca.Ax)
    if sr is MIN_PLUS:
        np.testing.assert_array_equal(Cs.Ax, Cx.Ax)
    else:
        np.testing.assert_allclose(Cs.Ax, Cx.Ax, rtol=2e-4, atol=1e-4)
        Cc = spgemm(A, B, method="xla", device="cpu")
        np.testing.assert_allclose(Cs.Ax, Cc.Ax, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["stream", "csr_vector_ell", "xla"])
def test_sparse_operator_backward_on_cuda_matches_cpu(cuda, kind):
    from spmv_tpu_torch.ops.autodiff import SparseOperator, spmv_values

    A = power_law_csr(16384, 16384, 90000, seed=11)
    x = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    op = SparseOperator(A, kind=kind)
    grads = []
    for dev in (cuda, "cpu"):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        before = _stream_launches()
        g, = torch.autograd.grad((op(xt) ** 2).sum(), xt)
        if kind == "stream" and dev == cuda:
            assert _stream_launches() >= before + 4  # forward and backward
        grads.append(g.cpu().numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-3, atol=1e-3)
    gv = []
    for dev in (cuda, "cpu"):
        Ax = torch.tensor(A.Ax, device=dev, requires_grad=True)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        ga, gx = torch.autograd.grad((spmv_values(A, Ax, xt) ** 2).sum(), (Ax, xt))
        gv.append((ga.cpu().numpy(), gx.cpu().numpy()))
    for a, b in zip(*gv):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_sptrsv_and_ilu0_apply_on_cuda_match_cpu(cuda):
    from spmv_tpu_torch.kernels.trisolve import ilu0, ilu0_apply, sptrsv

    A = poisson2d(40)
    L, U = ilu0(A)
    r = np.random.default_rng(3).standard_normal(A.n_rows).astype(np.float32)
    for f in (lambda v: sptrsv(L, v, lower=True, unit_diagonal=True),
              lambda v: sptrsv(U, v, lower=False),
              lambda v: ilu0_apply(L, U, v)):
        got = f(torch.from_numpy(r).to(cuda))
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), f(torch.from_numpy(r)).numpy(),
                                   rtol=1e-5, atol=1e-6)
    x, info = spmv_tpu_torch.cg(A, torch.from_numpy(r).to(cuda), rtol=1e-6, M="ilu0")
    assert info["converged"] and x.device.type == "cuda"


def test_pagerank_and_bfs_on_cuda(cuda):
    from spmv_tpu_torch.examples import bfs, pagerank

    # stream on the card, against xla on the CPU: the L1 change per step
    # falls to the float32 rounding noise before it falls to 1e-8, so the
    # rounding decides the step at which each stops; the ranks agree
    out = pagerank.main(["--nodes", "4000", "--edges", "30000"])
    cpu = pagerank.main(["--kind", "xla", "--nodes", "4000", "--edges", "30000",
                         "--device", "cpu"])
    assert max(out["iters"], cpu["iters"]) < 200
    np.testing.assert_allclose(out["ranks"], cpu["ranks"], rtol=0, atol=1e-6)
    out = bfs.main(["--nodes", "20000", "--edges", "120000"])  # merge_genl in or-and
    np.testing.assert_array_equal(out["level"], bfs.bfs_ref(out["A_t"], out["source"]))


# --- bfloat16 and float16 through the stream kernels (K1, K3, K4, K5, K7,
# K8): float32 registers, rounded to the value dtype where each writes

VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _in(dtype, args):
    return tuple(a.to(dtype) if a.is_floating_point() else a for a in args)


def _same16(got, want, exact):
    """NaN where the plain version has NaN; elsewhere equal values (-0 as
    +0, as the float32 tests compare), or, for sums taken in another
    order, within one ulp of the value dtype (a float32 sum a few float32
    ulps away can round to the neighbour)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if exact:
        assert torch.equal(got[~nan].float(), want[~nan].float())
    else:
        torch.testing.assert_close(got[~nan].float(), want[~nan].float(),
                                   rtol=ULP[got.dtype], atol=1e-5)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("n_w", [1, 133])
def test_xprep_in_16_bits_matches_plain_version(cuda, dtype, n_w):
    dt = VALUE_DTYPES[dtype]
    rng = np.random.default_rng(n_w)
    rows = 128 + 24 * n_w
    xnat = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    xnat[0, :7] = torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-30, 7e4])
    g0 = rng.integers(0, rows - 127, n_w).astype(np.int32)
    xr = [rng.integers(0, 128, (n_w * 128, 128)).astype(np.uint8) for _ in range(3)]
    args = (xnat.to(dt).to(cuda), *[torch.from_numpy(a).to(cuda) for a in (g0, *xr)])
    before = tstream._xprep_pass.launches
    got = tstream._xprep_pass(*args, n_w=n_w)
    assert tstream._xprep_pass.launches == before + 1
    _same16(got, tstream._xprep_plain(*args, n_w=n_w), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("name", list(SPLIT_GEOMETRIES))
def test_split_in_16_bits_matches_plain_version(cuda, dtype, name):
    arrays, kw, gaps = _split_pass(cuda, name)
    n_steps = arrays[4].numel()
    data = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n_steps * kw["sbt"] * 128, 128)).astype(np.float32)).to(VALUE_DTYPES[dtype]).to(cuda)
    before = tshuffle._run_split.launches
    got = tshuffle._run_split(data, *arrays, n_steps=n_steps, gaps=gaps,
                              fill=float("inf"), **kw)
    assert tshuffle._run_split.launches == before + 1
    _same16(got, tshuffle._split_plain(data, *arrays, n_steps=n_steps,
                                       fill=float("inf"), **kw), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_plus", "sat_add_times"])
def test_gather_kernels_in_16_bits_match_plain_versions(random_plan, dtype, ring):
    """K4 and K3: one combine a slot, rounded once, so bit for bit."""
    _, plan, dplan = random_plan
    dt = VALUE_DTYPES[dtype]
    sr = {**RINGS, "max_plus": MAX_PLUS, "sat_add_times": SAT_ADD_TIMES}[ring]
    g = dplan.gather
    dev = g["q"].device
    gt = plan.n_gather_tiles
    rng = np.random.default_rng(7)
    ax = torch.from_numpy(rng.standard_normal(tuple(g["q"].shape)).astype(
        np.float32)).to(dt).to(dev)
    x2d = torch.from_numpy(rng.standard_normal((plan.x_rows_pad * 128, 128)).astype(
        np.float32)).to(dt).to(dev)
    prod = tstream._gather_pass(x2d, ax, g["q"], g["xb"], sr=sr, n_tiles=gt)
    _same16(prod, tstream._gather_plain(x2d, ax, g["q"], g["xb"], sr=sr, n_tiles=gt),
            exact=True)
    p0, d0 = plan.shuffle.passes[0], dplan.shuffle_dev[0]
    kw = dict(sr=sr, sbt=8, n_tiles=gt, K=p0.K, Q=p0.Q, rows_per_g=p0.out_rows // p0.K)
    args = (x2d, ax, g["q"], g["xb"], d0["s1"], d0["s2"], d0["s3"], d0["starts"],
            d0["pos"])
    before = tstream._gather_split_pass.launches
    fused = tstream._gather_split_pass(*args, gaps=d0["gaps"], **kw)
    assert tstream._gather_split_pass.launches == before + 1
    _same16(fused, tstream._gather_split_plain(*args, **kw), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("n_tiles", [1, 80, 300])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_reduce_roll_in_16_bits_matches_plain_version(cuda, dtype, n_tiles, ring):
    """K7 on made tiles in the value dtype: min and max bit for bit (NaN
    as NaN), plus-times within one ulp."""
    dt = VALUE_DTYPES[dtype]
    args = _in(dt, _k7_inputs(cuda, n_tiles, 17, "random", seed=n_tiles))
    kw = dict(sr=RINGS[ring], n_tiles=n_tiles, Qp=17, out_rows=n_tiles * 17 + 8)
    before = tstream._reduce_roll_pass.launches
    got = tstream._reduce_pass(*args, **kw)  # not float32: K7 in every ring
    assert tstream._reduce_roll_pass.launches == before + 1
    _same16(got, tstream._reduce_roll_plain(*args, **kw), exact=ring != "plus_times")


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("F", [1, 80, 352])
@pytest.mark.parametrize("ring,data", [("plus_times", "int"), ("min_plus", "int"),
                                       ("max_times", "int"), ("plus_times", "normal")])
def test_scan_roll_in_16_bits_matches_plain_version(k8_tiles, dtype, F, ring, data):
    """K8 on made patterns in the value dtype: integer-valued products
    (every sum exact) bit for bit, normal plus-times within one ulp."""
    t = k8_tiles(F)
    dt = VALUE_DTYPES[dtype]
    args = (t[data].to(dt), *[t[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1",
                                             "r2s2", "r2s3", "valid2")])
    before = tstream._scan_roll_pass.launches
    got = tstream._scan_roll_pass(*args, sr=RINGS[ring], F_pad=F)
    assert tstream._scan_roll_pass.launches == before + 1
    _same16(got, tstream._scan_roll_plain(*args, sr=RINGS[ring], F_pad=F),
            exact=data == "int")


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("ring", ["plus_times", "min_plus"])
def test_stream_in_16_bits_on_cuda_matches_cpu(cuda, dtype, branch, ring):
    """`stream` end to end with Ax and x in the value dtype, multiples of
    1/2 (every product and sum exact): the card's y equals the CPU's bit
    for bit, through K7 -> K8 or K3 -> K8 and never K2 or K6."""
    dt = VALUE_DTYPES[dtype]
    A0 = BRANCHES[branch]()
    rng = np.random.default_rng(3)
    ax = torch.from_numpy((rng.integers(-4, 5, A0.nnz) / 2).astype(np.float32)).to(dt)
    x = torch.from_numpy((rng.integers(-4, 5, A0.n_cols) / 2).astype(np.float32)).to(dt)
    if ring == "min_plus":
        ax, x = ax.abs(), x.abs()
    A = spmv_tpu_torch.CSR(A0.n_rows, A0.n_cols, A0.Ap, A0.Aj, ax)
    before = {c: getattr(tstream, c).launches for c in COUNTERS}
    y = spmv_tpu_torch.spmv("stream", A, x.to(cuda), semiring=RINGS[ring])
    torch.cuda.synchronize()
    ran = {c for c in COUNTERS if getattr(tstream, c).launches > before[c]}
    assert "_scan_roll_pass" in ran and not ran & {"_reduce_diff_pass", "_scan_diff_pass"}
    assert y.dtype == dt
    yc = spmv_tpu_torch.spmv("stream", A, x, semiring=RINGS[ring])
    assert torch.equal(y.cpu().float(), yc.float())


# --- user-defined rings through every ring-templated kernel, each from the
# ring's own library

USER_RINGS = {"max_plus": MAX_PLUS, "sat_add_times": SAT_ADD_TIMES}


def _user_case(A, ring, seed):
    """(A, x) for the ring: max-plus on normal data; the saturating sum on
    non-negative data (where clamping is order-free), multiples of 1/8, so
    sums below the cap are exact too."""
    rng = np.random.default_rng(seed)
    if ring == "max_plus":
        return A, rng.standard_normal(A.n_cols).astype(np.float32)
    A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                           (rng.integers(0, 4, A.nnz) / 8).astype(np.float32))
    return A, (rng.integers(0, 4, A.n_cols) / 8).astype(np.float32)


USER_KINDS = {  # kind -> (matrix, the counters its kernels bump)
    "stream_reduction": lambda: power_law_csr(16384, 16384, 90000, seed=11),
    "stream_no_reduction": lambda: random_csr(20000, 30000, 150000, seed=1),
    "merge_tiled": lambda: power_law_csr(16384, 16384, 90000, seed=11),
    "csr_vector_ell": lambda: power_law_csr(16384, 16384, 90000, seed=11),
    "dia": lambda: spmv_tpu_torch.CSR(*_banded(20000)),
}


def _banded(n):
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows + np.tile([-1, 0, 1], n), 0, n - 1)
    A = spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(n, n, rows, cols,
                                                     np.ones(3 * n, np.float32)),
                                  sum_duplicates=True)
    return A.n_rows, A.n_cols, A.Ap, A.Aj, A.Ax


def _launch_counts():
    return (tstream._reduce_roll_pass.launches, tstream._gather_split_pass.launches,
            tstream._scan_roll_pass.launches, tmerge._merge_group_pass.launches,
            tell._group_reduce_pass.launches, tdia._dia_pass.launches)


@pytest.mark.parametrize("ring", list(USER_RINGS))
@pytest.mark.parametrize("kind", list(USER_KINDS))
def test_user_rings_on_cuda_match_the_plain_versions(cuda, kind, ring):
    """K7, K3, K8 (stream), K10 (merge_tiled), K11 (csr_vector_ell) and
    K12 (dia) under a user ring on the card, against the same call on the
    CPU: bit for bit."""
    sr = USER_RINGS[ring]
    A, x = _user_case(USER_KINDS[kind](), ring, 4)
    name = "stream" if kind.startswith("stream") else kind
    before = _launch_counts()
    y = spmv_tpu_torch.spmv(name, A, torch.from_numpy(x).to(cuda), semiring=sr)
    torch.cuda.synchronize()
    ran = [b - a for a, b in zip(before, _launch_counts())]
    want = {"stream_reduction": (1, 0, 1, 0, 0, 0), "stream_no_reduction": (0, 1, 1, 0, 0, 0),
            "merge_tiled": (0, 0, 0, 1, 0, 0), "dia": (0, 0, 0, 0, 0, 1)}.get(kind)
    if want is None:
        assert ran[4] > 0
    else:
        assert tuple(ran) == want
    assert torch.equal(y.cpu(), spmv_tpu_torch.spmv(name, A, torch.from_numpy(x),
                                                    semiring=sr))


@pytest.mark.parametrize("ring", list(USER_RINGS))
def test_user_rings_on_k4_k13_and_k11p_match_plain_versions(cuda, random_plan, dist_case,
                                                            ring):
    """K4 on a no-reduction plan, K13 on a column block and K11' through
    a 4-shard distribute_csr, under a user ring, bit for bit."""
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh

    sr = USER_RINGS[ring]
    _, plan, dplan = random_plan
    g = dplan.gather
    A, x = _user_case(random_csr(20000, 30000, 150000, seed=1), ring, 5)
    ax = torch.from_numpy(np.asarray(tstream.build_stream_plan(
        A, tstream.StreamPolicy()).gather["Ax"])).to(cuda)
    x2d = tstream._x_table(dplan, torch.from_numpy(x).to(cuda), A.n_cols)
    prod = tstream._gather_pass(x2d, ax, g["q"], g["xb"], sr=sr, n_tiles=plan.n_gather_tiles)
    assert torch.equal(prod, tstream._gather_plain(x2d, ax, g["q"], g["xb"], sr=sr,
                                                   n_tiles=plan.n_gather_tiles))
    B = power_law_csr(8000, 7000, 60000, seed=9)
    d = tspmm.device_window_plan(B, np.float32, cuda)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (d["rows_pad"], 128)).astype(np.float32)).to(cuda)
    got = tspmm._spmm_window_pass(X, d["ax"], d["q"], d["xb"], sr=sr)
    assert torch.equal(got, tspmm._spmm_window_plain(X, d["ax"], d["q"], d["xb"], sr=sr))
    from spmv_tpu_torch.parallel import dist_spmv as tds

    C, xc = _user_case(dist_case[0], ring, 6)
    dc = distribute_csr(C, make_mesh("shards", n_shards=2, device=cuda))
    xct = torch.from_numpy(xc).to(cuda)
    before = tds._local_ell_pass.launches
    y = dc._matvec_eager(xct, semiring=sr)
    torch.cuda.synchronize()
    assert tds._local_ell_pass.launches - before == 2
    yc = distribute_csr(C, make_mesh("shards", n_shards=2, device="cpu")).matvec(
        torch.from_numpy(xc), semiring=sr)
    assert torch.equal(y.cpu(), yc)
    dc.matvec(xct, semiring=sr)  # eager, then captured: the user ring's fold captures
    assert torch.equal(dc.matvec(xct, semiring=sr), y)  # a replay


def test_ring_library_is_built_once_and_reused(cuda):
    """A ring's library is built at its first CUDA call, cached on the
    Semiring, and found on disk by hash for another object of the same
    source: no second build."""
    from spmv_tpu_torch.kernels import _cuda

    lib = _cuda.ring_lib(MAX_PLUS)
    assert _cuda.ring_lib(MAX_PLUS) is lib
    twin = Semiring("max_plus", lambda: float("-inf"), lambda a, x: a + x,
                    lambda acc, v: torch.maximum(acc, v))
    seconds = dict(_cuda.ring_build_seconds)
    lib2 = _cuda.ring_lib(twin)
    assert lib2._name == lib._name and _cuda.ring_build_seconds == seconds


# --- bfloat16 and float16 through K9-K13 and K11' (float32 registers, the
# value dtype where each writes) and through the multi-device layer

@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
def test_pgather_in_16_bits_moves_the_bits(ell_case, dtype):
    """K9 moves 2-byte values as their bits: on every ELL plan and on a
    plan of R_MAX rounds, bit for bit against its plain version."""
    _, x, plans = ell_case
    x16 = x.to(VALUE_DTYPES[dtype])
    x16[:3] = torch.tensor([float("inf"), -0.0, float("nan")])
    pg4 = tpg.build_paged_gather_plan(_bucketed_idx(3 * 16384, 160000, 40, 0),
                                      160000).to(x.device)
    x4 = torch.from_numpy(np.random.default_rng(6).standard_normal(160000).astype(
        np.float32)).to(x.device).to(x16.dtype)
    for pg, xv in [(p.pgather, x16) for p in plans] + [(pg4, x4)]:
        args = (xv, pg.qlo, pg.qhi, pg.s1, pg.s2, pg.s3)
        before = tpg._pgather_pass.launches
        got = tpg._pgather_pass(*args, C=pg.n_chunks, R=pg.rounds)
        assert tpg._pgather_pass.launches == before + 1 and got.dtype == xv.dtype
        assert torch.equal(got.view(torch.int16), tpg._pgather_plain(
            *args, C=pg.n_chunks, R=pg.rounds).view(torch.int16))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
@pytest.mark.parametrize("W,strategy", [(1, "tree"), (2, "linear"), (4, "tree"),
                                        (32, "linear"), (64, "broadcast"), (128, "tree")])
def test_group_reduce_in_16_bits_matches_plain_version(cuda, dtype, W, strategy, ring):
    """K11 on 2-byte products: the plain version's float32 order, the
    leaders rounded once, bit for bit."""
    rng = np.random.default_rng(W)
    prod = rng.standard_normal((64 * 8 + 24, 128)).astype(np.float32)
    if ring == "min_plus":
        prod[rng.random(prod.shape) < 0.1] = np.inf
    prod = torch.from_numpy(prod).to(VALUE_DTYPES[dtype]).to(cuda)
    sr = RINGS[ring]
    before = tell._group_reduce_pass.launches
    got = tell._group_reduce_pass(prod, W=W, strategy=strategy, sr=sr)
    assert tell._group_reduce_pass.launches == before + 1
    _same16(got, tell._group_reduce_plain(prod, W=W, strategy=strategy, sr=sr)[:, ::W],
            exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("policy", ["tuned", "stock"])
@pytest.mark.parametrize("ring,data", [("plus_times", "normal"), ("plus_times", "int"),
                                       ("min_plus", "normal"), ("max_times", "normal")])
def test_merge_group_in_16_bits_matches_plain_version(merge_case, dtype, policy, ring,
                                                      data):
    """K10 on 2-byte products of both route branches: sums scanned and
    carried in float64 and rounded once (integer data bit for bit, normal
    data within one ulp of the value dtype), min and max bit for bit."""
    A, x, plans = merge_case
    dt = VALUE_DTYPES[dtype]
    pol = tmerge.TUNED_POLICY if policy == "tuned" else tmerge.STOCK_POLICY
    plan, sr = plans[pol], ALL_RINGS[ring]
    if data == "int":
        x = torch.randint(-4, 5, x.shape, device=x.device).float()
        plan = dataclasses.replace(plan, ax_tiles=torch.randint(
            -4, 5, plan.ax_tiles.shape, device=x.device).float())
    elif ring == "max_times":
        x = x.abs()
    A16 = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                             torch.from_numpy(np.asarray(A.Ax)).to(dt))
    prod = tmerge.merge_products(A16, x.to(dt), sr, dataclasses.replace(
        plan, ax_tiles=plan.ax_tiles.to(dt)))
    assert prod.dtype == dt
    S, P = pol.nnz_per_tile // 128, pol.rows_per_tile // 128
    args = (prod, plan.rel_tiles.view(-1, 128), plan.pr1, plan.pr2, plan.pr3,
            plan.r_start, plan.lrow, plan.cnt)
    before = tmerge._merge_group_pass.launches
    got = tmerge._merge_group_pass(*args, sr=sr, S=S, P=P)
    assert tmerge._merge_group_pass.launches == before + 1
    _same16(got, tmerge._merge_group_plain(*args, sr=sr, S=S, P=P),
            exact=not (ring == "plus_times" and data == "normal"))


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("n", [30000, 30001])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_dia_in_16_bits_matches_plain_version(cuda, dtype, n, ring):
    """K12 on 2-byte plans, its 4-value loads (n % 4 == 0) and its scalar
    ones: the plain version's float32 fold, y rounded once, bit for bit."""
    A = _diag(n, (-9000, -88, -1, 0, 1, 88, 12000), seed=n)
    dt = VALUE_DTYPES[dtype]
    vals, valid, offs = tdia.device_dia_plan(A, cuda, dt)
    assert vals.dtype == dt
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.n_cols).astype(np.float32)).to(dt).to(cuda)
    before = tdia._dia_pass.launches
    got = tdia._dia_pass(vals, valid, x, offs, sr=RINGS[ring])
    assert tdia._dia_pass.launches == before + 1
    _same16(got, tdia._dia_plain(vals, valid, x, offs, sr=RINGS[ring]), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_spmm_window_in_16_bits_matches_plain_version(cuda, dtype, ring):
    """K13 on a 2-byte column block read in place (row stride 256): one
    combine a product, rounded once, bit for bit."""
    A = power_law_csr(8000, 7000, 60000, seed=9)
    dt = VALUE_DTYPES[dtype]
    d = tspmm.device_window_plan(A, dt, cuda)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (d["rows_pad"], 256)).astype(np.float32)).to(dt).to(cuda)
    blk = X[:, 128:]
    before = tspmm._spmm_window_pass.launches
    got = tspmm._spmm_window_pass(blk, d["ax"], d["q"], d["xb"], sr=ALL_RINGS[ring])
    assert tspmm._spmm_window_pass.launches == before + 1
    _same16(got, tspmm._spmm_window_plain(blk, d["ax"], d["q"], d["xb"],
                                          sr=ALL_RINGS[ring]), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
@pytest.mark.parametrize("W", [1, 2, 4, 32, 128])
def test_local_ell_in_16_bits_matches_plain_version(cuda, dtype, W, ring):
    """K11' on made 2-byte blocks, 1 to 4 shards: bit for bit (NaN as
    NaN)."""
    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import dist_spmv as tds

    sr, dt = BUILTIN_SEMIRINGS[ring], VALUE_DTYPES[dtype]
    for i, (L, Tv) in enumerate(K11P_SHAPES):
        aj, ax, valid, xsrc = (torch.from_numpy(a).to(cuda)
                               for a in _k11p_made(L, Tv, ring, i))
        args = (aj, ax.to(dt), valid, xsrc.to(dt))
        before = tds._local_ell_pass.launches
        got = tds._local_ell_pass(*args, W=W, sr=sr)
        assert tds._local_ell_pass.launches == before + 1
        _same16(got, tds._local_ell_plain(*args, W=W, sr=sr), exact=True)


def _misaligned(t):
    """t's values at an address one element past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("kernel", ["K9", "K10", "K11", "K12", "K13", "K11'"])
def test_16_bit_kernels_refuse_a_misaligned_tensor(cuda, merge_case, kernel):
    """A 2-byte tensor one element off its 4-value alignment raises, and
    nothing runs on the CPU: K10's products, K11's products, K13's X block
    and K11''s values; K9 reads its 2-byte x by single values, so its
    plan's 16-byte stages are what it refuses; K12 reads such a plan by
    single values instead of 4-value loads, which gives the same bits."""
    from spmv_tpu_torch.parallel import dist_spmv as tds

    bf = torch.bfloat16
    if kernel == "K9":
        pg = tpg.build_paged_gather_plan(np.arange(20000), 20000).to(cuda)
        x = torch.ones(20000, dtype=bf, device=cuda)
        with pytest.raises(ValueError, match="qlo: not 16-byte aligned"):
            tpg._pgather_pass(x, _misaligned(pg.qlo), pg.qhi, pg.s1, pg.s2, pg.s3,
                              C=pg.n_chunks, R=pg.rounds)
    elif kernel == "K10":
        A, x, plans = merge_case
        plan = plans[tmerge.TUNED_POLICY]
        prod = tmerge.merge_products(A, x, PLUS_TIMES, plan).to(bf)
        with pytest.raises(ValueError, match="prod: not aligned"):
            tmerge._merge_group_pass(_misaligned(prod), plan.rel_tiles.view(-1, 128),
                                     plan.pr1, plan.pr2, plan.pr3, plan.r_start, plan.lrow,
                                     plan.cnt, sr=PLUS_TIMES,
                                     S=tmerge.TUNED_POLICY.nnz_per_tile // 128,
                                     P=tmerge.TUNED_POLICY.rows_per_tile // 128)
    elif kernel == "K11":
        prod = torch.ones((64, 128), dtype=bf, device=cuda)
        with pytest.raises(ValueError, match="prod: not 16-byte aligned"):
            tell._group_reduce_pass(_misaligned(prod), W=4, strategy="tree",
                                    sr=PLUS_TIMES)
    elif kernel == "K12":
        A = _diag(30000, (-1, 0, 1), seed=0)
        vals, valid, offs = tdia.device_dia_plan(A, cuda, bf)
        x = torch.ones(A.n_cols, dtype=bf, device=cuda)
        got = tdia._dia_pass(_misaligned(vals), valid, x, offs, sr=PLUS_TIMES)
        _same16(got, tdia._dia_pass(vals, valid, x, offs, sr=PLUS_TIMES), exact=True)
    elif kernel == "K13":
        A = power_law_csr(3000, 2500, 20000, seed=4)
        d = tspmm.device_window_plan(A, bf, cuda)
        X = torch.ones((d["rows_pad"], 256), dtype=bf, device=cuda)
        with pytest.raises(ValueError, match="8-byte aligned start"):
            tspmm._spmm_window_pass(X[:, 1:129], d["ax"], d["q"], d["xb"], sr=PLUS_TIMES)
    else:
        aj, ax, valid, xsrc = (torch.from_numpy(a).to(cuda)
                               for a in _k11p_made(1, 2, "plus_times", 0))
        with pytest.raises(ValueError, match="ax: not 8-byte aligned"):
            tds._local_ell_pass(aj, _misaligned(ax.to(bf)), valid, xsrc.to(bf), W=2,
                                sr=PLUS_TIMES)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
def test_user_ring_in_16_bits_on_k10_and_k13(merge_case, dtype):
    """A user ring (max-plus, its own library) on 2-byte values through
    K10 and K13: bit for bit against the plain versions, which run its
    torch callables in float32 and round once."""
    A, x, plans = merge_case
    dt = VALUE_DTYPES[dtype]
    plan = plans[tmerge.TUNED_POLICY]
    A16 = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                             torch.from_numpy(np.asarray(A.Ax)).to(dt))
    prod = tmerge.merge_products(A16, x.to(dt), MAX_PLUS, dataclasses.replace(
        plan, ax_tiles=plan.ax_tiles.to(dt)))
    S, P = tmerge.TUNED_POLICY.nnz_per_tile // 128, tmerge.TUNED_POLICY.rows_per_tile // 128
    args = (prod, plan.rel_tiles.view(-1, 128), plan.pr1, plan.pr2, plan.pr3,
            plan.r_start, plan.lrow, plan.cnt)
    _same16(tmerge._merge_group_pass(*args, sr=MAX_PLUS, S=S, P=P),
            tmerge._merge_group_plain(*args, sr=MAX_PLUS, S=S, P=P), exact=True)
    d = tspmm.device_window_plan(power_law_csr(8000, 7000, 60000, seed=9), dt, x.device)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (d["rows_pad"], 128)).astype(np.float32)).to(dt).to(x.device)
    _same16(tspmm._spmm_window_pass(X, d["ax"], d["q"], d["xb"], sr=MAX_PLUS),
            tspmm._spmm_window_plain(X, d["ax"], d["q"], d["xb"], sr=MAX_PLUS), exact=True)


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
def test_row_fold_in_16_bits_repeats_bit_for_bit(cuda, dtype):
    """The plus-times row fold of 2-byte values sums in float64 and rounds
    once: two folds of a 30000-value hub row on the card are equal bit for
    bit, and equal the CPU's."""
    from spmv_tpu_torch.ops.semiring import segment_reduce_sorted

    rng = np.random.default_rng(7)
    seg = np.sort(np.concatenate([np.zeros(30000, np.int64), rng.integers(1, 501, 2000)]))
    vals = torch.from_numpy(rng.standard_normal(seg.size).astype(np.float32)).to(
        VALUE_DTYPES[dtype])
    seg_t = torch.from_numpy(seg)
    y1, y2 = (segment_reduce_sorted(vals.to(cuda), seg_t.to(cuda), 600, PLUS_TIMES, 0.0)
              for _ in range(2))
    assert y1.dtype == vals.dtype
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(y1.cpu().view(torch.int16), segment_reduce_sorted(
        vals, seg_t, 600, PLUS_TIMES, 0.0).view(torch.int16))


BF16_KINDS = {  # kind -> the counters of its kernels (csr_vector: K12 on banded input)
    "csr_vector_ell": ("_pgather_pass", "_group_reduce_pass"),
    "merge_tiled": ("_pgather_pass", "_merge_group_pass"),
    "dia": ("_dia_pass",), "csr_vector": ("_dia_pass",),
    "spmm_window": ("_spmm_window_pass",), "distribute_csr": ("_local_ell_pass",),
    "distribute_stream": ("_reduce_roll_pass", "_scan_roll_pass"),
}


@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("kind", list(BF16_KINDS))
def test_bf16_on_k9_to_k13_and_k11p_matches_cpu(cuda, kind, dtype):
    """Each path off the stream kernels with A and x in bf16 or f16 runs
    its kernels on the card (their launches counted, no plain version)
    and gives y in that dtype, equal to the CPU's bit for bit: values are
    multiples of 1/2, so every sum is exact in any order."""
    from spmv_tpu_torch.parallel import dist_spmv as tds
    from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh

    dt = VALUE_DTYPES[dtype]
    A0 = (spmv_tpu_torch.CSR(*_banded(4000)) if kind in ("dia", "csr_vector")
          else power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7))
    rng = np.random.default_rng(2)
    half = lambda n: torch.from_numpy((rng.integers(-2, 3, n) / 2).astype(np.float32)).to(dt)
    A = spmv_tpu_torch.CSR(A0.n_rows, A0.n_cols, A0.Ap, A0.Aj, half(A0.nnz))
    x = half(A0.n_cols)
    mods = {"_pgather_pass": tpg, "_group_reduce_pass": tell, "_merge_group_pass": tmerge,
            "_dia_pass": tdia, "_spmm_window_pass": tspmm, "_local_ell_pass": tds,
            "_reduce_roll_pass": tstream, "_scan_roll_pass": tstream}

    def run(device):
        if kind == "spmm_window":
            X = x[:, None].expand(-1, 8).contiguous().to(device)
            return spmv_tpu_torch.spmm(A, X, method="window")
        if kind.startswith("distribute"):
            mk = distribute_csr if kind == "distribute_csr" else distribute_stream
            return mk(A, make_mesh("shards", n_shards=4, device=device)).matvec(x.to(device))
        return spmv_tpu_torch.spmv(kind, A, x.to(device))

    before = {c: getattr(mods[c], c).launches for c in BF16_KINDS[kind]}
    y = run(cuda)
    torch.cuda.synchronize()
    for c in BF16_KINDS[kind]:
        assert getattr(mods[c], c).launches > before[c], c
    assert y.dtype == dt and y.device.type == "cuda"
    assert torch.equal(y.cpu().view(torch.int16), run("cpu").view(torch.int16))


# --- device loops: every kind captured in a CUDA graph, K14, the solvers'
# graphed chunks and the harness's chained timing



PORT_KERNELS = ("dia_kernel", "sptrsv_kernel")  # the kernels the device loops launch


def _port_kernels(graph):
    """{stem: nodes} of PORT_KERNELS among a captured graph's kernel
    nodes: what one replay launches."""
    from spmv_tpu_torch.utils.timing import graph_kernels

    return graph_kernels(graph, PORT_KERNELS)


def _solver_graph(A, name, kind, M, dev):
    """The chunk graph a solve on `dev` (a b's device, with its index)
    cached on A (solvers.graph_key)."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.ops.registry import plan_cached, plan_cache

    key = solvers.graph_key(name, kind, M, torch.float32, dev)
    assert plan_cached(A, key)
    return plan_cache(A, key, None)[0]


CAPTURE_KINDS = DEFAULT_KINDS + ["dia", "dense"]


def _replay_equals_eager(kind, A, x, sr=None):
    from spmv_tpu_torch.utils.timing import capture_graph

    fn = lambda v: spmv_tpu_torch.spmv(kind, A, v, semiring=sr)
    want = fn(x)  # the eager warm-up call
    xs = x.clone()
    out = []
    g = capture_graph(lambda: out.append(fn(xs)), kind, x.device)
    g.replay()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out[0].cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("kind", CAPTURE_KINDS)
def test_every_device_kind_captures_in_a_cuda_graph(cuda, kind):
    A = (spmv_tpu_torch.CSR(*_banded(3000)) if kind in ("dia", "dense")
         else power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(A.n_cols)
                         .astype(np.float32)).to(cuda)
    _replay_equals_eager(kind, A, x)


@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
@pytest.mark.parametrize("kind", ["stream", "merge_tiled", "csr_vector_ell", "xla", "dia"])
def test_rings_capture_in_a_cuda_graph(cuda, kind, ring):
    sr = ALL_RINGS[ring]
    A = (spmv_tpu_torch.CSR(*_banded(3000)) if kind == "dia"
         else power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7))
    xn = np.random.default_rng(2).standard_normal(A.n_cols).astype(np.float32)
    if ring == "max_times":
        A, xn = _positive(A, 3)
    elif ring == "or_and":
        xn = np.where(np.random.default_rng(3).random(A.n_cols) < 0.7, 0.0, xn)
    _replay_equals_eager(kind, A, torch.from_numpy(xn.astype(np.float32)).to(cuda), sr)


def test_csr_vector_on_a_banded_matrix_captures(cuda):
    A = poisson2d(64)  # csr_vector's dia branch
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(A.n_cols)
                         .astype(np.float32)).to(cuda)
    _replay_equals_eager("csr_vector", A, x)


def test_the_host_kind_is_named():
    from spmv_tpu_torch.ops.registry import HOST_KINDS, is_host_kind

    assert HOST_KINDS == {"cpu_naive"} and is_host_kind("cpu_navie")
    assert not any(is_host_kind(k) for k in CAPTURE_KINDS)


def _tri_inputs(dev, T, lower, unit, dtype, b, **limits):
    from spmv_tpu_torch.kernels import trisolve as ttri

    plan = ttri._solve_plan(T, lower, unit)
    args = [plan[k].to(dev) for k in ("rows", "cols")] + \
        [plan[k].to(dev, dtype) for k in ("vals", "diag")]
    sched = ttri._k14_schedule(plan["rows"], plan["cols"].shape[2], **limits)
    return args + [b.to(dev, dtype)], dict(n=T.n_rows, l0=ttri._level_of_row0(plan["rows"]),
                                           sched=ttri._k14_to(sched, dev))


def _lower_random(n, density, seed):
    rng = np.random.default_rng(seed)
    d = np.tril(rng.random((n, n)) < density, k=-1) * rng.standard_normal((n, n))
    np.fill_diagonal(d, rng.random(n) + 1.0)
    return spmv_tpu_torch.csr_from_dense(d.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("which", ["L", "U", "random", "b_inf_nan"])
def test_sptrsv_kernel_matches_plain_version(cuda, which, dtype):
    """K14 against its plain version, bit for bit (NaN as NaN), on
    ILU(0)'s factors of poisson2d(40) and a random lower triangle, with
    +-inf and NaN in b; one launch per solve."""
    from spmv_tpu_torch.kernels import trisolve as ttri

    dt = getattr(torch, dtype)
    if which == "random":
        T, lower, unit = _lower_random(700, 0.02, 5), True, False
    else:
        L, U = ttri.ilu0(poisson2d(40))
        T, lower, unit = (U, False, False) if which == "U" else (L, True, True)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(T.n_rows)
                         .astype(np.float32))
    if which == "b_inf_nan":
        b[[0, 7, 300]] = torch.tensor([float("inf"), float("nan"), -float("inf")])
    args, kw = _tri_inputs(cuda, T, lower, unit, dt, b)
    before = ttri._sptrsv_pass.launches
    got = ttri._sptrsv_pass(*args, **kw)
    assert ttri._sptrsv_pass.launches == before + 1
    want = ttri._sptrsv_plain(*args, n=kw["n"])
    torch.cuda.synchronize()
    assert got.dtype == dt and torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])


def _lower_wide(n, deps, p_dep, seed):
    """A random lower triangle whose rows depend, with probability p_dep,
    on `deps` earlier rows each: about (1 - p_dep) n rows, row 0 among
    them, make level 0, and the levels after it are wide too."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(1, n), deps)
    rr = rr[np.repeat(rng.random(n - 1) < p_dep, deps)]
    cc = (rng.random(rr.size) * rr).astype(np.int64)
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, np.concatenate([rr, np.arange(n)]), np.concatenate([cc, np.arange(n)]),
        np.concatenate([rng.uniform(-0.5, 0.5, rr.size), 1.0 + rng.random(n)])
        .astype(np.float32)), sum_duplicates=True)


def _k14_equal(got, want):
    assert got.dtype == want.dtype and torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin], want[fin])


# K14's triangles on the card: (triangle, lower, unit) and the model of the
# card's limits the schedule is made for ({} = the card's own)
def _k14_case(name):
    if name == "wider_than_a_cluster":   # level 0 ~ 24,000 slots: 8 CTAs, in turn
        return _lower_wide(40_000, 2, 0.4, 11), True, False, {}
    if name == "cluster_one_pass":       # widest ~4,600: 8 CTAs, each level in one step
        return _lower_wide(12_000, 3, 0.62, 12), True, False, {}
    if name == "w_at_least_9":
        return _lower_random(400, 0.06, 13), True, False, {}
    if name == "w_at_least_9_cluster":   # 4 CTAs of 4 slots, entries in chunks of 4
        return _lower_random(400, 0.06, 13), True, False, dict(threads=8, cluster=4)
    if name == "small_cluster_in_turn":  # 2 CTAs of 64 slots walk each level in turn
        return _lower_wide(3000, 2, 0.5, 14), True, False, dict(threads=64, cluster=2)
    if name == "upper_small_cluster":    # row 0 in the last level, on a cluster of 3
        from spmv_tpu_torch.kernels import trisolve as ttri

        return ttri.ilu0(poisson2d(40))[1], False, False, dict(threads=16, cluster=3)
    raise KeyError(name)


K14_CASES = ["wider_than_a_cluster", "cluster_one_pass", "w_at_least_9", "w_at_least_9_cluster",
             "small_cluster_in_turn", "upper_small_cluster"]


@pytest.mark.parametrize("b_case", ["normal", "inf_nan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", K14_CASES)
def test_k14_schedules_match_plain_version(cuda, case, dtype, b_case):
    """K14 against its plain version, bit for bit (NaN as NaN), on the
    schedules the redesign runs: a widest level past one cluster's threads
    (walked in turn by 8 CTAs), a cluster taking each level in one step,
    W >= 9 (a slot's entries over several steps) on one CTA and on a
    cluster, and
    small models of the card's limits (a cluster of 2 or 3 CTAs of a few
    slots, row 0 in a wide level or the last one); +-inf and NaN in b."""
    from spmv_tpu_torch.kernels import trisolve as ttri

    T, lower, unit, limits = _k14_case(case)
    dt = getattr(torch, dtype)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(T.n_rows)
                         .astype(np.float32))
    if b_case == "inf_nan":
        b[[-300, -40, -1]] = torch.tensor([float("inf"), float("nan"), -float("inf")])
    args, kw = _tri_inputs(cuda, T, lower, unit, dt, b, **limits)
    sched = kw["sched"]
    live = sched["live"]
    if case == "wider_than_a_cluster":
        assert sched["cluster"] == 8 and int(live.max()) > 8 * sched["slots"]
        assert int(live[kw["l0"]]) > 8 * 1024  # row 0 in a level wider than the cluster
    if case == "cluster_one_pass":
        assert sched["cluster"] == 8 and 1024 < int(live.max()) <= 8 * sched["slots"]
    if case.startswith("w_at_least_9"):
        assert args[1].shape[2] >= 9 and sched["wchunk"] == ttri.K14_WREG
        assert sched["cluster"] == (1 if case == "w_at_least_9" else 4)
    before = ttri._sptrsv_pass.launches
    got = ttri._sptrsv_pass(*args, **kw)
    assert ttri._sptrsv_pass.launches == before + 1
    want = ttri._sptrsv_plain(*args, n=kw["n"])
    torch.cuda.synchronize()
    _k14_equal(got, want)


@pytest.mark.parametrize("case", ["wider_than_a_cluster", "small_cluster_in_turn"])
def test_k14_cluster_replays_in_a_graph(cuda, case):
    """A cluster launch captured in a CUDA graph: one kernel node, its
    replay equal to the eager call bit for bit."""
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.utils.timing import capture_graph

    T, lower, unit, limits = _k14_case(case)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(T.n_rows)
                         .astype(np.float32))
    args, kw = _tri_inputs(cuda, T, lower, unit, torch.float32, b, **limits)
    assert kw["sched"]["cluster"] > 1
    want = ttri._sptrsv_pass(*args, **kw)
    out = []
    g = capture_graph(lambda: out.append(ttri._sptrsv_pass(*args, **kw)), "K14", cuda)
    assert _port_kernels(g) == {"sptrsv_kernel": 1}
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want)


def test_k14_refuses_a_bad_schedule(cuda):
    """A schedule the launcher does not take raises, and nothing falls back:
    5 entries a step (it holds 4), a cluster of 9, no schedule."""
    from spmv_tpu_torch.kernels import trisolve as ttri

    T = _lower_random(300, 0.05, 5)
    b = torch.ones(T.n_rows)
    args, kw = _tri_inputs(cuda, T, True, False, torch.float32, b)
    sched = kw["sched"]
    for bad in (dict(wchunk=5), dict(cluster=9)):
        with pytest.raises(RuntimeError, match="spmv_sptrsv"):
            ttri._sptrsv_pass(*args, **dict(kw, sched=dict(sched, **bad)))
    with pytest.raises(ValueError, match="schedule"):
        ttri._sptrsv_pass(*args, **dict(kw, sched=None))


@pytest.mark.parametrize("cluster,threads", [(1, 1024), (1, 64), (4, 256), (8, 128)])
def test_k14_chain_probe(cuda, cluster, threads):
    from spmv_tpu_torch.kernels import trisolve as ttri

    x = ttri._k14_chain_probe(3001, cluster, threads, cuda)
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.arange(3001, dtype=torch.float32))


def test_ilu0_apply_is_two_k14_launches(cuda):
    """Two K14 launches an apply: by the wrapper's count eagerly, and as
    the kernel nodes of an apply captured in a CUDA graph."""
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.utils.timing import capture_graph

    L, U = ttri.ilu0(poisson2d(40))
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(1600)
                         .astype(np.float32)).to(cuda)
    ttri.ilu0_apply(L, U, r)
    before = ttri._sptrsv_pass.launches
    z = ttri.ilu0_apply(L, U, r)
    assert ttri._sptrsv_pass.launches - before == 2
    out = []
    g = capture_graph(lambda: out.append(ttri.ilu0_apply(L, U, r)), "ilu0_apply", cuda)
    assert _port_kernels(g) == {"sptrsv_kernel": 2}
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], z)
    np.testing.assert_array_equal(z.cpu().numpy(), ttri.ilu0_apply(L, U, r.cpu()).numpy())


@pytest.mark.parametrize("M", [None, "jacobi", "ilu0"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_graphed_solver_equals_its_eager_chunks(cuda, solver, M):
    """A solve by replayed graph against the same chunks run eagerly (a
    callable M applying the same preconditioner): the same iters and x
    bit for bit, and the host read once per chunk plus once."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.ops.registry import plan_cache

    A = poisson2d(40)
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(A.n_rows)
                         .astype(np.float32)).to(cuda)
    f = getattr(spmv_tpu_torch, solver)
    if M == "ilu0":
        L, U = plan_cache(A, ("ilu0",), lambda: ttri.ilu0(A))
        eager_M = lambda r: ttri.ilu0_apply(L, U, r)
    elif M == "jacobi":
        dinv = (1.0 / torch.from_numpy(A.to_dense().diagonal().copy())).to(cuda)
        eager_M = lambda r: dinv * r
    else:
        eager_M = lambda r: r
    reads = solvers.host_reads
    xg, ig = f(A, b, rtol=1e-6, M=M, kind="csr_vector")
    graph_reads = solvers.host_reads - reads
    xe, ie = f(A, b, rtol=1e-6, M=eager_M, kind="csr_vector")
    assert ig == ie and ig["converged"]
    assert torch.equal(xg, xe)
    assert graph_reads == 1 + -(-ig["iters"] // solvers.CHUNK)
    per_iter = 2 if solver == "bicgstab" else 1  # matvecs and M applies
    want = {"dia_kernel": per_iter * solvers.CHUNK}
    if M == "ilu0":
        want["sptrsv_kernel"] = 2 * per_iter * solvers.CHUNK
    assert _port_kernels(_solver_graph(A, solver, "csr_vector", M, b.device)) == want


def test_benchmark_fn_chains_device_time(cuda):
    """The harness's timing on the card: kernel_s is the slope of two
    graph chains, positive and below the host-observed call; cpu_naive
    is timed by calls and says so."""
    from spmv_tpu_torch.utils import timing

    A = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(A.n_cols)
                         .astype(np.float32)).to(cuda)
    for kind in ("stream", "xla", "cpu_naive"):
        r = timing.benchmark_spmv(kind, A, x, iters=8)
        assert r.kernel_s > 0 and r.delta["within_gate"]
    assert timing.timing_of("cpu_naive", cuda) == "calls, CUDA events"
    assert timing.timing_of("stream", cuda) == "graph chain"


# --- GMRES on the device: K15, a cycle a graph; the multi-device matvec replayed

def _hessenberg(m, seed, close_at=None, scale=1.0):
    """tests/test_torch_gmres.py's: a random (m+1, m) upper Hessenberg
    matrix in float32, a positive subdiagonal, a dominant diagonal and the
    entries above it N(0, scale^2); with `close_at` = k, H[k+1, k] = 0 and
    the columns after k zero."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((m + 1, m)), -1)
    H[np.triu_indices(m + 1, 1, m)] *= scale
    H[np.arange(m), np.arange(m)] += 3.0
    H[np.arange(1, m + 1), np.arange(m)] = 0.5 + rng.random(m)
    if close_at is not None:
        H[close_at + 1, close_at] = 0.0
        H[:, close_at + 1:] = 0.0
    return H.astype(np.float32)


@pytest.mark.parametrize("m,close_at", [(1, None), (2, None), (8, None), (32, None),
                                        (40, None), (160, None), (32, 3), (32, 0),
                                        (40, 38), (161, None), (161, 150), (224, None),
                                        (225, None), (300, None), (300, 260),
                                        (512, None), (513, None), (1000, None),
                                        (1000, 960)])
def test_k15_matches_its_plain_version(cuda, m, close_at):
    """K15 against its plain version on the card, bit for bit: both round
    every float64 operation once, in the same order. m covers the
    register bodies (1, 2, 4, 5 and 7 columns a lane, the work area in
    shared memory, up to 224) and the wide body (225 on, the work area in
    the scratch); past m = 160 the entries above the diagonal are scaled
    by 2 / sqrt(m), as tests/test_torch_gmres.py's large cases."""
    from spmv_tpu_torch.kernels import krylov

    H = torch.from_numpy(_hessenberg(m, m, close_at,
                                     1.0 if m <= 160 else 2 / np.sqrt(m))).to(cuda)
    for beta in (1.5, 0.0):
        b = torch.tensor(beta, device=cuda)
        before = krylov.hessenberg_lstsq.launches
        y = krylov.hessenberg_lstsq(H, b)
        assert krylov.hessenberg_lstsq.launches == before + 1
        want = krylov._hessenberg_lstsq_plain(H, b)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and torch.equal(y, want)
        if close_at is not None:
            assert torch.all(y[close_at + 1:] == 0)
        if beta == 0.0:
            assert torch.all(y == 0)


def test_k15_refuses_what_it_does_not_take(cuda):
    from spmv_tpu_torch.kernels import krylov

    b = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="m >= 1"):
        krylov.hessenberg_lstsq(torch.zeros(1, 0, device=cuda), b)
    with pytest.raises(ValueError, match="dtype"):
        krylov.hessenberg_lstsq(torch.zeros(9, 8, device=cuda, dtype=torch.float64), b)
    with pytest.raises(ValueError, match="shape"):
        krylov.hessenberg_lstsq(torch.zeros(8, 8, device=cuda), b)


@pytest.mark.parametrize("m", [32, 300])
def test_k15_replays_in_a_graph(cuda, m):
    """K15 captured in a CUDA graph (at m = 300 with its scratch from the
    graph's pool) and replayed on new H and beta in place: y equal to an
    eager launch bit for bit, one K15 node."""
    from spmv_tpu_torch.kernels import krylov
    from spmv_tpu_torch.utils.timing import capture_graph, graph_kernels

    sc = 1.0 if m <= 160 else 2 / np.sqrt(m)
    H = torch.from_numpy(_hessenberg(m, 1, scale=sc)).to(cuda)
    b = torch.tensor(1.5, device=cuda)
    krylov.hessenberg_lstsq(H, b)
    out = []
    g = capture_graph(lambda: out.append(krylov.hessenberg_lstsq(H, b)), "K15", cuda)
    assert graph_kernels(g, ("hessenberg_lstsq_kernel",)) == {"hessenberg_lstsq_kernel": 1}
    H.copy_(torch.from_numpy(_hessenberg(m, 2, scale=sc)))
    b.fill_(-0.75)
    g.replay()
    want = krylov.hessenberg_lstsq(H, b)
    torch.cuda.synchronize()
    assert torch.equal(out[0], want)
    assert torch.equal(want, krylov._hessenberg_lstsq_plain(H, b))


def test_k15_scratch_rule(cuda):
    """K15's scratch, as its launcher rules: none while the work area fits
    in shared memory (m <= 224), then the work area and the carried row,
    3 m + m (m-1) / 2 doubles."""
    from spmv_tpu_torch.kernels import krylov

    tri = lambda m: m * (m - 1) // 2
    assert [krylov._k15_scratch(m) for m in (1, 32, 160, 224)] == [0, 0, 0, 0]
    assert [krylov._k15_scratch(m) for m in (225, 1000, 70000)] == \
        [3 * m + tri(m) for m in (225, 1000, 70000)]


@pytest.mark.parametrize("m", [1, 32, 160, 1000])
def test_k15_chain_probe(cuda, m):
    """The probe's chain on the card equals the same chain in Python
    floats bit for bit: the card rounds each float64 operation once."""
    from spmv_tpu_torch.kernels import krylov

    got = krylov._k15_chain_probe(m, cuda).cpu()
    assert got.tolist() == list(krylov._k15_chain_plain(m))


def _nonsym(n, seed=3):
    """tests/test_torch_solvers.py's diagonally dominant nonsymmetric matrix."""
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    off = ~np.isin(rows * n + cols, np.arange(n) * n + np.arange(n))
    _, uniq = np.unique(rows * n + cols, return_index=True)
    keep = uniq[off[uniq]]
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32) * 0.1
    return spmv_tpu_torch.coo_to_csr(spmv_tpu_torch.COO(
        n, n, np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)]),
        np.concatenate([vals, np.full(n, 5.0, np.float32)])))


@pytest.mark.parametrize("case", ["stream", "xla", "jacobi", "ilu0", "restart_8"])
def test_graphed_gmres_equals_its_eager_cycles(cuda, case, monkeypatch):
    """gmres on the card by replayed graph against the same cycles run
    eagerly (a callable M applying the same preconditioner): the same
    iters and x bit for bit, the host read once before
    the first chunk and once per ceil(CHUNK / m) cycles, one K15 node a
    cycle in the graph and no torch.linalg.lstsq call."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.kernels import trisolve as ttri
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.utils.timing import graph_kernels

    kind, M, m = "csr_vector", None, 32
    if case in ("stream", "xla"):
        A, kind = _nonsym(30000), case
    elif case == "restart_8":
        A, m = poisson2d(24), 8
    else:
        A, M = poisson2d(40), case
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(A.n_rows)
                         .astype(np.float32)).to(cuda)
    if M == "ilu0":
        L, U = plan_cache(A, ("ilu0",), lambda: ttri.ilu0(A))
        eager_M = lambda r: ttri.ilu0_apply(L, U, r)
    elif M == "jacobi":
        dinv = (1.0 / torch.from_numpy(A.to_dense().diagonal().copy())).to(cuda)
        eager_M = lambda r: dinv * r
    else:
        eager_M = lambda r: r

    def refuse(*a, **k):
        raise AssertionError("gmres called torch.linalg.lstsq")

    monkeypatch.setattr(torch.linalg, "lstsq", refuse)
    solve = lambda M_: spmv_tpu_torch.gmres(A, b, rtol=1e-5, restart=m, M=M_, kind=kind)
    solve(M)  # captures the cycle's graph
    reads = solvers.host_reads
    xg, ig = solve(M)
    graph_reads = solvers.host_reads - reads
    xe, ie = solve(eager_M)
    assert ig == ie and ig["converged"]
    assert torch.equal(xg, xe)
    per_chunk = -(-solvers.CHUNK // m)
    assert graph_reads == 1 + -(-(ig["iters"] // m) // per_chunk)
    key = solvers.graph_key("gmres", kind, M, torch.float32, b.device, restart=m)
    nodes = graph_kernels(plan_cache(A, key, None)[0],
                          ("hessenberg_lstsq_kernel", "dia_kernel", "sptrsv_kernel"))
    assert nodes["hessenberg_lstsq_kernel"] == per_chunk
    if kind == "csr_vector":
        assert nodes["dia_kernel"] == per_chunk * (m + 1)
    if M == "ilu0":
        assert nodes["sptrsv_kernel"] == per_chunk * 2 * (m + 1)


def test_gmres_restart_200_matches_the_cpu(cuda):
    """gmres(restart=200), past K15's old limit of 160, on a CUDA A by
    graph against the port's CPU run: the same iters, x within the gmres
    tests' rtol 2e-3 (tests/test_torch_gmres.py), one K15 node a cycle."""
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.utils.timing import graph_kernels

    A = _nonsym(4096)
    b_np = np.random.default_rng(19).standard_normal(A.n_rows).astype(np.float32)
    xc, ic = spmv_tpu_torch.gmres(A, torch.from_numpy(b_np), rtol=1e-5, restart=200)
    b = torch.from_numpy(b_np).to(cuda)
    spmv_tpu_torch.gmres(A, b, rtol=1e-5, restart=200)  # captures the cycle's graph
    xg, ig = spmv_tpu_torch.gmres(A, b, rtol=1e-5, restart=200)
    assert ig["converged"] and ic["converged"] and ig["iters"] == ic["iters"], (ig, ic)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=2e-3, atol=2e-3)
    key = solvers.graph_key("gmres", "xla", None, torch.float32, b.device, restart=200)
    nodes = graph_kernels(plan_cache(A, key, None)[0], ("hessenberg_lstsq_kernel",))
    assert nodes == {"hessenberg_lstsq_kernel": -(-solvers.CHUNK // 200)}


@pytest.mark.parametrize("impl,mode", [("csr", "halo"), ("csr", "allgather"),
                                       ("stream", None)])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_distributed_replay_equals_the_eager_body(dist_case, impl, mode, ring):
    """On a local mesh on the card, `matvec` captures after the first call
    of a key and then replays: y equal to `_matvec_eager`'s bit for bit,
    global and sharded x, and each y a fresh tensor that
    a later call with another x leaves as it was."""
    from spmv_tpu_torch.ops.semiring import BUILTIN_SEMIRINGS
    from spmv_tpu_torch.parallel import distribute_stream

    A, x, d = dist_case
    sr = BUILTIN_SEMIRINGS[ring]
    if impl == "stream":
        d = distribute_stream(A, d.mesh)
    kw = {} if mode is None else {"mode": mode}
    rng = np.random.default_rng(4)
    xs = [np.abs(v) if ring == "max_times" else v
          for v in (x, rng.standard_normal(A.n_cols).astype(np.float32))]
    if ring == "or_and":
        xs = [np.where(rng.random(v.size) < 0.7, 0.0, v).astype(np.float32) for v in xs]
    x1, x2 = (torch.from_numpy(v).to(d.mesh.device) for v in xs)
    for layout in ("global", "sharded"):
        a, b2 = (x1, x2) if layout == "global" else (d.shard_x(x1), d.shard_x(x2))
        d.matvec(a, semiring=sr, **kw)  # eager, then captured
        assert (sr, mode, torch.float32, a.dim()) in d.graphs
        y1 = d.matvec(a, semiring=sr, **kw)
        keep = y1.clone()
        y2 = d.matvec(b2, semiring=sr, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y1, keep) and y1.data_ptr() != y2.data_ptr()
        for got, xv in ((y1, a), (y2, b2)):
            want = d._matvec_eager(xv, semiring=sr, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_graph_edges_reads_a_fork_and_a_join(cuda):
    """A graph captured with a fork onto a side stream and a join back:
    A on the main stream, then B on the side stream beside C on the main
    one, then D after both. `graph_edges` returns those four kernel
    nodes and exactly the edges A->B, A->C, B->D, C->D."""
    from spmv_tpu_torch.utils.timing import capture_graph, graph_edges

    a = torch.zeros(4096, device=cuda)
    b = torch.ones(4096, device=cuda)
    side = torch.cuda.Stream(cuda)

    def body():
        main = torch.cuda.current_stream()
        a.fill_(1.0)  # A
        side.wait_stream(main)  # the fork
        with torch.cuda.stream(side):
            b.mul_(2.0)  # B
        a.neg_()  # C
        main.wait_stream(side)  # the join
        a.add_(b)  # D

    body()
    torch.cuda.synchronize()
    names, edges = graph_edges(capture_graph(body, "a fork and a join", cuda))
    stems = ("FillFunctor", "MulFunctor", "neg_kernel", "CUDAFunctor_add")
    node = {st: [i for i, n in enumerate(names) if st in n] for st in stems}
    assert len(names) == 4 and all(len(v) == 1 for v in node.values()), names
    A, B, C, D = (node[st][0] for st in stems)
    assert sorted(edges) == sorted([(A, B), (A, C), (B, D), (C, D)]), (names, edges)


def test_nccl_halo_graph_keeps_the_exchange_apart_from_the_self_block(dist_case, tmp_path):
    """`distribute_csr` on a one-rank NCCL process group, halo mode: the
    exchange starts before the self block and is joined before the halo
    block, so the captured graph has no path between the exchange's
    node (at world size 1 NCCL copies: a memcpy node) and the self
    block's K11' or its fold, and the halo block's K11' lies downstream
    of it; the replay equals `_matvec_eager` bit for bit (K16 folds in a
    fixed order)."""
    import torch.distributed as tdist

    from spmv_tpu_torch.parallel import distribute_csr, init_distributed, make_mesh
    from spmv_tpu_torch.utils.timing import exchange_order, graph_edges

    A, x, _ = dist_case
    assert init_distributed(init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                            rank=0, backend="nccl") == 1
    try:
        d = distribute_csr(A, make_mesh("shards", distributed=True))
        xt = torch.from_numpy(x).to(d.mesh.device)
        d.matvec(xt)  # eager, then captured
        names, edges = graph_edges(d.graphs[PLUS_TIMES, "halo", torch.float32, 1][0])
        order = exchange_order(names, edges, exchange="memcpy")
        assert order == {"self": "apart", "fold": "apart", "halo": "downstream",
                         "exchange nodes": 1}, (order, names, edges)
        x2 = torch.from_numpy(np.random.default_rng(8).standard_normal(A.n_cols)
                              .astype(np.float32)).to(d.mesh.device)
        got, want = d.matvec(x2), d._matvec_eager(x2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    finally:
        tdist.destroy_process_group()


# --- K16: the sorted-segment fold (kernels/fold.py, csrc/fold_kernels.cu)

K16_RINGS = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS, "max_times": MAX_TIMES,
             "or_and": OR_AND, "or_and_counting": OR_AND_COUNTING}


def _k16_inputs(shape, B, ring, data, dtype, seed, seg_dtype=np.int64):
    """(vals, seg, n_segments, identity) on the CPU, made as the CPU tests
    make them (tests/test_torch_segment_fold.py)."""
    from test_torch_segment_fold import _seg, _vals

    rng = np.random.default_rng(seed)
    seg, n_seg = _seg(shape, B, rng)
    vals = torch.from_numpy(_vals(seg.size, B, ring, data, rng)).to(dtype)
    return (vals, torch.from_numpy(seg.astype(seg_dtype)), n_seg,
            float(K16_RINGS[ring].identity_for(dtype)))


def _k16_check(cuda, ring, args, exact_plain):
    """K16 on the card: one launch, its NumPy order (tests/k16_model.py)
    bit for bit (NaN as NaN), and the plain version on the CPU bit for
    bit (a zero of either sign) or within one ulp of the value dtype."""
    from k16_model import CODES, k16_model
    from test_torch_segment_fold import _same_bits, _within_ulp

    from spmv_tpu_torch.ops.semiring import _segment_reduce_plain

    vals, seg, n_seg, ident = args
    sr = K16_RINGS[ring]
    before = tfold.segment_fold.launches
    got = tfold.segment_fold(vals.to(cuda), seg.to(cuda), n_seg, sr, ident)
    torch.cuda.synchronize()
    assert tfold.segment_fold.launches == before + (1 if seg.numel() else 0)
    got = got.cpu()
    model = k16_model(vals, seg, n_seg, CODES[ring], ident)
    nan = torch.isnan(model)
    assert torch.equal(torch.isnan(got), nan)
    bits = (lambda t: t.view(torch.int32 if t.dtype == torch.float32 else torch.int16))
    assert torch.equal(bits(got)[~nan], bits(model)[~nan])
    want = _segment_reduce_plain(vals, seg, n_seg, sr, ident)
    (_same_bits if exact_plain else _within_ulp)(got, want)


@pytest.mark.parametrize("seg_dtype", ["int32", "int64"])
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("dtype", list(VALUE_DTYPES))
@pytest.mark.parametrize("data", ["int", "normal"])
@pytest.mark.parametrize("ring", list(K16_RINGS))
def test_k16_matches_its_order_and_plain_version(cuda, ring, data, dtype, B, seg_dtype):
    """Integer data bit for bit in every ring; normal data (+-inf, NaN and
    signed zeros in min and max) bit for bit against K16's order and
    bit for bit (min, max) or within one ulp (sums) against the plain
    version."""
    if data == "normal" and ring not in ("plus_times",):
        data = "special" if ring in ("min_plus", "max_times") else "int"
    args = _k16_inputs("gaps", B, ring, data, VALUE_DTYPES[dtype], 11,
                       np.int32 if seg_dtype == "int32" else np.int64)
    _k16_check(cuda, ring, args, exact_plain=data != "normal")


K16_SHAPES = ["empty", "singletons", "span", "gaps", "past", "whole", "long_gaps",
              "tile_m1", "tile_0", "tile_p1", "hub"]


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("shape", K16_SHAPES)
@pytest.mark.parametrize("ring,data", [("plus_times", "int"), ("max_times", "int"),
                                       ("plus_times", "normal")])
def test_k16_on_every_seg_shape(cuda, ring, data, shape, B):
    """Every seg shape of the CPU tests, and a hub row over more tiles
    than one look-back step reads (B = 1: 1064 tiles): bit for bit with
    K16's order; with the plain version bit for bit on integer data,
    within one ulp on normal data."""
    _k16_check(cuda, ring, _k16_inputs(shape, B, ring, data, torch.float32, 12),
               exact_plain=data == "int")


@pytest.fixture(scope="module")
def wide_row_ids():
    """wide_row's row ids: power_law_csr(1 << 20, 1 << 20, 16.7M, alpha
    1.5, seed 42), 8192 tiles of K16, many times the blocks resident."""
    A = power_law_csr(1 << 20, 1 << 20, 16_777_216, alpha=1.5, seed=42)
    return torch.from_numpy(np.asarray(A.row_ids())), A.n_rows


@pytest.mark.parametrize("ring,data", [("plus_times", "normal"), ("plus_times", "int"),
                                       ("min_plus", "special"), ("or_and", "int")])
def test_k16_wide_row_matches_its_order(cuda, wide_row_ids, ring, data):
    from test_torch_segment_fold import _vals

    seg, n_seg = wide_row_ids
    vals = torch.from_numpy(_vals(seg.numel(), 1, ring, data, np.random.default_rng(17)))
    _k16_check(cuda, ring, (vals, seg, n_seg, float(K16_RINGS[ring].identity_for(np.float32))),
               exact_plain=data != "normal")


@pytest.mark.parametrize("shape", ["gaps", "long_gaps", "whole", "hub", "tile_p1"])
@pytest.mark.parametrize("seg_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ring,dtype", [("plus_times", torch.float32),
                                        ("min_plus", torch.float32),
                                        ("min_plus", torch.bfloat16),
                                        ("min_plus", torch.int32)])
def test_k16_is_one_kernel_node_a_call(cuda, shape, seg_dtype, ring, dtype):
    """A B = 1 fold is one kernel node and one memset (the identity's
    1-, 2- or 4-byte pattern into y and into the look-back records that
    follow it) in a captured graph, with no fill or carry-level launch;
    ten calls and the graph's replay give y bit for bit, that of the
    NumPy order."""
    from spmv_tpu_torch.utils.timing import capture_graph, graph_edges, graph_kernels

    vals, seg, n_seg, ident = _k16_inputs(shape, 1, ring, "normal", dtype, 13, seg_dtype)
    from k16_model import CODES, k16_model

    v, s = vals.to(cuda), seg.to(cuda)
    fold = lambda: tfold.segment_fold(v, s, n_seg, K16_RINGS[ring], ident)  # noqa: E731
    want = fold()
    assert torch.equal(want.cpu(), k16_model(vals, seg, n_seg, CODES[ring], ident))
    for _ in range(10):
        assert torch.equal(fold(), want)
    out = []
    graph = capture_graph(lambda: out.append(fold()), f"K16 {shape}", cuda)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want)
    nodes = graph_kernels(graph)
    assert len(nodes) == 1 and list(nodes.values()) == [1], nodes
    assert "fold_rows_kernel" in next(iter(nodes)), nodes
    names, _ = graph_edges(graph)
    assert [k for k in names if k in ("memset", "memcpy")] == ["memset"], names


# the fold paths of the dtype matrix (tests/test_torch_dtypes.py): A's
# values and x's dtype -> the card's result against the CPU port's
INT_FOLD_PATHS = {
    "xla": lambda A, x, sr: spmv_tpu_torch.spmv("xla", A, x, semiring=sr),
    "spmm_auto": lambda A, x, sr: spmv_tpu_torch.spmm(A, x, semiring=sr, method="auto"),
    "spmm_window": lambda A, x, sr: spmv_tpu_torch.spmm(A, x, semiring=sr, method="window"),
    "spmm_xla": lambda A, x, sr: spmv_tpu_torch.spmm(A, x, semiring=sr, method="xla"),
}


def _int_fold_case(ax_dtype, x_dtype, path, seed):
    """A power-law matrix with values of `ax_dtype` and an x (or X of 5
    columns) of `x_dtype`: integer A and x span their range, so int32
    products and sums wrap; floating ones are small integers, so every
    float16 sum is exact."""
    rng = np.random.default_rng(seed)
    A = power_law_csr(3000, 2500, 30000, alpha=1.5, seed=seed)
    big = np.dtype(ax_dtype).kind in "iub"
    if np.dtype(ax_dtype) == np.bool_:
        ax = rng.integers(0, 2, A.nnz).astype(bool)
    elif big:
        info = np.iinfo(ax_dtype)
        ax = rng.integers(info.min, info.max, A.nnz, endpoint=True).astype(ax_dtype)
    else:
        ax = rng.integers(-4, 5, A.nnz).astype(ax_dtype)
    A = spmv_tpu_torch.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, ax)
    shape = (A.n_cols,) if path == "xla" else (A.n_cols, 5)
    if np.dtype(x_dtype).kind in "iu":
        lim = 1 << (28 if np.dtype(x_dtype).itemsize >= 4 else 6)
        x = rng.integers(-lim, lim, shape).astype(x_dtype)
    else:
        x = rng.integers(-4, 5, shape).astype(x_dtype)
    return A, torch.from_numpy(x)


def _same_nan_as_nan(got, want):
    """Bit for bit, a NaN as a NaN (a float16 A with a wide integer x
    overflows to +-inf on both sides, and their sums to NaN)."""
    if got.dtype.is_floating_point:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        got, want = got[~nan], want[~nan]
    assert torch.equal(got, want)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - a raise is one of the outcomes compared
        return None, e


@pytest.mark.parametrize("x_dtype", ["int32", "int64", "float16"])
@pytest.mark.parametrize("ax_dtype", ["int8", "float16", "float32"])
@pytest.mark.parametrize("path", list(INT_FOLD_PATHS))
def test_fold_paths_give_the_cpu_ports_dtype_and_bits(cuda, path, ax_dtype, x_dtype):
    """int8 A with an int32 or int64 x gives int32 y on the card, bit for
    bit the CPU port's (and the reference's), through K16 (and K13 for
    the window); every other pair gives the CPU port's dtype and bits, or
    raises where it raises."""
    A, x = _int_fold_case(ax_dtype, x_dtype, path, 18)
    fn = INT_FOLD_PATHS[path]
    want, e_cpu = _outcome(lambda: fn(A, x, PLUS_TIMES))
    before = tfold.segment_fold.launches
    got, e_card = _outcome(lambda: fn(A, x.to(cuda), PLUS_TIMES))
    assert (e_cpu is None) == (e_card is None), (e_cpu, e_card)
    if e_cpu is not None:
        assert type(e_cpu) is type(e_card), (e_cpu, e_card)
        return
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == want.dtype, (got.dtype, want.dtype)
    _same_nan_as_nan(got.cpu(), want)
    assert tfold.segment_fold.launches > before
    if ax_dtype == "int8" and x_dtype != "float16":
        assert got.dtype == torch.int32


@pytest.mark.parametrize("ring", list(K16_RINGS))
@pytest.mark.parametrize("ax_dtype,x_dtype", [("int8", "int32"), ("int64", "int32"),
                                              ("bool", "int8"), ("int16", "uint8")])
@pytest.mark.parametrize("path", ["xla", "spmm_window", "spmm_xla"])
def test_integer_folds_in_every_ring_as_the_cpu_port(cuda, path, ax_dtype, x_dtype, ring):
    """Integer values in each built-in ring (int32 min-plus sums and
    products wrap), and the narrower integers K13 and K16 widen to int32
    and narrow back: the CPU port's dtype and bits."""
    A, x = _int_fold_case(ax_dtype, x_dtype, path, 19)
    fn, sr = INT_FOLD_PATHS[path], K16_RINGS[ring]
    want = fn(A, x, sr)
    got = fn(A, x.to(cuda), sr)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    _same_nan_as_nan(got.cpu(), want)


def test_k16_refuses_what_it_does_not_take(cuda):
    """float64 values are not ported (NotImplementedError); int32 values
    fold (one launch, the plain version's bits), while uint32, which the
    CPU's index_add_ refuses too, raises ValueError; a segment id on
    another device or of another length raises, and so does a min-plus
    fold under autograd; none of the raises launches."""
    from spmv_tpu_torch.ops.semiring import _segment_reduce_plain

    seg = torch.zeros(8, dtype=torch.int32, device=cuda)
    ints = torch.arange(8, dtype=torch.int32) * (1 << 29)  # the sum wraps
    before = tfold.segment_fold.launches
    got = tfold.segment_fold(ints.to(cuda), seg, 2, PLUS_TIMES, 0)
    assert tfold.segment_fold.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(
        got.cpu(), _segment_reduce_plain(ints, seg.cpu(), 2, PLUS_TIMES, 0))
    with pytest.raises(NotImplementedError):
        _segment_reduce_plain(torch.ones(8, dtype=torch.uint32), seg.cpu(), 2, PLUS_TIMES, 0)
    before = tfold.segment_fold.launches
    with pytest.raises(NotImplementedError, match="K16"):
        tfold.segment_fold(torch.ones(8, dtype=torch.float64, device=cuda), seg, 2,
                           PLUS_TIMES, 0.0)
    with pytest.raises(ValueError, match="K16"):
        tfold.segment_fold(torch.ones(8, dtype=torch.uint32, device=cuda), seg, 2,
                           PLUS_TIMES, 0.0)
    with pytest.raises(ValueError, match="seg"):
        tfold.segment_fold(torch.ones(8, device=cuda), seg.cpu(), 2, PLUS_TIMES, 0.0)
    with pytest.raises(ValueError, match="seg"):
        tfold.segment_fold(torch.ones(9, device=cuda), seg, 2, PLUS_TIMES, 0.0)
    with pytest.raises(NotImplementedError, match="plus-times"):
        tfold.segment_fold(torch.ones(8, device=cuda, requires_grad=True), seg, 2,
                           MIN_PLUS, float("inf"))
    assert tfold.segment_fold.launches == before


def _hub_paths(cuda):
    """power_law_csr(30000, 30000, 400000, alpha 1.5, seed 13), whose hub
    rows span many of K16's chunks, and each slice path on it as a
    function of a static input on the card."""
    from spmv_tpu_torch.ops.autodiff import spmv_values
    from spmv_tpu_torch.parallel import distribute_csr, make_mesh

    A = power_law_csr(30000, 30000, 400000, alpha=1.5, seed=13)
    assert np.diff(np.asarray(A.Ap)).max() > 10000
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal(A.n_cols).astype(np.float32)).to(cuda)
    X = torch.from_numpy(rng.standard_normal((A.n_cols, 128)).astype(np.float32)).to(cuda)
    Ax = torch.from_numpy(rng.standard_normal(A.nnz).astype(np.float32)).to(cuda)
    d = distribute_csr(A, make_mesh("shards", n_shards=4, device=cuda))
    return A, {
        "csr_vector_ell": (lambda: spmv_tpu_torch.spmv("csr_vector_ell", A, x)),
        "xla": (lambda: spmv_tpu_torch.spmv("xla", A, x)),
        "spmm_window": (lambda: spmv_tpu_torch.spmm(A, X, method="window")),
        "spmm_xla": (lambda: spmv_tpu_torch.spmm(A, X, method="xla")),
        "distribute_csr": (lambda: d._matvec_eager(x)),
        "spmv_values": (lambda: spmv_values(A, Ax, x)),
    }, d, x


@pytest.mark.parametrize("path", ["csr_vector_ell", "xla", "spmm_window", "spmm_xla",
                                  "distribute_csr", "spmv_values"])
def test_slice_paths_repeat_bit_for_bit_and_capture_k16(cuda, path):
    """Ten calls and a CUDA graph's replay give y bit for bit on a matrix
    with hub rows; the eager call launches K16, and the captured call has
    K16's nodes and no index_add_ or scatter_reduce_ node (distribute_csr: its
    matvec's own graph, the halo mode's)."""
    from spmv_tpu_torch.utils.timing import capture_graph, graph_kernels

    A, paths, d, x = _hub_paths(cuda)
    fn = paths[path]
    before = tfold.segment_fold.launches
    want = fn()
    torch.cuda.synchronize()
    assert tfold.segment_fold.launches > before
    for _ in range(10):
        assert torch.equal(fn(), want)
    if path == "distribute_csr":
        d.matvec(x)  # eager, then captured
        got = d.matvec(x)
        graph = d.graphs[PLUS_TIMES, "halo", torch.float32, 1][0]
    else:
        out = []
        graph = capture_graph(lambda: out.append(fn()), path, cuda)
        graph.replay()
        got = out[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    nodes = graph_kernels(graph)
    assert any("fold_rows_kernel" in k or "fold_cols_kernel" in k for k in nodes), nodes
    # index_add_ runs torch's indexFunc kernels, scatter_reduce_ its
    # scatter kernel with a Reduce functor (a gather's is TensorAssign)
    assert not [k for k in nodes if "index_add" in k or "indexFunc" in k
                or ("scatter" in k and "Reduce" in k)]


def test_spmv_values_grad_and_jvp_through_k16(cuda):
    """spmv_values on the card under autograd and torch.func.jvp: the
    fold is K16 (`_SegmentSum`: its VJP the gather g[row], its JVP K16 on
    the tangent), within rtol of the CPU's plain autograd."""
    from spmv_tpu_torch.ops.autodiff import spmv_values

    A = power_law_csr(5000, 5000, 40000, alpha=1.5, seed=15)
    rng = np.random.default_rng(15)
    ax, x = (rng.standard_normal(n).astype(np.float32) for n in (A.nnz, A.n_cols))
    tx = rng.standard_normal(A.n_cols).astype(np.float32)
    out = {}
    for dev in (cuda, "cpu"):
        Ax = torch.tensor(ax, device=dev, requires_grad=True)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        before = tfold.segment_fold.launches
        g = torch.autograd.grad((spmv_values(A, Ax, xt) ** 2).sum(), (Ax, xt))
        y, ty = torch.func.jvp(lambda v: spmv_values(A, torch.tensor(ax, device=dev), v),
                               (torch.tensor(x, device=dev),),
                               (torch.tensor(tx, device=dev),))
        launched = tfold.segment_fold.launches - before
        assert launched >= (3 if dev == cuda else 0) and (dev == cuda or launched == 0)
        out[str(dev)] = [t.detach().cpu().numpy() for t in (*g, y, ty)]
    for a, b in zip(*out.values()):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


# --- host inputs: NumPy arrays go to the card unless the CPU is asked for


def _wrapper_counts():
    from spmv_tpu_torch.kernels import trisolve as ttri

    return [w.launches for w in (
        tstream._xprep_pass, tstream._reduce_diff_pass, tstream._reduce_roll_pass,
        tstream._gather_pass, tstream._gather_split_pass, tstream._scan_diff_pass,
        tstream._scan_roll_pass, tshuffle._run_split, tpg._pgather_pass,
        tell._group_reduce_pass, tdia._dia_pass, tmerge._merge_group_pass,
        tspmm._spmm_window_pass, ttri._sptrsv_pass, tfold.segment_fold)]


def _moved(fn):
    """fn() after a synchronize -> (its result, the launches it moved)."""
    torch.cuda.synchronize()
    before = _wrapper_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [b - a for a, b in zip(before, _wrapper_counts())]


@pytest.mark.parametrize("entry", ["spmv", "spmm", "sptrsv", "ilu0_apply"])
def test_host_inputs_go_to_the_card(cuda, entry):
    """A NumPy input with no device goes to the card (the reference's
    jnp.asarray puts it on the TPU): the result is on the card, the same
    kernels launch as on the CUDA tensor, and the result equals that
    call's bit for bit."""
    from spmv_tpu_torch.kernels.trisolve import ilu0, ilu0_apply, sptrsv

    rng = np.random.default_rng(21)
    if entry == "spmv":
        A = power_law_csr(16384, 16384, 90000, seed=11)
        v = rng.standard_normal(A.n_cols)  # float64: narrowed to float32
        fn = lambda u: spmv_tpu_torch.spmv("stream", A, u)
    elif entry == "spmm":
        A = power_law_csr(8000, 7000, 60000, seed=9)
        v = rng.standard_normal((A.n_cols, 128)).astype(np.float32)
        fn = lambda u: spmv_tpu_torch.spmm(A, u, method="window")
    else:
        L, U = ilu0(poisson2d(40))
        v = rng.standard_normal(L.n_rows).astype(np.float32)
        fn = ((lambda u: sptrsv(L, u, lower=True, unit_diagonal=True)) if entry == "sptrsv"
              else (lambda u: ilu0_apply(L, U, u)))
    vc = torch.from_numpy(v.astype(np.float32)).to(cuda)
    got, c_host = _moved(lambda: fn(v))
    want, c_card = _moved(lambda: fn(vc))
    assert got.device == want.device and got.device.type == "cuda"
    assert any(c_host) and c_host == c_card
    assert torch.equal(got, want)
    if entry == "spmv":  # asked for the CPU: the plain versions, no launch
        spmv_tpu_torch.config.set_default_device("cpu")
        try:
            y, c = _moved(lambda: fn(v))
        finally:
            spmv_tpu_torch.config.set_default_device(None)
        assert y.device.type == "cpu" and not any(c)
        np.testing.assert_allclose(y.numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)


def test_cg_on_a_host_b_runs_on_the_card(cuda):
    """cg on a NumPy b solves on the card (K12 launched, by the first
    chunk run eagerly before the capture) and takes the same iterations
    to the same x, bit for bit, as on the CUDA tensor."""
    A = poisson2d(64)
    b = np.random.default_rng(0).standard_normal(A.n_rows).astype(np.float32)
    (x, info), c = _moved(lambda: spmv_tpu_torch.cg(A, b, rtol=1e-6, kind="csr_vector"))
    assert x.device.type == "cuda" and info["converged"]
    assert c[10] > 0 and sum(c) == c[10]  # K12 only
    xc, ic = spmv_tpu_torch.cg(A, torch.from_numpy(b).to(cuda), rtol=1e-6, kind="csr_vector")
    assert info == ic and torch.equal(x, xc)


def test_a_failed_capture_raises_naming_the_kind(cuda):
    """The host kind cannot be captured (it copies x to the host): the
    capture raises, naming the call, and is never turned into an eager
    run. Kept last in this file: it leaves a failed capture behind."""
    from spmv_tpu_torch.utils.timing import capture_graph

    A = spmv_tpu_torch.CSR(*_banded(500))
    x = torch.ones(500, device=cuda)
    spmv_tpu_torch.spmv("cpu_naive", A, x)
    with pytest.raises(RuntimeError, match="cpu_naive.*CUDA graph capture failed"):
        capture_graph(lambda: spmv_tpu_torch.spmv("cpu_naive", A, x), "spmv('cpu_naive')",
                      cuda)
