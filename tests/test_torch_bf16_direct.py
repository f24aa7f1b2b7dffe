"""bfloat16 and float16 values off the stream path, on the CPU: the plain
versions of K9, K10, K11, K12, K13 and K11', and their paths against the
reference.

- Each plain version (`_pgather_plain`, `_merge_group_plain`,
  `_group_reduce_plain`, `_dia_plain`, `_spmm_window_plain`,
  `_local_ell_plain`) in bf16 and f16 widens to float32 (float64 for
  K10's sums), runs the ring's operations and rounds to the value dtype
  once, where its kernel writes: its result equals its float32 run on
  the widened inputs, rounded, bit for bit (so within one ulp in
  plus-times too), on made tiles and on built plans; K9, a move, gives
  the input's bits.
- Each path (csr_vector_ell, merge_tiled, dia and csr_vector on a banded
  matrix, spmm by window and auto, distribute_csr and distribute_stream
  on a 4-shard local mesh) returns the reference's y dtype for every
  (Ax, x) pair of bf16, f16 and f32, or raises where the reference
  raises (the reference traced by jax.eval_shape, which traces its
  Pallas kernels in interpret mode).
- On small matrices, min-plus in bf16 and max-times in f16 equal the
  reference's y bit for bit (interpret mode): rounding is monotone, so
  rounding once gives what rounding every partial gives. Plus-times is
  held against the float64 oracle: within 0.08 of max(1, max|y|) in bf16
  (tests/test_kernels.py:131-148's gate), and in f16, on data of
  multiples of 1/2, no farther from it than the reference.
- The row fold (`segment_reduce_sorted`) sums a bf16 hub row in float64
  and rounds once.
- The halo plan and the stacked ELL blocks of a bf16 CSR, its Ax an
  ml_dtypes array or a torch.bfloat16 tensor, equal the reference's
  through a uint16 view.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import banded_csr, power_law_csr
from spmv_tpu.ops import semiring as jsr
from spmv_tpu.parallel import dist_spmv as jds
from spmv_tpu.parallel import dist_stream as jdst
from spmv_tpu.parallel import partition as jpart
from spmv_tpu_torch.formats import CSR, as_values, host_values
from spmv_tpu_torch.kernels import csr_vector as tcv
from spmv_tpu_torch.kernels import dia as tdia
from spmv_tpu_torch.kernels import ell as tell
from spmv_tpu_torch.kernels import merge as tmerge
from spmv_tpu_torch.kernels import pgather as tpg
from spmv_tpu_torch.kernels import spmm as tspmm
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.parallel import dist_spmv as tds
from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh
from spmv_tpu_torch.parallel import partition as tpart
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
NP = {"bfloat16": BF16, "float16": np.float16, "float32": np.float32}
RINGS = {"plus_times": (jsr.PLUS_TIMES, tsr.PLUS_TIMES),
         "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS),
         "max_times": (jsr.MAX_TIMES, tsr.MAX_TIMES)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _rounded_once(got, want32, dtype):
    """got (2-byte) equals the float32 result rounded to its dtype, bit for
    bit (NaN as the rounding of the float32 NaN)."""
    assert got.dtype == dtype and want32.dtype in (torch.float32, torch.float64)
    assert torch.equal(_bits(got), _bits(want32.to(dtype)))


def _normal(rng, shape, ring="plus_times"):
    """float32 data for a ring: normal, with +inf in 10% for min-plus and
    non-negative for max-times."""
    a = rng.standard_normal(shape).astype(np.float32)
    if ring == "min_plus":
        a[rng.random(shape) < 0.1] = np.inf
    if ring == "max_times":
        a = np.abs(a)
    return torch.from_numpy(a)


def _csr(A, Ax, as_tensor=False):
    """The port's CSR of A's pattern with values Ax (a NumPy or ml_dtypes
    array; as a torch tensor with as_tensor)."""
    ax = torch.from_numpy(np.asarray(Ax).view(np.int16)).view(torch.bfloat16) \
        if as_tensor and np.asarray(Ax).dtype == BF16 else np.asarray(Ax)
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), ax)


def _typed(A, dtype_name, f=lambda v: v):
    """(reference CSR, port CSR) of A's pattern, values f(Ax) in dtype."""
    ax = f(np.asarray(A.Ax, np.float32)).astype(NP[dtype_name])
    return (spmv_tpu.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, ax), _csr(A, ax))


# --- the plain versions: float32 registers, rounding at the write --------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stream", ["random", "bucketed"])
def test_pgather_plain_moves_the_bits(dtype, stream):
    """K9's plain version moves each value's bits: x[idx], 0 where dead;
    `bucketed` lands the stream on 50 of the 128 sublanes (3 rounds)."""
    rng = np.random.default_rng(1)
    n_cols, n = 40000, 50000
    if stream == "random":
        idx = rng.integers(-1, n_cols, n)
    else:
        idx = rng.integers(0, n_cols // 128, n) * 128 + rng.integers(0, 50, n)
    plan = tpg.build_paged_gather_plan(idx, n_cols)
    assert plan is not None and (stream == "random" or plan.rounds == 3)
    p = plan.to("cpu")
    x = _normal(rng, n_cols).to(DTYPES[dtype])
    x[:3] = torch.tensor([float("inf"), -0.0, float("nan")])
    args = (p.qlo, p.qhi, p.s1, p.s2, p.s3)
    got = tpg._pgather_plain(x, *args, C=p.n_chunks, R=p.rounds)
    _rounded_once(got, tpg._pgather_plain(x.float(), *args, C=p.n_chunks, R=p.rounds),
                  x.dtype)
    want = torch.where(torch.from_numpy(idx >= 0), x[torch.from_numpy(idx).clamp(min=0)],
                       torch.zeros((), dtype=x.dtype))
    assert torch.equal(_bits(got.reshape(-1)[:n]), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("W,strategy", [(1, "tree"), (2, "linear"), (4, "tree"),
                                        (16, "linear"), (32, "broadcast"), (128, "tree")])
def test_group_reduce_plain_rounds_once(dtype, ring, W, strategy):
    sr = RINGS[ring][1]
    prod = _normal(np.random.default_rng(W), (24, 128), ring).to(DTYPES[dtype])
    got = tell._group_reduce_plain(prod, W=W, strategy=strategy, sr=sr)
    _rounded_once(got, tell._group_reduce_plain(prod.float(), W=W, strategy=strategy,
                                                sr=sr), prod.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
def test_ell_plan_products_and_leaders_in_16_bits(dtype, ring):
    """On csr_vector_ell's built plan: the products (glue, the value
    dtype, as the reference forms them) and K11's plain leaders."""
    A = power_law_csr(3000, 3000, 24000, seed=1)
    _, At = _typed(A, dtype, np.abs if ring != "plus_times" else (lambda v: v))
    sr = RINGS[ring][1]
    plan = tcv.csr_ell_plan(At, "cpu")
    x = _normal(np.random.default_rng(2), A.n_cols, ring).to(DTYPES[dtype])
    prod = tell.ell_products(At, x, sr, plan)
    assert prod.dtype == DTYPES[dtype]
    got = tell._group_reduce_pass(prod, W=plan.width, strategy="tree", sr=sr)
    want = tell._group_reduce_plain(prod.float(), W=plan.width, strategy="tree",
                                    sr=sr)[:, ::plan.width]
    _rounded_once(got, want, prod.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("policy", ["tuned", "stock"])
@pytest.mark.parametrize("data", ["made", "built"])
def test_merge_group_plain_rounds_once(dtype, ring, policy, data):
    """K10's plain version on bench-like merge plans in both route
    branches (the spare row, tuned; the masked reduction, stock): sums
    scanned and carried in float64, other rings in float32, y rounded
    once. `made` products are random (cancelling sums), `built` ones the
    x read of phase A."""
    A = power_law_csr(6000, 6000, 60000, seed=4)
    _, At = _typed(A, dtype, np.abs if ring != "plus_times" else (lambda v: v))
    sr = RINGS[ring][1]
    pol = tmerge.TUNED_POLICY if policy == "tuned" else tmerge.STOCK_POLICY
    plan = tmerge.device_merge_plan(At, pol, "cpu")
    S, P = pol.nnz_per_tile // 128, pol.rows_per_tile // 128
    rng = np.random.default_rng(3)
    if data == "built":
        prod = tmerge.merge_products(At, _normal(rng, A.n_cols, ring).to(DTYPES[dtype]),
                                     sr, plan)
    else:
        prod = _normal(rng, tuple(plan.rel_tiles.view(-1, 128).shape), ring).to(DTYPES[dtype])
    rest = (plan.rel_tiles.view(-1, 128), plan.pr1, plan.pr2, plan.pr3, plan.r_start,
            plan.lrow, plan.cnt)
    got = tmerge._merge_group_pass(prod, *rest, sr=sr, S=S, P=P)
    _rounded_once(got, tmerge._merge_group_plain(prod.float(), *rest, sr=sr, S=S, P=P),
                  prod.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("data", ["made", "built"])
def test_dia_plain_rounds_once(dtype, ring, data):
    """K12's plain version on a made plan of 9 random diagonals over 1001
    rows (not a multiple of 4) and on a banded matrix's built plan."""
    sr = RINGS[ring][1]
    rng = np.random.default_rng(5)
    dt = DTYPES[dtype]
    if data == "made":
        n, offs = 1001, np.sort(rng.choice(np.arange(-600, 600), 9, replace=False))
        vals = _normal(rng, (9, n), ring).to(dt)
        valid = torch.from_numpy((rng.random((9, n)) < 0.8).astype(np.int8))
        offsets = torch.from_numpy(offs.astype(np.int32))
    else:
        B = banded_csr(3000, bandwidth=3, seed=2)
        _, Bt = _typed(B, dtype, np.abs if ring != "plus_times" else (lambda v: v))
        vals, valid, offsets = tdia.device_dia_plan(Bt, "cpu", dt)
        n = B.n_rows
    x = _normal(rng, n, ring).to(dt)
    got = tdia._dia_pass(vals, valid, x, offsets, sr=sr)
    _rounded_once(got, tdia._dia_plain(vals.float(), valid, x.float(), offsets, sr=sr), dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("data", ["made", "built"])
def test_spmm_window_plain_rounds_once(dtype, ring, data):
    """K13's plain version: one combine a product, rounded once; on made
    tiles (random windows and slots) and on a built window plan."""
    sr = RINGS[ring][1]
    dt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    if data == "made":
        T, rows = 24, 1024
        ax = _normal(rng, (T, 128), ring).to(dt)
        q = torch.from_numpy(rng.integers(0, 128, (T, 128)).astype(np.int32))
        xb = torch.from_numpy(rng.integers(0, rows // 128, T).astype(np.int32))
    else:
        A = power_law_csr(3000, 2500, 20000, seed=8)
        d = tspmm.device_window_plan(_typed(A, dtype)[1], dt, "cpu")
        ax, q, xb, rows = d["ax"], d["q"], d["xb"], d["rows_pad"]
    X = _normal(rng, (rows, 128), ring).to(dt)
    got = tspmm._spmm_window_pass(X, ax, q, xb, sr=sr)
    _rounded_once(got, tspmm._spmm_window_plain(X.float(), ax.float(), q, xb, sr=sr), dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
@pytest.mark.parametrize("W", [1, 2, 8, 128])
def test_local_ell_plain_rounds_once(dtype, ring, W):
    """K11''s plain version on made blocks of 2 shards x 3 tiles."""
    sr = RINGS[ring][1]
    dt = DTYPES[dtype]
    rng = np.random.default_rng(W)
    shape, C = (2, 3, 8, 128), 700
    aj = torch.from_numpy(rng.integers(0, C, shape).astype(np.int32))
    ax = _normal(rng, shape, ring).to(dt)
    valid = torch.from_numpy(rng.random(shape) < 0.7)
    xsrc = _normal(rng, (2, C), ring).to(dt)
    got = tds._local_ell_pass(aj, ax, valid, xsrc, W=W, sr=sr)
    _rounded_once(got, tds._local_ell_plain(aj, ax.float(), valid, xsrc.float(), W=W,
                                            sr=sr), dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_local_ell_plain_on_built_blocks(dtype):
    """K11''s plain version on distribute_csr's stacked self and halo
    blocks of a power-law matrix over 4 shards, A's values in the value
    dtype, x table in it too."""
    A = power_law_csr(4000, 4000, 30000, seed=3)
    _, At = _typed(A, dtype)
    d = distribute_csr(At, make_mesh("shards", n_shards=4, device="cpu"))
    xs = d.shard_x(_normal(np.random.default_rng(1), A.n_cols).to(DTYPES[dtype]))
    for blk, xsrc in (("self", xs), ("halo", d.x_table(xs))):
        b = d.dev[blk]
        assert b["ax"].dtype == DTYPES[dtype]
        got = tds._local_ell_pass(b["aj"], b["ax"], b["valid"], xsrc, W=b["W"],
                                  sr=tsr.PLUS_TIMES)
        _rounded_once(got, tds._local_ell_plain(b["aj"], b["ax"].float(), b["valid"],
                                                xsrc.float(), W=b["W"], sr=tsr.PLUS_TIMES),
                      DTYPES[dtype])


# --- the row fold ---------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", [0, 8])
def test_fold_sums_a_16_bit_hub_row_in_float64(dtype, cols):
    """segment_reduce_sorted in plus-times: a hub row of 30000 bf16 or f16
    values of mixed sign, with 500 short rows after it, is summed in
    float64 and rounded once (through float32, as torch converts a
    float64 tensor); (n,) and (n, B) values alike."""
    rng = np.random.default_rng(7)
    seg = np.sort(np.concatenate([np.zeros(30000, np.int64), rng.integers(1, 501, 2000)]))
    shape = (seg.size,) + ((cols,) if cols else ())
    vals = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DTYPES[dtype])
    y = tsr.segment_reduce_sorted(vals, torch.from_numpy(seg), 600, tsr.PLUS_TIMES, 0.0)
    want = np.zeros((600,) + shape[1:])
    np.add.at(want, seg, vals.double().numpy())
    _rounded_once(y, torch.from_numpy(want), DTYPES[dtype])


# --- the halo plan and the stacked blocks carry bf16 as its bits ----------

@pytest.mark.parametrize("as_tensor", [False, True], ids=["ml_dtypes", "torch"])
def test_bf16_halo_plan_and_blocks_equal_reference(as_tensor):
    from test_torch_parallel import HALO_ARRAYS, HALO_INTS, _eq

    A = power_law_csr(1500, 1500, 16000, seed=3)
    ax = np.asarray(A.Ax, np.float32).astype(BF16)
    Aj = spmv_tpu.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, ax)
    At = _csr(A, ax, as_tensor)
    pj, pt = jpart.build_halo_plan(Aj, 4), tpart.build_halo_plan(At, 4)
    for f in HALO_INTS:
        assert getattr(pj, f) == getattr(pt, f), f
    for f in HALO_ARRAYS:
        a = getattr(pj, f)
        _eq(a.view(np.uint16) if a.dtype == BF16 else a, getattr(pt, f), f)
    for blk in ("self", "halo"):
        rows, cols = getattr(pt, f"rows_{blk}"), getattr(pt, f"cols_{blk}")
        W = tds._block_width(rows, pt.R)
        bj = jds._block_ell_plans(rows, cols, getattr(pj, f"vals_{blk}"), pj.R, W)
        bt = tds._block_ell_plans(rows, cols, getattr(pt, f"vals_{blk}"), pt.R, W)
        assert bj["ax"].dtype == BF16 and bt["ax"].dtype == np.uint16
        bj["ax"] = bj["ax"].view(np.uint16)
        for k in ("aj", "ax", "valid", "vrow", "Tv", "V", "W"):
            _eq(bj[k], bt[k], f"{blk}.{k}")
    d = distribute_csr(At, make_mesh("shards", n_shards=4, device="cpu"))
    assert d.dev["self"]["ax"].dtype == torch.bfloat16


# --- the paths against the reference --------------------------------------

def _jmesh():
    return Mesh(np.array(jax.devices()[:4]), ("shards",))


def _tmesh():
    return make_mesh("shards", n_shards=4, device="cpu")


PATHS = ("csr_vector_ell", "merge_tiled", "dia", "csr_vector", "spmm_window", "spmm_auto",
         "distribute_csr", "distribute_stream")


def _matrix(path):
    if path in ("dia", "csr_vector"):
        return banded_csr(2000, bandwidth=2, seed=9)
    if path == "distribute_stream":  # test_parallel.py's: its planner takes it
        return power_law_csr(5000, 5000, 40000, seed=1)
    return power_law_csr(1000, 1000, 8000, seed=1)


def _X(x):
    """spmm's X from x: 8 columns, x times 1/4, 1/2, ..., 32 (exact in
    every value dtype)."""
    return x[:, None] * (2.0 ** np.arange(-2, 6)).astype(x.dtype)


def _runners(path, Aj, At, jring=jsr.PLUS_TIMES, tring=tsr.PLUS_TIMES):
    """(reference call, port call, the reference's x length) of `path`:
    each call takes x (a vector; spmm takes _X(x)) and returns y. A
    distributed reference takes x at its padded length as placed."""
    if path.startswith("spmm"):
        method = path.split("_")[1]
        return (lambda x: spmv_tpu.spmm(Aj, _X(x), jring, method=method),
                lambda x: spmv_tpu_torch.spmm(At, _X(x), tring, method=method), Aj.n_cols)
    if path.startswith("distribute"):
        jmk, tmk = ((jds.distribute_csr, distribute_csr) if path == "distribute_csr"
                    else (jdst.distribute_stream, distribute_stream))
        dj, dt = jmk(Aj, _jmesh()), tmk(At, _tmesh())
        return (lambda x: dj.matvec(x, semiring=jring),
                lambda x: dt.matvec(x, semiring=tring), dj.x_pad)
    return (lambda x: spmv_tpu.spmv(path, Aj, x, semiring=jring),
            lambda x: spmv_tpu_torch.spmv(path, At, x, semiring=tring), Aj.n_cols)


@pytest.mark.parametrize("a", list(NP))
@pytest.mark.parametrize("path", PATHS)
def test_y_dtype_of_every_value_pair_is_the_references(path, a):
    """y's dtype for Ax in `a` and x in bf16, f16 and f32 equals the
    reference's, or both raise. The reference is traced by jax.eval_shape
    (a distributed x at its padded length, which its matvec takes as
    placed)."""
    A = _matrix(path)
    Aj, At = _typed(A, a)
    ref, port, n = _runners(path, Aj, At)
    for b in NP:
        try:
            want = np.dtype(jax.eval_shape(ref, jax.ShapeDtypeStruct((n,), NP[b])).dtype)
        except Exception as e:  # noqa: BLE001 - any raise of the reference's
            want = type(e)
        x = np.linspace(-1, 1, A.n_cols).astype(NP[b])
        try:
            got = port(x).dtype
        except (TypeError, ValueError) as e:
            got = type(e)
        if isinstance(want, type):
            assert isinstance(got, type), (a, b, want, got)
        else:
            assert got == getattr(torch, want.name), (a, b, want, got)


def _halves(v):
    """Multiples of 1/2 in [-1, 1]: products are quarters, and every sum
    of the test matrices stays exact in float16 far past its rows."""
    return np.clip(np.round(v * 2), -2, 2) / 2


@pytest.mark.parametrize("path", [p for p in PATHS if p not in ("csr_vector", "spmm_auto")])
@pytest.mark.parametrize("dtype,ring", [("bfloat16", "min_plus"),
                                        ("float16", "max_times")])
def test_min_max_rings_equal_reference(path, dtype, ring):
    jring, tring = RINGS[ring]
    A = _matrix(path)
    f = (lambda v: np.abs(v) + 0.05) if ring == "min_plus" else (lambda v: _halves(np.abs(v)))
    Aj, At = _typed(A, dtype, f)
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal(A.n_cols)).astype(np.float32)
    if ring == "min_plus" and not path.startswith("spmm"):  # the one-hot product: NaN
        x[rng.random(A.n_cols) < 0.1] = np.inf
    x = (x if ring == "min_plus" else _halves(x)).astype(NP[dtype])
    ref, port, _ = _runners(path, Aj, At, jring, tring)
    yt = port(x)
    yj = np.asarray(ref(x))
    assert yt.dtype == DTYPES[dtype] and yj.dtype == NP[dtype]
    np.testing.assert_array_equal(_bits(yt).numpy(), yj.view(np.int16))


def _oracle(A, x):
    return spmv_tpu.spmv_ref(spmv_tpu.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                                          np.asarray(A.Ax, np.float64)),
                             np.asarray(x, np.float64), y_dtype=np.float64)


@pytest.mark.parametrize("path", [p for p in PATHS if p not in ("csr_vector", "spmm_auto")])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sums_against_the_oracle(path, dtype):
    """Plus-times: bf16 within 0.08 of max(1, max|y|) of the float64
    oracle on normal data; f16, on multiples of 1/2, no farther from the
    oracle than the reference's y."""
    A = _matrix(path)
    f = (lambda v: v) if dtype == "bfloat16" else _halves
    Aj, At = _typed(A, dtype, f)
    x = np.random.default_rng(5).standard_normal(A.n_cols).astype(np.float32)
    x = (x if dtype == "bfloat16" else _halves(x)).astype(NP[dtype])
    ref, port, _ = _runners(path, Aj, At)
    yt = port(x)
    assert yt.dtype == DTYPES[dtype]
    yt = yt.float().numpy()
    oracle = _oracle(Aj, x.astype(np.float64))
    if path.startswith("spmm"):
        oracle = _X(oracle)
    scale = max(1.0, np.abs(oracle).max())
    err = np.abs(yt - oracle).max() / scale
    if dtype == "bfloat16":
        assert err < 0.08, err
    else:
        yj = np.asarray(ref(x)).astype(np.float64)
        assert err <= np.abs(yj - oracle).max() / scale, err
