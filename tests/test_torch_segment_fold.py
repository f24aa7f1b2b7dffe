"""K16, the sorted-segment fold (kernels/fold.py, csrc/fold_kernels.cu),
on the CPU.

- K16's order written in NumPy (`tests/k16_model.py`: tiles, each
  thread's run, the warp tree and warp 0's scan of the warps' totals,
  the tiles' and groups' published partials, the fixed-shape look-back,
  y holding the identity before the fold, each segment written once;
  for B > 1 the chunks and carry levels) against the plain version
  (`ops/semiring.py:_segment_reduce_plain`): bit for bit on
  integer-valued data in the five device rings, min and max bit for bit
  with +-inf and NaN (NaN as NaN; a zero as a zero of either sign, see
  `_same_bits`), plus-times on normal data within one ulp of the value
  dtype; at B = 1, 3 and 128, in float32, bfloat16 and float16, with
  int32 and int64 segment ids, on seg shapes: n = 0, every element its
  own segment, one segment over 50 tiles or more, one segment over the
  whole input, empty segments at the start, middle and end, runs of empty
  rows longer than a tile there, n_segments past the last id, n at a
  tile size -1, +0 and +1; at small tile sizes, where a hub row spans more
  tiles than one look-back step reads; and on integer values (int32
  sums that wrap past 2**31, int64, and int8, uint8, int16 and bool,
  which fold as int32) bit for bit with index_add_ and scatter_reduce;
- the plain version against the reference's
  `spmv_tpu.ops.semiring.segment_reduce_sorted` (exact for min, max and
  or; plus-times within rtol 2e-4 / atol 1e-5, the float64-against-
  float32 difference the other fold tests pin);
- a CPU tensor takes the plain version with K16's counter unmoved;
- the window `spmm` passing `perm` equals K13's products taken by
  `index_select` and then folded.
"""

import numpy as np
import pytest
import torch

from k16_model import CODES, ITEMS, LANES, ROWS, THREADS, k16_model
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels import fold as tfold
from spmv_tpu_torch.kernels import spmm as tspmm
from spmv_tpu_torch.ops import semiring as tsr

torch.set_num_threads(1)

RINGS = {"plus_times": tsr.PLUS_TIMES, "min_plus": tsr.MIN_PLUS,
         "max_times": tsr.MAX_TIMES, "or_and": tsr.OR_AND,
         "or_and_counting": tsr.OR_AND_COUNTING}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SEG_DTYPES = {"int32": np.int32, "int64": np.int64}
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
SHAPES = ("empty", "singletons", "span", "gaps", "past", "whole", "long_gaps", "tile_m1",
          "tile_0", "tile_p1")
INT_DTYPES = {"int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
              "uint8": torch.uint8, "int16": torch.int16, "bool": torch.bool}


def _chunk(B):
    return THREADS * ITEMS if B == 1 else ROWS


def _seg(shape, B, rng):
    """(seg, n_segments) of a named shape."""
    C = _chunk(B)
    if shape == "empty":
        return np.zeros(0, np.int64), 5
    if shape == "singletons":
        n = 3 * C + 11
        return np.arange(n), n
    if shape == "span":  # one segment over 50 chunks and more, short ones around it
        lens = np.concatenate([rng.integers(1, 9, 40), [50 * C + 17], rng.integers(1, 9, 40)])
        return np.repeat(np.arange(lens.size), lens), lens.size
    if shape == "gaps":  # empty segments at the start, in the middle and at the end
        ids = np.sort(rng.choice(np.arange(3, 3 * C), 2 * C // 3, replace=False))
        lens = rng.integers(1, 6, ids.size)
        lens[ids.size // 2] = 2 * C + 5
        return np.repeat(ids, lens), 3 * C + 4
    if shape == "past":  # n_segments past the last id
        s, n = _seg("gaps", B, rng)
        return s, n + 2 * C
    if shape == "whole":  # one segment over the whole input
        return np.zeros(3 * C + 5, np.int64), 1
    if shape == "long_gaps":  # runs of empty rows longer than a tile: start, middle, end
        lens = rng.integers(1, 5, 3 * C // 4)
        ids = np.arange(lens.size) * 2 + 2 * C + 3
        ids[lens.size // 2:] += 3 * C
        return np.repeat(ids, lens), int(ids[-1]) + 2 * C + 7
    if shape.startswith("tile_"):  # n at a tile's size -1, +0, +1
        n = C + {"tile_m1": -1, "tile_0": 0, "tile_p1": 1}[shape]
        lens = rng.integers(1, 12, n)
        return np.repeat(np.arange(n), lens)[:n], n
    if shape == "hub":  # a hub row over more tiles than one look-back step reads
        if B > 1:
            return _seg("span", B, rng)
        lens = np.concatenate([rng.integers(1, 9, 40), [(LANES * LANES + 40) * C + 17],
                               rng.integers(1, 9, 40)])
        return np.repeat(np.arange(lens.size), lens), lens.size
    raise ValueError(shape)


def _vals(n, B, ring, data, rng):
    """float32 values (n,) or (n, B): integers (of {0, 1} for the or
    rings), normal, or integers with +-inf, NaN and signed zeros."""
    shape = (n,) if B == 1 else (n, B)
    if ring in ("or_and", "or_and_counting"):
        v = rng.integers(0, 2, shape).astype(np.float32)
    elif data == "normal":
        v = rng.standard_normal(shape).astype(np.float32)
    else:
        v = rng.integers(-8, 9, shape).astype(np.float32)
    if data == "special":
        u = rng.random(shape)
        v[u < 0.05] = np.inf
        v[(u >= 0.05) & (u < 0.1)] = -np.inf
        v[(u >= 0.1) & (u < 0.13)] = np.nan
        v[(u >= 0.13) & (u < 0.25)] = -0.0
        v[(u >= 0.25) & (u < 0.35)] = 0.0
    return v


def _identity(ring, dtype):
    return float(RINGS[ring].identity_for(dtype))


def _fold_both(ring, seg, n_seg, v, dtype, **model):
    vals = torch.from_numpy(v).to(dtype)
    seg_t = torch.from_numpy(seg)
    ident = _identity(ring, dtype)
    got = k16_model(vals, seg_t, n_seg, CODES[ring], ident, **model)
    want = tsr._segment_reduce_plain(vals, seg_t, n_seg, RINGS[ring], ident)
    return got, want


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _same_bits(got, want):
    """Bit for bit, NaN as NaN (any NaN) and a zero as a zero of either
    sign: the plain version's scatter_reduce keeps the earlier of +0 and
    -0 in a 1-D fold and the later in a 2-D one on the CPU (and adds by
    atomics on the card), so its sign of a tied zero is no contract."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    same = ~nan & ~((got == 0) & (want == 0))
    assert torch.equal(_bits(got)[same], _bits(want)[same])


def _within_ulp(got, want):
    """Within one ulp of the value dtype, element by element."""
    g, w = got.double(), want.double()
    ulp = ULP[want.dtype] * torch.maximum(g.abs(), w.abs())
    assert torch.all((g - w).abs() <= ulp + 1e-30), float((g - w).abs().max())


@pytest.mark.parametrize("seg_dtype", list(SEG_DTYPES))
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
def test_k16_order_matches_the_plain_version_on_integer_data(ring, dtype, B, seg_dtype):
    rng = np.random.default_rng(1)
    seg, n_seg = _seg("gaps", B, rng)
    seg = seg.astype(SEG_DTYPES[seg_dtype])
    got, want = _fold_both(ring, seg, n_seg, _vals(seg.size, B, ring, "int", rng),
                           DTYPES[dtype])
    _same_bits(got, want)


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ring", list(RINGS))
def test_k16_order_on_every_seg_shape(ring, shape, B):
    rng = np.random.default_rng(2)
    seg, n_seg = _seg(shape, B, rng)
    got, want = _fold_both(ring, seg, n_seg, _vals(seg.size, B, ring, "int", rng),
                           torch.float32)
    _same_bits(got, want)
    if shape in ("span", "whole"):
        assert np.bincount(seg).max() >= (50 if shape == "span" else 3) * _chunk(B)
    if shape == "long_gaps":
        runs = np.diff(np.concatenate([[-1], np.unique(seg), [n_seg]])) - 1
        assert runs[0] > _chunk(B) and runs[-1] > _chunk(B) and runs[1:-1].max() > _chunk(B)


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", ["min_plus", "max_times", "or_and"])
def test_k16_min_and_max_bit_for_bit_with_inf_and_nan(ring, dtype, B):
    """torch.minimum's and torch.maximum's rules: NaN propagates, and of
    two equal operands the earlier (scatter_reduce's amin and amax in a
    1-D fold on the CPU)."""
    rng = np.random.default_rng(3)
    seg, n_seg = _seg("gaps", B, rng)
    data = "int" if ring == "or_and" else "special"
    got, want = _fold_both(ring, seg, n_seg, _vals(seg.size, B, ring, data, rng),
                           DTYPES[dtype])
    _same_bits(got, want)
    if ring != "or_and":
        assert torch.isnan(want).any() and torch.isinf(want).any()


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k16_plus_times_on_normal_data_within_one_ulp(dtype, B):
    """The float64 sums in K16's order and in index_add_'s sequential
    order round to the same value dtype number or to its neighbour."""
    rng = np.random.default_rng(4)
    seg, n_seg = _seg("span", B, rng)
    got, want = _fold_both("plus_times", seg, n_seg,
                           _vals(seg.size, B, "plus_times", "normal", rng), DTYPES[dtype])
    _within_ulp(got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("ring", list(RINGS))
def test_k16_carry_levels_at_small_chunks(ring, B):
    """Tiles of 128 elements (2 warps of 2 items), whose hub row the
    look-back folds over many groups, or chunks of 4 rows: four and more
    carry levels, neutral pads in every one."""
    rng = np.random.default_rng(5)
    lens = np.concatenate([rng.integers(1, 4, 300), [3000], rng.integers(1, 4, 300)])
    seg = np.repeat(np.arange(lens.size) * 2 + 1, lens)
    n_seg = 2 * lens.size + 3
    got, want = _fold_both(ring, seg, n_seg, _vals(seg.size, B, ring, "int", rng),
                           torch.float32, threads=64, items=2, rows=4)
    _same_bits(got, want)


@pytest.mark.parametrize("lanes", [4, LANES])
@pytest.mark.parametrize("ring,data", [(r, "int") for r in RINGS] + [("plus_times", "normal")])
def test_k16_hub_row_past_one_look_back_step(ring, data, lanes):
    """Tiles of 128 elements (2 warps of 2 items): a hub row over more
    tiles than one look-back step of `lanes` group aggregates reads,
    between short rows and gaps; bit for bit on integer data in every
    ring, within one ulp on normal data (plus-times)."""
    rng = np.random.default_rng(10)
    T = 128
    lens = np.concatenate([rng.integers(1, 4, 50), [(lanes * lanes * 3 + 5) * T + 7],
                           rng.integers(1, 4, 50)])
    seg = np.repeat(np.arange(lens.size) * 3, lens)
    v = _vals(seg.size, 1, ring, data, rng)
    got, want = _fold_both(ring, seg, 3 * lens.size + 5, v, torch.float32, threads=64,
                           items=2, lanes=lanes)
    (_same_bits if data == "int" else _within_ulp)(got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", list(INT_DTYPES))
@pytest.mark.parametrize("ring", list(RINGS))
def test_k16_integer_values_bit_for_bit(ring, dtype, B):
    """Integer values fold in their own width: int32 sums that wrap past
    2**31 (and int64 ones past 2**63) equal index_add_'s, min and max
    equal scatter_reduce's; int8, uint8, int16 and bool fold as int32 and
    narrow back to the plain version's bits."""
    rng = np.random.default_rng(11)
    seg, n_seg = _seg("gaps", B, rng)
    shape = (seg.size,) if B == 1 else (seg.size, B)
    dt = INT_DTYPES[dtype]
    if dt == torch.bool:
        v = torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    else:
        info = torch.iinfo(dt)
        v = torch.from_numpy(rng.integers(info.min, info.max, shape, dtype=np.int64,
                                          endpoint=True)).to(dt)
    sr = RINGS[ring]
    ident = sr.identity_for(dt)
    got = k16_model(v, torch.from_numpy(seg), n_seg, CODES[ring], ident)
    want = tsr._segment_reduce_plain(v, torch.from_numpy(seg), n_seg, sr, ident)
    assert got.dtype == want.dtype == dt and torch.equal(got, want)
    if dt == torch.int32 and ring == "plus_times":  # the sums wrapped
        wide = tsr._segment_reduce_plain(v.long(), torch.from_numpy(seg), n_seg, sr, 0)
        assert not torch.equal(wide, want.long())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times", "or_and"])
def test_plain_version_matches_the_reference(ring, B):
    import jax.numpy as jnp

    from spmv_tpu.ops import semiring as jsr

    rng = np.random.default_rng(6)
    seg, n_seg = _seg("past", B, rng)
    data = "normal" if ring != "or_and" else "int"
    v = _vals(seg.size, B, ring, data, rng)
    v[rng.random(v.shape) < 0.05] = np.inf if ring == "min_plus" else v.max()
    ident = _identity(ring, np.float32)
    want = np.asarray(jsr.segment_reduce_sorted(
        jnp.asarray(v), jnp.asarray(seg.astype(np.int32)), n_seg,
        jsr.BUILTIN_SEMIRINGS[ring], ident))
    got = tsr._segment_reduce_plain(torch.from_numpy(v), torch.from_numpy(seg), n_seg,
                                    RINGS[ring], ident).numpy()
    if ring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("seg_dtype", list(SEG_DTYPES))
def test_cpu_tensor_takes_the_plain_version(seg_dtype, B):
    rng = np.random.default_rng(7)
    seg, n_seg = _seg("gaps", B, rng)
    seg_t = torch.from_numpy(seg.astype(SEG_DTYPES[seg_dtype]))
    vals = torch.from_numpy(_vals(seg.size, B, "plus_times", "normal", rng))
    before = tfold.segment_fold.launches
    for ring in RINGS.values():
        ident = float(ring.identity_for(np.float32))
        want = tsr._segment_reduce_plain(vals, seg_t, n_seg, ring, ident)
        for got in (tsr.segment_reduce_sorted(vals, seg_t, n_seg, ring, ident),
                    tfold.segment_fold(vals, seg_t, n_seg, ring, ident)):
            _same_bits(got, want)
    assert tfold.segment_fold.launches == before


def test_perm_reads_rows_in_place_on_the_cpu():
    rng = np.random.default_rng(8)
    P = torch.from_numpy(rng.standard_normal((500, 4)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(500)[:300])
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, 300)))
    for ring in RINGS.values():
        ident = float(ring.identity_for(np.float32))
        _same_bits(tsr.segment_reduce_sorted(P, seg, 45, ring, ident, perm=perm),
                   tsr.segment_reduce_sorted(P.index_select(0, perm), seg, 45, ring, ident))


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "max_times"])
def test_window_spmm_with_perm_equals_index_select_then_fold(ring):
    """`spmm(method="window")` hands K13's products and the plan's perm to
    the fold, which reads them in place: the same Y as the products taken
    to CSR order by index_select and folded."""
    sr = RINGS[ring]
    A = power_law_csr(600, 500, 5000, alpha=1.5, seed=3)
    X = torch.from_numpy(np.random.default_rng(9).standard_normal((500, 40))
                         .astype(np.float32))
    got = tspmm.spmm(A, X, semiring=sr, method="window")
    dev = tspmm.device_window_plan(A, np.float32, X.device)
    Xp = torch.nn.functional.pad(X, (0, 128 - 40, 0, dev["rows_pad"] - A.n_cols))
    P = tspmm._spmm_window_pass(Xp, dev["ax"], dev["q"], dev["xb"], sr=sr)
    ident = float(sr.identity_for(np.float32))
    want = tsr._segment_reduce_plain(P.index_select(0, dev["perm"].long()), dev["rows"],
                                     A.n_rows, sr, ident)[:, :40]
    _same_bits(got, want)
