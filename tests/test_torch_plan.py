"""The seam between the packages: for the same matrix and policy the
port's planner emits the reference planner's plan arrays, bit for bit,
and the on-disk v11 plan format is shared."""

import numpy as np
import pytest
import torch

from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.kernels import stream as jstream
from spmv_tpu.utils import plancache as jcache
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.ops import tuning as ttuning
from spmv_tpu_torch.utils import plancache as tcache

torch.set_num_threads(1)

POLICY = {"kappa": 12288}


def _hot_columns():
    # half the nnz on a handful of columns (tests/test_stream.py:30-43)
    rng = np.random.default_rng(4)
    n, nnz = 20000, 120000
    rows = rng.integers(0, n, nnz).astype(np.int64)
    cols = np.where(rng.random(nnz) < 0.5, rng.integers(0, 5, nnz),
                    rng.integers(0, n, nnz)).astype(np.int64)
    vals = rng.standard_normal(nnz)
    return coo_to_csr(COO(n, n, rows.astype(np.int32), cols.astype(np.int32),
                          vals.astype(np.float32)))


MATRICES = {
    "power_law_90k": lambda: power_law_csr(16384, 16384, 90000, seed=11),
    "power_law_400k": lambda: power_law_csr(65536, 65536, 400000, seed=3),
    "hot_columns": _hot_columns,
    "random_150k": lambda: random_csr(20000, 30000, 150000, seed=1),
}


def _port_csr(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_plan(pj, pt):
    """Every scalar and array of the reference plan `pj` equals the
    port's `pt`: gather, reduce, scan, each shuffle pass and its kernel
    arrays, slot_of_dst and the hot columns."""
    for f in ("n_gather_tiles", "n_final_tiles", "layers", "x_rows_pad",
              "n_y_blocks"):
        assert getattr(pj, f) == getattr(pt, f), f
    _eq(pj.hot_cols, pt.hot_cols, "hot_cols")
    for group in ("gather", "scan", "reduce"):
        dj, dt = getattr(pj, group), getattr(pt, group)
        if dj is None:
            assert dt is None, group
            continue
        assert set(dj) == set(dt), (group, set(dj) ^ set(dt))
        for k, v in dj.items():
            if isinstance(v, (int, float)):
                assert v == dt[k], f"{group}.{k}"
            else:
                _eq(v, dt[k], f"{group}.{k}")
    assert len(pj.shuffle.passes) == len(pt.shuffle.passes)
    assert (pj.shuffle.in_rows, pj.shuffle.out_rows) == \
        (pt.shuffle.in_rows, pt.shuffle.out_rows)
    for i, (a, b) in enumerate(zip(pj.shuffle.passes, pt.shuffle.passes)):
        for f in ("n_steps", "sbt", "K", "Q", "in_rows", "out_rows"):
            assert getattr(a, f) == getattr(b, f), f"pass {i}.{f}"
        for f in ("s1", "s2", "s3", "starts", "pos"):
            _eq(getattr(a, f), getattr(b, f), f"pass {i}.{f}")
        assert set(pj.shuffle_dev[i]) == set(pt.shuffle_dev[i])
        for k, v in pj.shuffle_dev[i].items():
            _eq(v, pt.shuffle_dev[i][k], f"pass {i} kernel array {k}")
    _eq(pj.shuffle.slot_of_dst, pt.shuffle.slot_of_dst, "slot_of_dst")


@pytest.fixture(scope="module")
def plans():
    """Reference plans (native planner on), built once per matrix."""
    cache = {}

    def get(name):
        if name not in cache:
            A = MATRICES[name]()
            cache[name] = (A, jstream.build_stream_plan(
                A, jstream.StreamPolicy(**POLICY)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(MATRICES))
def test_plan_arrays_match_reference(plans, name):
    assert tnative.available()
    A, pj = plans(name)
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    assert_same_plan(pj, pt)
    # early reduction with the lane remap on the power-law matrices; the
    # comparison above covers K7's run starts (rs) and K8's row ids
    # (relid), which only the generic-ring kernels read
    assert (pt.reduce is not None) == name.startswith("power_law")
    assert "relid" in pj.scan and (pt.reduce is None or "rs" in pj.reduce)


def test_plan_arrays_match_reference_without_native(monkeypatch):
    """Both planners' NumPy fallbacks (no native library) agree too. The
    fallback's Euler coloring picks other, equally valid route stages
    than the native one, so it is held against the reference's own
    fallback."""
    from spmv_tpu import native as jnative

    A = power_law_csr(16384, 16384, 90000, seed=11)
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not tnative.available() and not jnative.available()
    pj = jstream.build_stream_plan(A, jstream.StreamPolicy(**POLICY))
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    assert_same_plan(pj, pt)


# the H100 row's policies (ops/tuning.py), each width's once
H100_ROWS = [dict(t) for t in sorted({tuple(sorted(f.items()))
                                      for f in ttuning.CHIP_TABLES["h100"].values()})]


@pytest.mark.parametrize("policy", [{"kappa": 4096, "reduce": "on"},
                                    {"kappa": 8192, "remap": False},
                                    {"kappa": 6144, "reduce": "off"}, *H100_ROWS])
def test_plan_arrays_match_reference_other_policies(policy):
    A = power_law_csr(16384, 16384, 60000, seed=12)
    pj = jstream.build_stream_plan(A, jstream.StreamPolicy(**policy))
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**policy))
    assert_same_plan(pj, pt)
    assert tstream.plan_cache_key(tstream.StreamPolicy(**policy)) == \
        jstream.plan_cache_key(jstream.StreamPolicy(**policy))


def test_reference_plan_file_loads_in_port(plans, tmp_path):
    A, pj = plans("power_law_90k")
    path = str(tmp_path / "ref.npz")
    jcache.save_plan(pj, path)
    loaded = tcache.load_plan(path)
    built = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    assert_same_plan(pj, loaded)
    assert_same_plan(built, loaded)
    assert tcache.plan_key(_port_csr(A), tstream.StreamPolicy(**POLICY)) == \
        jcache.plan_key(A, jstream.StreamPolicy(**POLICY))


def test_port_plan_file_round_trips_both_ways(plans, tmp_path):
    A, pj = plans("random_150k")
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    path = str(tmp_path / "port.npz")
    tcache.save_plan(pt, path)
    assert_same_plan(pt, tcache.load_plan(path))
    assert_same_plan(jcache.load_plan(path), pt)
    # a device plan serialises too (arrays come back to the host)
    tcache.save_plan(pt.to("cpu"), path)
    assert_same_plan(pt, tcache.load_plan(path))


def test_stream_plan_cached_builds_then_loads(tmp_path):
    A = _port_csr(power_law_csr(8192, 8192, 40000, seed=9))
    pol = tstream.StreamPolicy(**POLICY)
    first = tcache.stream_plan_cached(A, pol, str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    assert_same_plan(first, tcache.stream_plan_cached(A, pol, str(tmp_path)))


def test_device_plan_keeps_dtypes(plans):
    A, _ = plans("power_law_90k")
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    dev = pt.to("cpu")
    want = {"q": torch.int8, "xb": torch.int32, "g0": torch.int32,
            "xr1": torch.uint8, "Ax": torch.float32}
    for k, dt in want.items():
        assert dev.gather[k].dtype == dt, k
    assert dev.reduce["c3"].dtype == torch.uint8
    assert dev.reduce["rs"].dtype == torch.int8  # K7's run starts
    assert dev.scan["valid2"].dtype == torch.int8
    assert dev.scan["relid"].dtype == torch.int16
    assert dev.scan["counts"].dtype == torch.int32
    for p, d in zip(pt.shuffle.passes, dev.shuffle_dev):
        assert d["starts"].dtype == torch.int32 and d["pos"].dtype == torch.int32
        assert d["gaps"].dtype == torch.int64
        assert d["s1"].shape == (p.n_steps * p.sbt * 128, 128)


def test_audit_plan_matches_reference(plans):
    A, pj = plans("power_law_90k")
    pt = tstream.build_stream_plan(_port_csr(A), tstream.StreamPolicy(**POLICY))
    assert tstream.audit_plan(pt, A.nnz) == jstream.audit_plan(pj, A.nnz)
