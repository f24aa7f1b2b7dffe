"""The port's Matrix Market I/O and Kronecker generator against the
reference's: the cases of tests/test_io.py through
`spmv_tpu_torch.io.matrix_market`, native parser on and off, and for
the same files the reference's COO/CSR arrays bit for bit."""

import gzip
import io

import numpy as np
import pytest

from spmv_tpu.io import generate as jgen
from spmv_tpu.io import matrix_market as jmm
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.io import matrix_market as tmm

GENERAL = """%%MatrixMarket matrix coordinate real general
% a comment
3 4 5
1 1 1.0
1 4 2.0
2 2 3.0
3 1 4.0
3 3 5.0
"""

SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 1.0
2 1 2.0
3 2 3.0
3 3 4.0
"""

PATTERN = """%%MatrixMarket matrix coordinate pattern general
2 2 3
1 1
1 2
2 1
"""

INTEGER = """%%MatrixMarket matrix coordinate integer general
2 2 2
1 1 7
2 2 -3
"""

SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 5.0
3 2 -1.0
"""

ARRAY = """%%MatrixMarket matrix array real general
2 3
1.0
0.0
0.0
2.5
-3.0
0.0
"""

CASES = {"general": GENERAL, "symmetric": SYMMETRIC, "pattern": PATTERN,
         "integer": INTEGER, "skew": SKEW}


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    if request.param:
        assert tnative.available(), "the port's native library did not build"
    return request.param


def _file(tmp_path, text, name="m.mtx"):
    p = tmp_path / name
    p.write_text(text)
    return p


def _same_coo(a, b):
    assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)
    for f in ("rows", "cols", "vals"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)
    for f in ("Ap", "Aj", "Ax"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


# --- the cases of tests/test_io.py, through the port

def test_general(tmp_path, use_native):
    coo = tmm.read_matrix_market(_file(tmp_path, GENERAL), use_native=use_native)
    assert (coo.n_rows, coo.n_cols, coo.nnz) == (3, 4, 5)
    d = coo.to_dense()
    assert d[0, 0] == 1.0 and d[0, 3] == 2.0 and d[2, 2] == 5.0


def test_symmetric_expansion(tmp_path, use_native):
    coo = tmm.read_matrix_market(_file(tmp_path, SYMMETRIC), use_native=use_native)
    assert coo.nnz == 6  # 4 entries + 2 off-diagonal mirrors
    d = coo.to_dense()
    np.testing.assert_allclose(d, d.T)
    assert d[1, 0] == 2.0 and d[0, 1] == 2.0


def test_pattern_values_are_one(tmp_path, use_native):
    coo = tmm.read_matrix_market(_file(tmp_path, PATTERN), use_native=use_native)
    np.testing.assert_array_equal(np.asarray(coo.vals), [1.0, 1.0, 1.0])


def test_integer_field(tmp_path, use_native):
    coo = tmm.read_matrix_market(_file(tmp_path, INTEGER), value_dtype=np.int32,
                                 use_native=use_native)
    assert np.asarray(coo.vals).dtype == np.int32
    assert coo.to_dense()[1, 1] == -3


def test_skew_symmetric(tmp_path, use_native):
    coo = tmm.read_matrix_market(_file(tmp_path, SKEW), use_native=use_native)
    d = coo.to_dense()
    assert d[1, 0] == 5.0 and d[0, 1] == -5.0
    np.testing.assert_allclose(d, -d.T)


def test_as_csr(tmp_path, use_native):
    csr = tmm.read_matrix_market(_file(tmp_path, GENERAL), as_csr=True,
                                 use_native=use_native)
    assert np.asarray(csr.Ap).tolist() == [0, 2, 3, 5]


def test_banner_errors():
    with pytest.raises(tmm.MatrixMarketError):
        tmm.parse_banner("%%MatrixMarket matrix coordinate real bogus")
    with pytest.raises(tmm.MatrixMarketError):
        tmm.parse_banner("not a banner at all")
    assert tmm.parse_banner("%%MatrixMarket Matrix Coordinate Real General") == \
        jmm.parse_banner("%%MatrixMarket Matrix Coordinate Real General")


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n",  # 0-based
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",  # past dims
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n",  # short
], ids=["complex", "zero_based", "past_dims", "short"])
def test_malformed_files_raise(tmp_path, use_native, text):
    with pytest.raises(tmm.MatrixMarketError):
        tmm.read_matrix_market(_file(tmp_path, text), use_native=use_native)
    with pytest.raises(tmm.MatrixMarketError):
        tmm.read_matrix_market(io.StringIO(text))


# --- the same files give the reference's arrays, bit for bit

@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("as_csr", [False, True])
def test_cases_equal_the_reference(tmp_path, use_native, name, as_csr):
    p = _file(tmp_path, CASES[name])
    kw = dict(as_csr=as_csr, value_dtype=np.int32 if name == "integer" else np.float32)
    got = tmm.read_matrix_market(p, use_native=use_native, **kw)
    want = jmm.read_matrix_market(p, use_native=use_native, **kw)
    (_same_csr if as_csr else _same_coo)(got, want)


def test_gz_file_object_and_array_format_equal_the_reference(tmp_path):
    gz = tmp_path / "m.mtx.gz"
    with gzip.open(gz, "wt") as f:
        f.write(SYMMETRIC)
    _same_coo(tmm.read_matrix_market(gz), jmm.read_matrix_market(gz))
    _same_coo(tmm.read_matrix_market(io.StringIO(SKEW)),
              jmm.read_matrix_market(io.StringIO(SKEW)))
    _same_csr(tmm.read_matrix_market(io.StringIO(ARRAY), as_csr=True),
              jmm.read_matrix_market(io.StringIO(ARRAY), as_csr=True))


def test_written_matrix_reads_back_as_the_reference_reads_it(tmp_path, use_native):
    """A power-law matrix written by the port: read natively or not by
    either package, the same arrays; and the values round-trip exactly."""
    A = tgen.power_law_csr(3000, 2500, 24000, seed=1)
    p = tmp_path / "pl.mtx"
    tmm.write_matrix_market(p, A, comment="power law\nseed 1")
    got = tmm.read_matrix_market(p, as_csr=True, use_native=use_native)
    _same_csr(got, jmm.read_matrix_market(p, as_csr=True, use_native=use_native))
    _same_csr(got, A)
    assert p.read_text().splitlines()[1:3] == ["% power law", "% seed 1"]


def test_roundtrip(tmp_path):
    coo = tmm.read_matrix_market(io.StringIO(GENERAL))
    p = tmp_path / "m.mtx"
    tmm.write_matrix_market(p, coo, comment="roundtrip")
    np.testing.assert_allclose(coo.to_dense(), tmm.read_matrix_market(p).to_dense())
    buf = io.StringIO()
    tmm.write_matrix_market(buf, coo)
    jbuf = io.StringIO()
    jmm.write_matrix_market(jbuf, jmm.read_matrix_market(io.StringIO(GENERAL)))
    assert buf.getvalue() == jbuf.getvalue()


def test_package_exports():
    import spmv_tpu_torch
    import spmv_tpu_torch.io as tio

    assert spmv_tpu_torch.read_matrix_market is tmm.read_matrix_market
    assert spmv_tpu_torch.write_matrix_market is tmm.write_matrix_market
    import spmv_tpu.io as jio

    assert sorted(tio.__all__) == sorted(jio.__all__)


# --- the Kronecker generator

@pytest.mark.parametrize("scale,edge_factor,seed", [(8, 4, 0), (11, 16, 3)])
def test_kron_graph_csr_equals_the_reference(scale, edge_factor, seed):
    _same_csr(tgen.kron_graph_csr(scale, edge_factor=edge_factor, seed=seed),
              jgen.kron_graph_csr(scale, edge_factor=edge_factor, seed=seed))
