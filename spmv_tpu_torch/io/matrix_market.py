"""Matrix Market (.mtx) reader/writer.

Counterpart of `spmv_tpu/io/matrix_market.py`, with the same semantics
and names: for the same file it gives the same COO/CSR arrays, bit for
bit. Host code (NumPy and the port's native parser); the matrices it
returns are the host containers every kind takes. Its capabilities are
the reference loader's (ref: include/load.hpp:163-408):

- banner parse with typecode validation (ref: load.hpp:163-236)
- coordinate format, field ``real`` / ``integer`` / ``pattern``
  (pattern entries get value 1; ref: load.hpp:317-334)
- symmetry ``general`` / ``symmetric`` (off-diagonal entries
  duplicated transposed; ref: load.hpp:362-403), plus
  ``skew-symmetric`` (negated transpose)
- 1-based → 0-based index fixup (ref: load.hpp:344-347)
- index-overflow checks (ref: load.hpp:327-328, 350-351)

A fast native (C++) parsing path (`spmv_tpu_torch/native/host.cpp`,
`spmv_mm_read`, a copy of the reference's) is used for file paths when
the library builds; the pure-Python path is the fallback and the
semantics oracle the native path is tested against.
"""

from __future__ import annotations

import gzip
import io
from typing import Optional, TextIO

import numpy as np

from spmv_tpu_torch.formats import COO, CSR, coo_to_csr

_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


class MatrixMarketError(ValueError):
    pass


def _open(path_or_file) -> TextIO:
    if hasattr(path_or_file, "read"):
        return path_or_file
    if str(path_or_file).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path_or_file, "rb"))
    return open(path_or_file, "r")


def parse_banner(line: str):
    """Parse '%%MatrixMarket object format field symmetry'.

    ref: load.hpp:163-236 (mm_read_banner).
    """
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(f"bad MatrixMarket banner: {line!r}")
    _, obj, fmt, field, symmetry = (p.lower() for p in parts)
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r} (only 'matrix')")
    if fmt not in ("coordinate", "array"):
        raise MatrixMarketError(f"unsupported format {fmt!r}")
    if field not in _VALID_FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r}")
    if symmetry not in _VALID_SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {symmetry!r}")
    return fmt, field, symmetry


def read_matrix_market(
    path_or_file,
    value_dtype=np.float32,
    index_dtype=np.int32,
    as_csr: bool = False,
    offset_dtype=np.int32,
    use_native: bool = True,
):
    """Read a Matrix Market file into a COO (or CSR when as_csr=True).

    Mirrors LoadCoo (ref: load.hpp:268-408): pattern values become 1,
    symmetric off-diagonals are expanded, indices converted to 0-based.

    File paths go through the native C++ parser when the library is
    available (spmv_tpu_torch/native/host.cpp, the loader load.hpp's
    analog); file objects, .gz streams and array-format files use this
    pure-Python implementation, which is also the semantics oracle the
    native path is tested against.
    """
    if (
        use_native
        and not hasattr(path_or_file, "read")
        and not str(path_or_file).endswith(".gz")
    ):
        try:
            from spmv_tpu_torch import native

            n_rows, n_cols, rows, cols, vals = native.mm_read(str(path_or_file))
            info = np.iinfo(np.dtype(index_dtype))
            if max(n_rows, n_cols) - 1 > info.max:
                raise OverflowError(
                    f"matrix dimension overflows index dtype {np.dtype(index_dtype)}"
                )
            coo = COO(
                n_rows,
                n_cols,
                rows.astype(index_dtype, copy=False),
                cols.astype(index_dtype, copy=False),
                vals.astype(value_dtype),
            )
            if as_csr:
                return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype)
            return coo
        except NotImplementedError:
            pass  # unsupported feature or no toolchain: Python fallback
        except ValueError as e:
            raise MatrixMarketError(str(e)) from e
    f = _open(path_or_file)
    banner = f.readline()
    fmt, field, symmetry = parse_banner(banner)
    if field == "complex":
        raise MatrixMarketError("complex matrices are not supported")

    # Skip comments; read size line (ref: load.hpp:238-266).
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    if not line:
        raise MatrixMarketError("missing size line")

    if fmt == "array":
        dims = line.split()
        if len(dims) != 2:
            raise MatrixMarketError(f"bad array size line: {line!r}")
        n_rows, n_cols = int(dims[0]), int(dims[1])
        data = np.loadtxt(f, dtype=np.float64).reshape(n_cols, n_rows).T
        if symmetry in ("symmetric", "skew-symmetric"):
            # Array symmetric files store the lower triangle column-major.
            raise MatrixMarketError("symmetric array format is not supported")
        rows, cols = np.nonzero(data)
        coo = COO(
            n_rows,
            n_cols,
            rows.astype(index_dtype),
            cols.astype(index_dtype),
            data[rows, cols].astype(value_dtype),
        )
        return coo_to_csr(coo, offset_dtype=offset_dtype) if as_csr else coo

    dims = line.split()
    if len(dims) != 3:
        raise MatrixMarketError(f"bad coordinate size line: {line!r}")
    n_rows, n_cols, nnz = int(dims[0]), int(dims[1]), int(dims[2])

    # Bulk-parse the entry lines.
    if field == "pattern":
        raw = np.loadtxt(f, dtype=np.int64, ndmin=2, usecols=(0, 1), max_rows=nnz)
        if raw.size == 0:
            raw = raw.reshape(0, 2)
        if raw.shape[0] != nnz:
            raise MatrixMarketError(f"expected {nnz} entries, got {raw.shape[0]}")
        rows_1b = raw[:, 0]
        cols_1b = raw[:, 1]
        vals = np.ones(nnz, dtype=value_dtype)  # ref: load.hpp:317-334
    else:
        raw = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
        if raw.size == 0:
            raw = raw.reshape(0, 3)
        if raw.shape[1] < 3:
            raise MatrixMarketError("entry lines must be 'row col value'")
        if raw.shape[0] != nnz:
            raise MatrixMarketError(f"expected {nnz} entries, got {raw.shape[0]}")
        rows_1b = raw[:, 0].astype(np.int64)
        cols_1b = raw[:, 1].astype(np.int64)
        vals = raw[:, 2].astype(value_dtype)

    if nnz and (rows_1b.min() < 1 or cols_1b.min() < 1):
        raise MatrixMarketError(
            "indices must be 1-based (found 0 or negative index)"
        )  # ref: load.hpp:283-306 zero-based rejection
    if nnz and (rows_1b.max() > n_rows or cols_1b.max() > n_cols):
        raise MatrixMarketError("entry index exceeds declared dimensions")

    rows = (rows_1b - 1).astype(np.int64)
    cols = (cols_1b - 1).astype(np.int64)

    if symmetry in ("symmetric", "skew-symmetric"):
        # Duplicate off-diagonal entries transposed (ref: load.hpp:362-403).
        off = rows != cols
        extra_r = cols[off]
        extra_c = rows[off]
        extra_v = -vals[off] if symmetry == "skew-symmetric" else vals[off]
        rows = np.concatenate([rows, extra_r])
        cols = np.concatenate([cols, extra_c])
        vals = np.concatenate([vals, extra_v])

    info = np.iinfo(np.dtype(index_dtype))
    if max(n_rows, n_cols) - 1 > info.max:
        raise OverflowError(
            f"matrix dimension overflows index dtype {np.dtype(index_dtype)}"
        )  # ref: load.hpp:327-328 overflow guard

    coo = COO(
        n_rows,
        n_cols,
        rows.astype(index_dtype),
        cols.astype(index_dtype),
        vals.astype(value_dtype),
    )
    if as_csr:
        return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype)
    return coo


def write_matrix_market(path_or_file, mat, comment: Optional[str] = None):
    """Write a COO/CSR as a general real coordinate Matrix Market file."""
    if isinstance(mat, CSR):
        mat = mat.to_coo()
    own = not hasattr(path_or_file, "write")
    f = open(path_or_file, "w") if own else path_or_file
    try:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{mat.n_rows} {mat.n_cols} {mat.nnz}\n")
        rows = np.asarray(mat.rows, dtype=np.int64) + 1
        cols = np.asarray(mat.cols, dtype=np.int64) + 1
        vals = np.asarray(mat.vals, dtype=np.float64)
        np.savetxt(f, np.column_stack([rows, cols, vals]), fmt="%d %d %.17g")
    finally:
        if own:
            f.close()
