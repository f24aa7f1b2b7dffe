"""Native (C++) host planner bindings.

The port's own copy of `spmv_tpu/native/host.cpp`, compiled with g++
at first use into `spmv_tpu_torch/_build/` (git-ignored), keyed by a
hash of the source, and bound with ctypes. Only the entry points the
stream, merge and ELL planners, the Matrix Market reader and SpGEMM's
symbolic phase use are bound. Every caller has a pure-Python fallback
that gives the same arrays, so a missing toolchain (or
SPMV_TPU_NO_NATIVE=1) costs planning time, not capability.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib = None
_tried = False


class _MMResult(ctypes.Structure):
    """host.cpp's MMResult: the parse, allocated by the library."""
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("field", ctypes.c_int32),
        ("symmetry", ctypes.c_int32),
    ]


def _build() -> str | None:
    """Compile host.cpp into the build dir; return the library path or
    None when the toolchain is missing or the build fails."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"host-{tag}.so")
    if os.path.exists(path):
        return path
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
            tmp = os.path.join(td, "host.so")
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=240)
            os.replace(tmp, path)
        return path
    except (OSError, subprocess.SubprocessError) as e:
        sys.stderr.write(f"spmv_tpu_torch.native: build failed ({e}); "
                         f"using the NumPy planner\n")
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SPMV_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            sys.stderr.write(f"spmv_tpu_torch.native: load failed ({e})\n")
            return None
        I32, I64 = ctypes.c_int32, ctypes.c_int64
        P64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        P32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        P16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        PI8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.spmv_last_error.restype = ctypes.c_char_p
        lib.spmv_free.argtypes = [ctypes.c_void_p]
        lib.spmv_free.restype = None
        lib.spmv_mm_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MMResult)]
        lib.spmv_mm_read.restype = ctypes.c_int
        lib.spmv_coo_to_csr.argtypes = [I64, I64, P32, P32, P64, P32, P64]
        lib.spmv_coo_to_csr.restype = ctypes.c_int
        lib.spmv_route_tiles.argtypes = [I64, P32, PU8, PU8, PU8, I32]
        lib.spmv_route_tiles.restype = ctypes.c_int
        lib.spmv_plan_split.argtypes = [
            I64, I32, I32, I32, I32, P64, P32, P64, I64, P32, P32, P64,
            I32, I64]
        lib.spmv_plan_split.restype = ctypes.c_int
        lib.spmv_scatter_slots.argtypes = [I64, P64, I64, P64]
        lib.spmv_scatter_slots.restype = ctypes.c_int
        lib.spmv_geom_mid1.argtypes = [I64, P32, P32, I32, I32, I32, I32, P32]
        lib.spmv_geom_mid1.restype = ctypes.c_int
        lib.spmv_geom_sub_next.argtypes = [I64, P32, P32, I64, I32, I64, I32,
                                           I32, I32, I32, P32]
        lib.spmv_geom_sub_next.restype = ctypes.c_int
        lib.spmv_geom_key_max.argtypes = [I64, P32, P32, I64, I64, I32, I32, I64]
        lib.spmv_geom_key_max.restype = I64
        lib.spmv_plan_scan3.argtypes = [
            I64, P64, P64, P64, P64, I32, P32, P16, P32, P32, PI8, P32]
        lib.spmv_plan_scan3.restype = ctypes.c_int
        lib.spmv_merge_count_tiles.argtypes = [I64, I64, P64, P64, I64, I64]
        lib.spmv_merge_count_tiles.restype = I64
        lib.spmv_merge_fill.argtypes = [I64, I64, P64, P64, I64, I64, I64,
                                        P64, P32, P32, P32, P64, P32, P32, P32]
        lib.spmv_merge_fill.restype = ctypes.c_int
        lib.spmv_ell_count_chunks.argtypes = [I64, P64, P64, I64]
        lib.spmv_ell_count_chunks.restype = I64
        lib.spmv_ell_fill.argtypes = [I64, P64, P64, I64, I64, I64, P64, PU8, P32]
        lib.spmv_ell_fill.restype = ctypes.c_int
        PPI32 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
        PPI64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
        PI64 = ctypes.POINTER(ctypes.c_int64)
        lib.spmv_spgemm_symbolic.argtypes = [
            I64, I64, P64, P64, P64, P64, P64,
            PPI32, PI64, PPI64, PPI64, PPI64, PI64]
        lib.spmv_spgemm_symbolic.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    return lib


def _err(lib) -> str:
    return lib.spmv_last_error().decode(errors="replace")


def mm_read(path: str):
    """Native .mtx parse. Returns (n_rows, n_cols, rows, cols, vals) with
    0-based int32 indices, float64 values, symmetric entries expanded.
    Raises ValueError on malformed files, NotImplementedError when the
    native path can't handle the file (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    res = _MMResult()
    rc = lib.spmv_mm_read(os.fsencode(path), ctypes.byref(res))
    if rc != 0:
        msg = _err(lib)
        if "supported" in msg:
            raise NotImplementedError(msg)
        raise ValueError(f"{path}: {msg}")
    try:
        n = res.nnz
        rows = np.ctypeslib.as_array(res.rows, shape=(n,)).copy() if n else np.empty(0, np.int32)
        cols = np.ctypeslib.as_array(res.cols, shape=(n,)).copy() if n else np.empty(0, np.int32)
        vals = np.ctypeslib.as_array(res.vals, shape=(n,)).copy() if n else np.empty(0, np.float64)
    finally:
        lib.spmv_free(res.rows)
        lib.spmv_free(res.cols)
        lib.spmv_free(res.vals)
    return int(res.n_rows), int(res.n_cols), rows, cols, vals


def coo_to_csr_perm(n_rows: int, rows: np.ndarray, cols: np.ndarray):
    """Native stable counting sort. Returns (Ap int64, Aj int32, perm int64)
    where perm maps CSR position -> original COO position."""
    lib = _need()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nnz = rows.shape[0]
    Ap = np.zeros(n_rows + 1, dtype=np.int64)
    Aj = np.empty(nnz, dtype=np.int32)
    perm = np.empty(nnz, dtype=np.int64)
    if lib.spmv_coo_to_csr(n_rows, nnz, rows, cols, Ap, Aj, perm) != 0:
        raise ValueError(_err(lib))
    return Ap, Aj, perm


def route_tiles(src: np.ndarray, dedupe: bool = True):
    """Native 3-stage tile routing (see ops/routing.py for semantics).
    src: (T,128,128) int32. Returns (s1, s2, s3) uint8 arrays."""
    lib = _need()
    src = np.ascontiguousarray(src, dtype=np.int32)
    T = src.shape[0]
    s1 = np.empty((T, 128, 128), dtype=np.uint8)
    s2 = np.empty((T, 128, 128), dtype=np.uint8)
    s3 = np.empty((T, 128, 128), dtype=np.uint8)
    rc = lib.spmv_route_tiles(T, src.reshape(-1), s1.reshape(-1),
                              s2.reshape(-1), s3.reshape(-1),
                              1 if dedupe else 0)
    if rc != 0:
        raise ValueError(_err(lib))
    return s1, s2, s3


# Grow-only scratch buffers for the planner's large transient arrays:
# reusing warm pages across passes, retries and plans avoids the page
# faults of fresh multi-hundred-MB allocations. Keys are (name, level)
# so arrays alive at the same time within one plan build never share a
# buffer; the planner is single-threaded.
_arena: dict = {}


def _scratch(key, n, dtype):
    buf = _arena.get(key)
    if buf is None or buf.dtype != np.dtype(dtype) or buf.size < n:
        buf = np.empty(n, dtype)
        _arena[key] = buf
    return buf[:n]


def plan_split(cur, grp, n_groups: int, sbt: int, Q: int,
               B0, out_rows: int, sort_payload: bool,
               level: int = 0, gmode: int = 0, radix: int = 1):
    """Native one-pass shuffle split simulation (see kernels/shuffle.py
    _plan_split). Returns (src, starts, new_cur).

    src and new_cur are arena scratch: src is the caller's only until
    it plans the pass's routes (same plan build); new_cur only until
    the NEXT pass's plan_split(level+1) returns (ping-pong by level
    parity). Callers that keep them longer must copy.
    """
    lib = _need()
    TILE = 128 * 128
    cur = np.ascontiguousarray(cur, dtype=np.int64)
    if gmode == 0:
        grp = np.ascontiguousarray(grp, dtype=np.int32)
    else:  # groups derived from cur in C; pass a dummy pointer
        grp = np.zeros(1, dtype=np.int32)
    B0 = np.ascontiguousarray(B0, dtype=np.int64)
    n_tiles = cur.shape[0] // TILE
    n_steps = n_tiles // sbt
    src = _scratch(("split_src", level), n_tiles * TILE, np.int32)
    starts = np.zeros(n_steps * sbt * n_groups, dtype=np.int32)
    new_cur = _scratch(("split_cur", level & 1), out_rows * 128, np.int64)
    if np.shares_memory(cur, new_cur):  # same-parity misuse guard
        new_cur = np.empty(out_rows * 128, np.int64)
    rc = lib.spmv_plan_split(
        n_tiles, sbt, n_groups, Q, 1 if sort_payload else 0,
        cur, grp, B0.reshape(-1), out_rows, src, starts, new_cur,
        gmode, radix)
    if rc != 0:
        raise ValueError(_err(lib))
    return (src.reshape(n_tiles, 128, 128),
            starts.reshape(n_steps, sbt, n_groups), new_cur)


def geom_mid1(dt, st, G1: int, r1: int, q1: int, sbt: int):
    """mid = (dt%G1)*r1 + ((st//sbt)*sbt*q1)//128, into arena scratch."""
    lib = _need()
    n = dt.shape[0]
    mid = _scratch(("geom_mid",), n, np.int32)
    lib.spmv_geom_mid1(n, dt, st, G1, r1, q1, sbt, mid)
    return mid


def geom_sub_next(dt, mid, divg: int, G: int, radix: int, spp: int,
                  r: int, q: int, sbt: int, key: str):
    """sub = ((dt//divg)%G * radix + (mid//sbt)//spp)*r
    + (((mid//sbt)%spp)*sbt*q)//128, into arena scratch `key`."""
    lib = _need()
    n = dt.shape[0]
    sub = _scratch(("geom_sub", key), n, np.int32)
    lib.spmv_geom_sub_next(n, dt, mid, divg, G, radix, spp, r, q, sbt, sub)
    return sub


def geom_key_max(base, dt, mul: int, divd: int, G: int, use_mod: bool,
                 n_keys: int) -> int:
    """max bincount of base*mul + ((dt//divd)%G if use_mod else dt//divd)."""
    lib = _need()
    mx = lib.spmv_geom_key_max(base.shape[0], base, dt, mul, divd, G,
                               1 if use_mod else 0, n_keys)
    if mx < 0:
        raise ValueError(_err(lib))
    return int(mx)


def scatter_slots(fin, n_out: int):
    """slot_of_dst assembly: out[fin[s]] = s for live in-range fin."""
    lib = _need()
    fin = np.ascontiguousarray(fin, np.int64)
    out = np.empty(n_out, np.int64)
    lib.spmv_scatter_slots(fin.shape[0], fin, n_out, out)
    return out


def merge_tiles(n_rows: int, Ap: np.ndarray, row_of_nnz: np.ndarray,
                EN: int, RW: int) -> dict:
    """Native merge-plan tile walk and fill. Returns the plan arrays
    (n_tiles, k_starts, r_start, lrow, cnt, flat_k, rel, pend,
    owner_idx) before padding."""
    lib = _need()
    Ap = np.ascontiguousarray(Ap, dtype=np.int64)
    row_of_nnz = np.ascontiguousarray(row_of_nnz, dtype=np.int64)
    nnz = row_of_nnz.shape[0]
    T = lib.spmv_merge_count_tiles(n_rows, nnz, Ap, row_of_nnz, EN, RW)
    if T < 0:
        raise ValueError("merge tile walk failed to advance")
    k_starts = np.empty(T + 1, dtype=np.int64)
    r_start = np.empty(T, dtype=np.int32)
    lrow = np.empty(T, dtype=np.int32)
    cnt = np.empty(T, dtype=np.int32)
    flat_k = np.empty(T * EN, dtype=np.int64)
    rel = np.empty(T * EN, dtype=np.int32)
    pend = np.empty(T * RW, dtype=np.int32)
    owner_idx = np.empty(n_rows, dtype=np.int32)
    rc = lib.spmv_merge_fill(n_rows, nnz, Ap, row_of_nnz, EN, RW, T,
                             k_starts, r_start, lrow, cnt, flat_k, rel,
                             pend, owner_idx)
    if rc != 0:
        raise ValueError(_err(lib))
    return {
        "n_tiles": int(T), "k_starts": k_starts, "r_start": r_start,
        "lrow": lrow, "cnt": cnt,
        "flat_k": flat_k.reshape(T, EN), "rel": rel.reshape(T, EN),
        "pend": pend.reshape(T, RW), "owner_idx": owner_idx,
    }


def ell_chunks(sel_rows: np.ndarray, Ap: np.ndarray, W: int, nnz: int):
    """Native ELL chunk plan. Returns (flat_k (V,W) int64, valid (V,W) bool,
    vrow_row (V,) int32)."""
    lib = _need()
    sel_rows = np.ascontiguousarray(sel_rows, dtype=np.int64)
    Ap = np.ascontiguousarray(Ap, dtype=np.int64)
    V = lib.spmv_ell_count_chunks(sel_rows.shape[0], sel_rows, Ap, W)
    flat_k = np.empty(V * W, dtype=np.int64)
    valid = np.empty(V * W, dtype=np.uint8)
    vrow_row = np.empty(V, dtype=np.int32)
    rc = lib.spmv_ell_fill(sel_rows.shape[0], sel_rows, Ap, W, V, nnz,
                           flat_k, valid, vrow_row)
    if rc != 0:
        raise ValueError(_err(lib))
    return (flat_k.reshape(V, W), valid.reshape(V, W).astype(bool), vrow_row)


def plan_scan(k_starts, bases, slot_of_dst, row_ids, bin_rows: int):
    """Native per-final-tile scan stream construction, exact-rank
    layout (see kernels/stream.py _plan_scan). Returns the streams
    before routing: (perm_src, relid, src2e, src2p, valid2, counts)."""
    lib = _need()
    TILE = 128 * 128
    F = k_starts.shape[0] - 1
    P = bin_rows // 128
    k_starts = np.ascontiguousarray(k_starts, np.int64)
    bases = np.ascontiguousarray(bases, np.int64)
    slot_of_dst = np.ascontiguousarray(slot_of_dst, np.int64)
    row_ids = np.ascontiguousarray(row_ids, np.int64)
    perm_src = np.empty((F, 128, 128), np.int32)
    relid = np.empty((F, TILE), np.int16)
    src2e = np.empty((F, 128, 128), np.int32)
    src2p = np.empty((F, 128, 128), np.int32)
    valid2 = np.empty((F, P, 128), np.int8)
    counts = np.zeros(F, np.int32)
    rc = lib.spmv_plan_scan3(
        F, k_starts, bases, slot_of_dst.reshape(-1), row_ids, bin_rows,
        perm_src.reshape(-1), relid.reshape(-1), src2e.reshape(-1),
        src2p.reshape(-1), valid2.reshape(-1), counts)
    if rc != 0:
        raise ValueError(_err(lib))
    return (perm_src, relid, src2e, src2p, valid2, counts)


def spgemm_symbolic(n_rows: int, n_cols_b: int, Ap, Aj, Bp, Bj):
    """Native Gustavson symbolic phase (see kernels/spgemm.py).

    Returns (Cp int64, Cj int32, v_ap int64, srcA int64, srcB int64,
    total). Raises NotImplementedError when the native lib is absent.
    """
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    Ap = np.ascontiguousarray(Ap, np.int64)
    Aj = np.ascontiguousarray(Aj, np.int64)
    Bp = np.ascontiguousarray(Bp, np.int64)
    Bj = np.ascontiguousarray(Bj, np.int64)
    Cp = np.zeros(n_rows + 1, np.int64)
    Cj_p = ctypes.POINTER(ctypes.c_int32)()
    vap_p = ctypes.POINTER(ctypes.c_int64)()
    sA_p = ctypes.POINTER(ctypes.c_int64)()
    sB_p = ctypes.POINTER(ctypes.c_int64)()
    nnzC = ctypes.c_int64(0)
    total = ctypes.c_int64(0)
    rc = lib.spmv_spgemm_symbolic(
        n_rows, n_cols_b, Ap, Aj, Bp, Bj, Cp,
        ctypes.byref(Cj_p), ctypes.byref(nnzC), ctypes.byref(vap_p),
        ctypes.byref(sA_p), ctypes.byref(sB_p), ctypes.byref(total))
    if rc != 0:
        raise ValueError(_err(lib))
    try:
        nc, t = int(nnzC.value), int(total.value)
        Cj = (np.ctypeslib.as_array(Cj_p, shape=(nc,)).copy()
              if nc else np.empty(0, np.int32))
        v_ap = np.ctypeslib.as_array(vap_p, shape=(nc + 1,)).copy()
        srcA = (np.ctypeslib.as_array(sA_p, shape=(t,)).copy()
                if t else np.empty(0, np.int64))
        srcB = (np.ctypeslib.as_array(sB_p, shape=(t,)).copy()
                if t else np.empty(0, np.int64))
    finally:
        for p in (Cj_p, vap_p, sA_p, sB_p):
            lib.spmv_free(p)
    return Cp, Cj, v_ap, srcA, srcB, t
