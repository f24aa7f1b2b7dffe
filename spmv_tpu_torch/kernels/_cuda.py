"""Build and bind the port's CUDA kernels (`spmv_tpu_torch/csrc/`).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc per
`.cu` file, all started together, and linked into one shared library
with a plain C interface, at first use, into `spmv_tpu_torch/_build/`
(git-ignored), under a name keyed by a hash of the sources, with nvcc's
output beside it; the library is loaded with ctypes. Every pointer and the
stream go through as `c_void_p`. Kernels launch on PyTorch's current
stream; each C launcher returns `cudaGetLastError()`, and `check`
raises when that is not 0.

A user-defined semiring gets a library of its own (`ring_lib`): the
ring-templated sources (`RING_SOURCES`) compiled with the ring's
generated header (ops/ring_codegen.py) included first, which makes it
`Ring<SPMV_RING_USER>` and the only ring the launchers know. It is built
at the ring's first CUDA call into `_build/ring-<hash>.so`, keyed by the
sources, the flags and the header, has the same C signatures, and is
cached per Semiring object.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The sources instantiated per ring, which a user ring's library holds
RING_SOURCES = ("gather_kernels.cu", "roll_kernels.cu", "merge_kernels.cu",
                "direct_kernels.cu", "dia_kernels.cu", "spmm_kernels.cu",
                "dist_kernels.cu")

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc runs in this process, if any
build_log = ""        # nvcc's output (ptxas register / shared-memory report),
                      # read back from beside the library when it was built before
_ring_libs: dict = {}         # Semiring -> its loaded library
ring_build_seconds: dict = {}  # ring name -> wall time of its nvcc runs here
ring_build_logs: dict = {}     # ring name -> nvcc's output for its library

# Value dtypes every kernel but K2 and K6 is instantiated for, by the codes
# of csrc/values.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Integer values, which K13 and K16 alone take; the narrower integers go
# through their int32 bodies and are narrowed back
INT_CODES = {torch.int32: 3, torch.int64: 4}
NARROW_INTS = (torch.int8, torch.uint8, torch.int16, torch.bool)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F64 = ctypes.c_double
# C launchers: name -> argument types (every one returns an int error code)
# (the value-typed launchers take the dtype code before the ring code)
_SIGNATURES = {
    "spmv_xprep": [_P, _P, _P, _P, _P, _P, _I32, _I32, _P],
    "spmv_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _P],
    "spmv_split": [_P, _P, _P, _P, _P, _I32, _P, _P, _I32, _I32, _I32, _I32,
                   _I64, _I32, _P],
    "spmv_scan_diff": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I32, _P],
    "spmv_gather": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _P],
    "spmv_gather_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _I32,
                          _I32, _I32, _I32, _I64, _I32, _I32, _P],
    "spmv_reduce_roll": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                         _I32, _P],
    "spmv_scan_roll": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                       _I32, _P],
    "spmv_pgather": [_P, _I64, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _P],
    "spmv_group_reduce": [_P, _P, _I32, _I32, _I32, _I32, _I32, _P],
    "spmv_dia": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _P],
    "spmv_merge_group": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                         _I32, _I32, _I32, _P],
    "spmv_spmm_window": [_P, _I64, _I64, _P, _P, _P, _P, _I32, _I32, _I32, _P],
    "spmv_local_ell": [_P, _P, _P, _P, _I64, _P, _I32, _I32, _I32, _I32, _I32,
                       _P],
    "spmv_sptrsv": [_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I64, _I32,
                    _I32, _I32, _I32, _I32, _I32, _P],
    "spmv_k14_chain_probe": [_P, _I32, _I32, _I32, _P],
    "spmv_hessenberg_lstsq": [_P, _P, _P, _P, _I64, _I32, _P],
    "spmv_k15_chain_probe": [_P, _I32] + [_F64] * 7 + [_P],
    "spmv_segment_fold": [_P, _I64, _P, _I32, _P, _I32, _I64, _I64, _I64, _F64, _I64, _P,
                          _P, _I64, _I32, _I32, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all. Returns (returncode,
    output) per command."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs


def _build_lib(srcs: list, stem: str, flags: list,
               extra: bytes = b"") -> tuple:
    """Compile the `.cu` files of `srcs` with `flags`, one nvcc per source
    in parallel, and link them into `_build/<stem>-<hash>.so`, the hash
    taken over the flags, every source and `extra`; nothing is built when
    that library and its log exist. Returns (library path, nvcc's output,
    seconds spent or None). Raises RuntimeError with nvcc's output when
    nvcc fails."""
    h = hashlib.sha256(" ".join(flags).encode() + extra)
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path) and os.path.exists(log_path):
        with open(log_path) as f:
            return path, f.read(), None
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    cus = [s for s in srcs if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [os.path.join(td, os.path.basename(s) + ".o") for s in cus]
        outs = _run_all([[_nvcc(), *flags, "-c", "-o", o, s]
                         for s, o in zip(cus, objs)])
        log = "".join(f"== {os.path.basename(s)}\n{out}"
                      for s, (_, out) in zip(cus, outs))
        if any(rc != 0 for rc, _ in outs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = os.path.join(td, "kernels.so")
        (rc, out), = _run_all([[_nvcc(), "-shared", "-o", tmp, *objs]])
        log += f"== link\n{out}"
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, path)
    return path, log, time.perf_counter() - t0


def build() -> str:
    """Compile csrc/*.cu into the build dir (once per source hash), one
    nvcc per source in parallel, link them, and return the library
    path. nvcc's output is kept beside the library (`.log`) and read back
    into `build_log` when the library is found built. Raises RuntimeError
    when nvcc fails."""
    global build_seconds, build_log
    path, build_log, secs = _build_lib(_sources(), "kernels", NVCC_FLAGS)
    if secs is not None:
        build_seconds = secs
    return path


def _bind(so, names) -> None:
    for name in names:
        fn = getattr(so, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            _bind(so, _SIGNATURES)
            so.spmv_cuda_error_string.argtypes = [ctypes.c_int]
            so.spmv_cuda_error_string.restype = ctypes.c_char_p
            so.spmv_k15_scratch_doubles.argtypes = [_I32]
            so.spmv_k15_scratch_doubles.restype = _I64
            so.spmv_fold_scratch_bytes.argtypes = [_I64, _I64, _I32, _I32]
            so.spmv_fold_scratch_bytes.restype = _I64
            _lib = so
        return _lib


def ring_lib(sr):
    """The library of the ring-templated kernels for the user-defined ring
    `sr` (built at its first call, then cached per Semiring object and on
    disk by hash). Its launchers take SPMV_RING_USER as the ring code.
    Raises NotImplementedError where `sr` leaves the traced menu
    (ops/ring_codegen.py), RuntimeError with nvcc's output where the
    build fails."""
    from spmv_tpu_torch.ops.ring_codegen import ring_header

    with _lock:
        so = _ring_libs.get(sr)
        if so is not None:
            return so
        header = ring_header(sr)  # raises off the menu, before any build
        hh = hashlib.sha256(header.encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        hpath = os.path.join(BUILD_DIR, f"ring-{hh}.cuh")
        if not os.path.exists(hpath):
            tmp = f"{hpath}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(header)
            os.replace(tmp, hpath)
        srcs = [os.path.join(CSRC, f) for f in RING_SOURCES] + [
            s for s in _sources() if s.endswith(".cuh")]
        path, log, secs = _build_lib(
            srcs, "ring", NVCC_FLAGS + ["-I", CSRC, "-include", hpath],
            extra=header.encode())
        ring_build_logs[sr.name] = log
        if secs is not None:
            ring_build_seconds[sr.name] = secs
        so = ctypes.CDLL(path)
        _bind(so, [n for n in _SIGNATURES if hasattr(so, n)])
        _ring_libs[sr] = so
        return so


def value_code(t: torch.Tensor, kernel: str, dtypes=tuple(DTYPE_CODES)) -> int:
    """The dtype code of `t`'s values for `kernel`, which is instantiated
    for `dtypes`; another floating dtype raises NotImplementedError naming
    the kernel (not ported yet), any other dtype ValueError."""
    if t.dtype in dtypes:
        return {**DTYPE_CODES, **INT_CODES}[t.dtype]
    if t.dtype.is_floating_point:
        raise NotImplementedError(
            f"{kernel}: {t.dtype} values are not ported yet: its CUDA kernel is "
            f"instantiated for {', '.join(str(d) for d in dtypes)} only")
    raise ValueError(f"{kernel}: dtype {t.dtype}, expected "
                     f"{', '.join(str(d) for d in dtypes)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().spmv_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` has the dtype, shape and device the kernel
    takes and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
