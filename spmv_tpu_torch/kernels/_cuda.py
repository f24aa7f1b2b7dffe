"""Build and bind the port's CUDA kernels (`spmv_tpu_torch/csrc/`).

The sources are compiled with nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, at first use, into
`spmv_tpu_torch/_build/` (git-ignored), under a name keyed by a hash of
the sources; the library is loaded with ctypes. Every pointer and the
stream go through as `c_void_p`. Kernels launch on PyTorch's current
stream; each C launcher returns `cudaGetLastError()`, and `check`
raises when that is not 0.

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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run in this process, if any
build_log = ""        # nvcc's output (ptxas register / shared-memory report)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
# C launchers: name -> argument types (every one returns an int error code)
_SIGNATURES = {
    "spmv_xprep": [_P, _P, _P, _P, _P, _P, _I32, _P],
    "spmv_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _P],
    "spmv_split": [_P, _P, _P, _P, _P, _I32, _P, _P, _I32, _I32, _I32, _I32,
                   _I64, _P],
    "spmv_scan_diff": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I32, _P],
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


def build() -> str:
    """Compile csrc/*.cu into the build dir (once per source hash) and
    return the library path. Raises RuntimeError when nvcc fails."""
    global build_seconds, build_log
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = os.path.join(td, "kernels.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.spmv_cuda_error_string.argtypes = [ctypes.c_int]
            so.spmv_cuda_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


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
