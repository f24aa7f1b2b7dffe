"""Build and bind the port's CUDA kernels (`spmv_tpu_torch/csrc/`).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc per
`.cu` file, all started together, and linked into one shared library
with a plain C interface, at first use, into `spmv_tpu_torch/_build/`
(git-ignored), under a name keyed by a hash of the sources, with nvcc's
output beside it; the library is loaded with ctypes. Every pointer and the
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc runs in this process, if any
build_log = ""        # nvcc's output (ptxas register / shared-memory report),
                      # read back from beside the library when it was built before

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
    "spmv_gather": [_P, _P, _P, _P, _P, _I32, _I32, _P],
    "spmv_gather_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _I32,
                          _I32, _I32, _I32, _I64, _I32, _P],
    "spmv_reduce_roll": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                         _P],
    "spmv_scan_roll": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _P],
    "spmv_pgather": [_P, _I64, _P, _P, _P, _P, _P, _P, _I32, _I32, _P],
    "spmv_group_reduce": [_P, _P, _I32, _I32, _I32, _I32, _P],
    "spmv_dia": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _P],
    "spmv_merge_group": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                         _I32, _I32, _P],
    "spmv_spmm_window": [_P, _I64, _I64, _P, _P, _P, _P, _I32, _I32, _P],
    "spmv_local_ell": [_P, _P, _P, _P, _I64, _P, _I32, _I32, _I32, _I32, _P],
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


def build() -> str:
    """Compile csrc/*.cu into the build dir (once per source hash), one
    nvcc per source in parallel, link them, and return the library
    path. nvcc's output is kept beside the library (`.log`) and read back
    into `build_log` when the library is found built. Raises RuntimeError
    when nvcc fails."""
    global build_seconds, build_log
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path) and os.path.exists(log_path):
        with open(log_path) as f:
            build_log = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    cus = [s for s in srcs if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [os.path.join(td, os.path.basename(s) + ".o") for s in cus]
        outs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s]
                         for s, o in zip(cus, objs)])
        build_log = "".join(f"== {os.path.basename(s)}\n{out}"
                            for s, (_, out) in zip(cus, outs))
        if any(rc != 0 for rc, _ in outs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        tmp = os.path.join(td, "kernels.so")
        (rc, out), = _run_all([[_nvcc(), "-shared", "-o", tmp, *objs]])
        build_log += f"== link\n{out}"
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{build_log}")
        with open(log_path, "w") as f:
            f.write(build_log)
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
