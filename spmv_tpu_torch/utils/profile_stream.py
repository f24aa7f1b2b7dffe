"""Where the time of one `spmv("stream", A, x)` call goes on the card.

Run on a machine with an NVIDIA GPU, from the root of the repository:

    python -m spmv_tpu_torch.utils.profile_stream

For the bench matrix (power_law_csr(1<<20, 1<<20, 3.3M, seed 42)) and
the wide-row matrix (16.8M nnz), it prints the call's time between CUDA
events, the host's time to enqueue one call, and a torch.profiler
table of device time per call by kernel, whose sum is the device's busy
time (its idle share is 1 - busy / call time).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import spmv_tpu_torch as st
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.utils.timing import cuda_time_ms

MATRICES = (("bench", 3_300_000), ("wide_row", 16_777_216))
CALLS = 20


def profile_matrix(label: str, nnz: int, card: str) -> None:
    A = power_law_csr(1 << 20, 1 << 20, nnz, alpha=1.5, seed=42)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.n_cols).astype(np.float32)).cuda()
    st.spmv("stream", A, x)  # plan build + upload
    call_ms = cuda_time_ms(lambda: st.spmv("stream", A, x), iters=30)["median_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        st.spmv("stream", A, x)
    enqueue_ms = (time.perf_counter() - t0) / CALLS * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            st.spmv("stream", A, x)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0) / CALLS
        # device kernels and copies only (their aten:: callers repeat them)
        if us > 0 and not e.key.startswith(("aten::", "cuda")):
            rows.append((us, e.key, e.count // CALLS))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"== {label}: nnz {A.nnz}; call {call_ms:.4f} ms (CUDA events, median "
          f"of 30); host enqueue {enqueue_ms:.4f} ms/call; device busy "
          f"{busy_ms:.4f} ms/call (profiler), idle share "
          f"{1 - busy_ms / call_ms:.4f}; {card}")
    for us, key, count in rows:
        print(f"   {us:10.2f} us/call  x{count:<3d} {key[:100]}")
    if busy_ms > call_ms:
        raise SystemExit(f"profile_stream: device busy {busy_ms:.4f} ms exceeds "
                         f"the call's {call_ms:.4f} ms; one of the two is wrong")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for label, nnz in MATRICES:
        profile_matrix(label, nnz, card)


if __name__ == "__main__":
    main()
