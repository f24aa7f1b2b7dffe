#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (spmv_tpu_torch) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It drives the port's main path, `spmv_tpu_torch.spmv("stream", A, x)`
with x on the card, at the bench matrix's size (power_law_csr(1<<20,
1<<20, 3.3M, alpha 1.5, seed 42), the size class of SuiteSparse's
webbase-1M) and on the 16.8M-nnz wide-row matrix, and checks it:

1. the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
2. builds the four CUDA kernels from csrc/ (nvcc, into the git-ignored
   spmv_tpu_torch/_build/) and prints the build seconds;
3. on the bench plan's own arrays, each kernel against its plain
   PyTorch version on the card: K1 and K5 bit for bit, K2 and K6 bit for
   bit on integer-valued data and within rtol 2e-4 / atol 1e-5 on
   normal data;
4. each kernel's median time over 30 runs after warm-up, beside its
   plain version's;
5. end to end on both matrices: y against the float64 oracle (rtol 2e-4,
   atol 1e-5), finite, the launch counts of one call (K1 1, K2 1, K5 one
   per shuffle pass, K6 1), plan-build seconds, ms per call, Gnnz/s, and
   cuSPARSE's `torch.sparse_csr_tensor @ x` on the same matrix for
   comparison;
6. or-and on the bench matrix against the semiring oracle (exact);
7. a plan that needs an unported TPU kernel (K3) raises.

Every failure exits non-zero. The line before the last is the JSON list
of kernels; the last is {"ok": true, "device": {...}}. Timings stand
beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

RTOL, ATOL = 2e-4, 1e-5
ITERS = 30
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr, random_csr
    from spmv_tpu_torch.kernels import _cuda
    from spmv_tpu_torch.kernels import shuffle as tsh
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.ops.tuning import detect_chip, policy_for
    from spmv_tpu_torch.utils.timing import cuda_time_ms

    # 2. build
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'} s)")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
        f.write(_cuda.build_log)

    def build_plan(A):
        pol = policy_for(4, detect_chip(dev))
        t = time.perf_counter()
        plan = ts.build_stream_plan(A, pol)
        secs = time.perf_counter() - t
        plan_cache(A, ts.plan_cache_key(pol), lambda: plan)
        return plan, secs

    # 3 + 4. kernels vs plain versions on the bench plan's arrays
    A = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x_np = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    plan, plan_s = build_plan(A)
    print(f"bench plan: {plan.n_gather_tiles} gather tiles, {plan.n_final_tiles} "
          f"final tiles, Qp {plan.reduce['Qp'] if plan.reduce else None}, passes "
          f"{[(p.sbt, p.n_steps, p.K, p.Q) for p in plan.shuffle.passes]}, "
          f"built in {plan_s:.3f} s on the host")
    check(plan.reduce is not None and "xr1" in plan.gather,
          "bench plan is not on the ported branch (reduce + remap)")
    dplan = plan.to(dev)
    g, rd, sc = dplan.gather, dplan.reduce, dplan.scan
    n_w = plan.x_rows_pad // 128
    F_pad = int(sc["counts"].shape[0])
    gen = torch.Generator(device=dev).manual_seed(1)
    ints = {
        "Ax": torch.randint(-4, 5, tuple(g["Ax"].shape), generator=gen,
                            device=dev).float(),
        "x": torch.randint(-4, 5, (A.n_cols,), generator=gen, device=dev).float(),
    }
    x = torch.from_numpy(x_np).to(dev)
    scan_keys = ("pm1", "pm2", "pm3", "r2s1", "r2s2", "r2s3", "q2s1", "q2s2",
                 "q2s3", "valid2", "counts")
    audit = ts.audit_plan(plan, A.nnz)["per_pass_bytes"]
    print(f"audit_plan bytes per call: {audit}")

    def stages(Ax, xv):
        """(name, kernel call, plain call, exact) for each kernel, fed
        the kernel outputs of the stage before."""
        xnat = torch.nn.functional.pad(
            xv, (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
        k1 = (lambda: ts._xprep_pass(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w),
              lambda: ts._xprep_plain(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w))
        x2d = k1[0]()
        if plan.hot_cols.shape[0]:
            hot = xv.index_select(0, dplan.hot_cols).reshape(-1, 1, 128)
            x2d = torch.cat([x2d, hot.expand(-1, 128, 128).reshape(-1, 128)])
        kw = dict(sr=st.PLUS_TIMES, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
                  out_rows=rd["out_rows"])
        args2 = (x2d, Ax, g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"])
        k2 = (lambda: ts._reduce_pass(*args2, **kw), lambda: ts._reduce_plain(*args2, **kw))
        part = k2[0]()
        k5 = (lambda: tsh.apply_shuffle(part, plan.shuffle, dplan.shuffle_dev),
              lambda: _shuffle_plain(part))
        prod = k5[0]()
        prod = torch.nn.functional.pad(prod, (0, 0, 0, F_pad * 128 - prod.shape[0]))
        args6 = (prod, *[sc[k] for k in scan_keys])
        k6 = (lambda: ts._scan_pass(*args6, F_pad=F_pad),
              lambda: ts._scan_diff_plain(*args6, F_pad=F_pad))
        return [("K1 xprep", *k1, True), ("K2 reduce", *k2, False),
                ("K5 split", *k5, True), ("K6 scan", *k6, False)]

    def _shuffle_plain(data):
        for p, d in zip(plan.shuffle.passes, dplan.shuffle_dev):
            data = tsh._split_plain(
                data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"],
                n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                rows_per_g=p.out_rows // p.K).reshape(p.out_rows, 128)
        return data

    results = {}
    for (name, kern, plain, exact), (_, kern_i, plain_i, _) in zip(
            stages(g["Ax"], x), stages(ints["Ax"], ints["x"])):
        a, b = kern(), plain()
        ai, bi = kern_i(), plain_i()
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        check(torch.isfinite(a).all(), f"{name}: non-finite kernel output")
        check(torch.equal(ai, bi), f"{name}: differs from its plain version "
                                   f"on integer-valued data")
        if exact:
            check(torch.equal(a, b), f"{name}: not bitwise equal to its plain "
                                     f"version (max |diff| {err})")
        else:
            check(torch.allclose(a, b, rtol=RTOL, atol=ATOL),
                  f"{name}: outside rtol {RTOL} atol {ATOL} of its plain "
                  f"version (max |diff| {err})")
        tk = cuda_time_ms(kern, iters=ITERS)["median_ms"]
        tp = cuda_time_ms(plain, iters=ITERS)["median_ms"]
        results[name] = {"max_abs_err": err, "ms": tk, "plain_ms": tp}
        print(f"{name}: matches plain version ({'bitwise' if exact else f'rtol {RTOL} atol {ATOL}'}"
              f" on normal data, bitwise on integer data), max |diff| {err:.3e}; "
              f"kernel {tk:.4f} ms, plain {tp:.4f} ms (median of {ITERS}; {card})")

    # 5. end to end on the bench and wide-row matrices
    kernels = (ts._xprep_pass, ts._reduce_pass, tsh._run_split, ts._scan_pass)
    launches = None
    for label, A_m, x_m_np, plan_m, plan_m_s in _matrices(A, x_np, plan, plan_s,
                                                          power_law_csr, build_plan):
        x_m = torch.from_numpy(x_m_np).to(dev)
        st.spmv("stream", A_m, x_m)  # uploads the plan, warms the path
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        y = st.spmv("stream", A_m, x_m)
        torch.cuda.synchronize()
        counts = [k.launches for k in kernels]
        want = [1, 1, len(plan_m.shuffle.passes), 1]
        check(counts == want, f"{label}: launches K1,K2,K5,K6 = {counts}, want {want}")
        if launches is None:
            launches = counts
        y_np = y.cpu().numpy()
        check(y.shape == (A_m.n_rows,) and np.isfinite(y_np).all(),
              f"{label}: y not finite or of the wrong shape")
        y_ref = st.spmv_ref(A_m, x_m_np, y_dtype=np.float64)
        delta = correctness_delta(y_ref, y_np)
        ok = np.allclose(y_np, y_ref, rtol=RTOL, atol=ATOL)
        check(ok, f"{label}: y outside rtol {RTOL} atol {ATOL} of the oracle "
                  f"(max_rel {delta['max_rel']:.3e})")
        t = cuda_time_ms(lambda: st.spmv("stream", A_m, x_m), iters=20)["median_ms"]
        with warnings.catch_warnings():  # beta-state notices of torch.sparse
            warnings.simplefilter("ignore", UserWarning)
            Ms = torch.sparse_csr_tensor(
                torch.from_numpy(np.asarray(A_m.Ap, np.int64)),
                torch.from_numpy(np.asarray(A_m.Aj, np.int64)),
                torch.from_numpy(np.asarray(A_m.Ax)), size=A_m.shape).to(dev)
        y_cs = Ms @ x_m
        cs_err = correctness_delta(y_ref, y_cs.cpu().numpy())["max_rel"]
        tcs = cuda_time_ms(lambda: Ms @ x_m, iters=20)["median_ms"]
        print(f"{label}: nnz {A_m.nnz}, within rtol {RTOL} atol {ATOL} of the "
              f"oracle, max_rel {delta['max_rel']:.3e}, mean_abs "
              f"{delta['mean_abs']:.3e}; launches K1,K2,K5,K6 {counts}; plan "
              f"build {plan_m_s:.3f} s (host); stream {t:.4f} ms/call = "
              f"{A_m.nnz / t / 1e6:.3f} Gnnz/s; cuSPARSE (torch.sparse_csr_tensor "
              f"@ x, comparison only) {tcs:.4f} ms = {A_m.nnz / tcs / 1e6:.3f} "
              f"Gnnz/s, max_rel {cs_err:.3e} ({card})")

    # 6. or-and on the bench matrix against the semiring oracle
    rng = np.random.default_rng(2)
    x_or = np.where(rng.random(A.n_cols) < 0.9, 0.0, x_np).astype(np.float32)
    y_or = st.spmv("stream", A, torch.from_numpy(x_or).to(dev),
                   semiring=st.OR_AND).cpu().numpy()
    y_or_ref = st.spmv_ref_semiring(A, x_or, st.OR_AND)
    check(np.array_equal(y_or, y_or_ref), "or_and: differs from the oracle")
    print(f"or_and on the bench matrix: equals the semiring oracle "
          f"({int(y_or.sum())} of {A.n_rows} rows true)")

    # 7. an unported branch raises, naming its TPU kernel
    R = random_csr(20000, 30000, 150000, seed=1)
    try:
        st.spmv("stream", R, torch.zeros(R.n_cols, device=dev))
        fail("random_csr plan did not raise NotImplementedError")
    except NotImplementedError as e:
        check("K3" in str(e), f"NotImplementedError does not name K3: {e}")
        print(f"random_csr(20000, 30000, 150000, seed=1): NotImplementedError ({e})")

    check("jax" not in sys.modules, "jax was imported")
    sources = {"K1 xprep": ("spmv_tpu_torch/csrc/stream_kernels.cu",
                            "spmv_tpu/kernels/stream.py:1348", 0),
               "K2 reduce": ("spmv_tpu_torch/csrc/stream_kernels.cu",
                             "spmv_tpu/kernels/stream.py:1309", 1),
               "K5 split": ("spmv_tpu_torch/csrc/shuffle_kernels.cu",
                            "spmv_tpu/kernels/shuffle.py:607", 2),
               "K6 scan": ("spmv_tpu_torch/csrc/stream_kernels.cu",
                           "spmv_tpu/kernels/stream.py:1598", 3)}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[i], **results[name]}
        for name, (src, rep, i) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _matrices(A, x_np, plan, plan_s, power_law_csr, build_plan):
    yield "bench", A, x_np, plan, plan_s
    W = power_law_csr(1 << 20, 1 << 20, 16_777_216, alpha=1.5, seed=42)
    xw = np.random.default_rng(0).standard_normal(W.n_cols).astype(np.float32)
    plan_w, plan_w_s = build_plan(W)
    print(f"wide-row plan: {plan_w.n_gather_tiles} gather tiles, "
          f"{plan_w.n_final_tiles} final tiles, passes "
          f"{[(p.sbt, p.n_steps, p.K, p.Q) for p in plan_w.shuffle.passes]}")
    yield "wide_row", W, xw, plan_w, plan_w_s


if __name__ == "__main__":
    sys.exit(main())
