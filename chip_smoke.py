#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (spmv_tpu_torch) on one GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It drives the port's paths with x on the card and checks them:

- the plus-times stream path on the bench matrix (power_law_csr(1<<20,
  1<<20, 3.3M, alpha 1.5, seed 42), the size class of SuiteSparse's
  webbase-1M) and on the 16.8M-nnz wide-row matrix: K1 -> K2 -> K5 -> K6;
- single-source shortest paths by min-plus SpMV through `merge_genl`
  on a 1M-vertex, 4.2M-edge random graph of out-degree 4
  (spmv_tpu_torch.examples.shortest_paths.random_graph(1<<20, 4, seed 0),
  the size class of SuiteSparse's roadNet-PA), to its fixed point:
  K3 -> K5 -> K8 per relaxation;
- min-plus and max-times on the bench matrix (K1 -> K7 -> K5 -> K8),
  plus-times on the graph and on random_csr(1<<20, 1<<20, 4.2M, seed 42)
  (K3 -> K5 -> K6), or-and on both matrices.

Phases:

1. the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
2. builds the eight CUDA kernels from csrc/ (one nvcc per source, in
   parallel, into the git-ignored spmv_tpu_torch/_build/);
3. each kernel against its plain PyTorch version on the card, on its
   plans' own arrays, each fed the kernel outputs of the stage before:
   K1, K5, K3, K4 bit for bit; K7 and K8 bit for bit for min and max
   rings; K2 and K6 bit for bit on integer-valued data and within rtol
   2e-4 / atol 1e-5 on normal data; K3 == K4 + one K5 pass bit for bit;
   each kernel's median time over 30 launches beside its plain
   version's;
4. plus-times end to end on the bench and wide-row matrices against the
   float64 oracle (rtol 2e-4, atol 1e-5), with launch counts, ms per
   call, Gnnz/s, and cuSPARSE (`torch.sparse_csr_tensor @ x`) for
   comparison;
5. the shortest paths: every relaxation equal to the semiring oracle
   bit for bit, the final distances within 1e-4 of SciPy's Dijkstra in
   float64, launch counts, ms per relaxation and Gnnz/s;
6. the other rings and matrices against their oracles, with launch
   counts.

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
    t_start = time.perf_counter()

    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr, random_csr
    from spmv_tpu_torch.kernels import _cuda
    from spmv_tpu_torch.kernels import merge as tm
    from spmv_tpu_torch.kernels import shuffle as tsh
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.reference import correctness_delta
    from spmv_tpu_torch.ops.registry import plan_cache
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
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

    counters = {"K1 xprep": ts._xprep_pass, "K2 reduce": ts._reduce_diff_pass,
                "K3 gather_split": ts._gather_split_pass,
                "K4 gather": ts._gather_pass, "K5 split": tsh._run_split,
                "K6 scan": ts._scan_diff_pass, "K7 reduce_roll": ts._reduce_roll_pass,
                "K8 scan_roll": ts._scan_roll_pass}

    def reset():
        for k in counters.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in counters.items() if k.launches}

    def build_plan(A, label):
        pol = tm._stream_policy_for(14336, dev)  # = the stream kind's on the card
        t = time.perf_counter()
        plan = ts.build_stream_plan(A, pol)
        secs = time.perf_counter() - t
        plan_cache(A, ts.plan_cache_key(pol), lambda: plan)
        p = plan.shuffle.passes
        print(f"{label} plan: {plan.n_gather_tiles} gather tiles, "
              f"{plan.n_final_tiles} final tiles, reduce "
              f"{plan.reduce is not None}, passes "
              f"{[(q.sbt, q.n_steps, q.K, q.Q) for q in p]}, built in "
              f"{secs:.3f} s on the host")
        return plan, plan.to(dev), secs

    results = {}

    def hold(name, kern, plain, exact, ints=None, note="", time_it=True):
        """Hold kernel against plain on normal data (and, for sums,
        bit for bit on integer data via `ints`), and time both."""
        a, b = kern(), plain()
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        check(torch.isfinite(a).any() or a.numel() == 0,
              f"{name}: no finite kernel output")
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
              f"{name}: infinities differ from its plain version")
        if exact:
            check(torch.equal(a, b), f"{name}{note}: not bitwise equal to its "
                                     f"plain version (max |diff| {err})")
        else:
            check(torch.allclose(a, b, rtol=RTOL, atol=ATOL),
                  f"{name}{note}: outside rtol {RTOL} atol {ATOL} of its plain "
                  f"version (max |diff| {err})")
        if ints is not None:
            ai, bi = ints[0](), ints[1]()
            check(torch.equal(ai, bi), f"{name}{note}: differs from its plain "
                                       f"version on integer-valued data")
        fin = torch.isfinite(b)
        err = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
        how = "bitwise" if exact else f"rtol {RTOL} atol {ATOL}"
        if ints is not None:
            how += " (bitwise on integer data)"
        msg = f"{name}{note}: matches plain version, {how}, max |diff| {err:.3e}"
        if time_it:
            tk = cuda_time_ms(kern, iters=ITERS)["median_ms"]
            tp = cuda_time_ms(plain, iters=ITERS)["median_ms"]
            results[name] = {"max_abs_err": err, "ms": tk, "plain_ms": tp}
            msg += (f"; kernel {tk:.4f} ms, plain {tp:.4f} ms (median of {ITERS}; "
                    f"{card})")
        print(msg)
        return a

    # 3a. K1, K2, K5, K6 (plus-times) and K7, K8 (min / max) on the bench plan
    A = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    x_np = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    plan, dplan, plan_s = build_plan(A, "bench")
    check(plan.reduce is not None and "xr1" in plan.gather,
          "bench plan is not on the reduction branch with the lane remap")
    g, rd, sc = dplan.gather, dplan.reduce, dplan.scan
    n_w = plan.x_rows_pad // 128
    F_pad = int(sc["counts"].shape[0])
    gen = torch.Generator(device=dev).manual_seed(1)
    Ax_int = torch.randint(-4, 5, tuple(g["Ax"].shape), generator=gen, device=dev).float()
    x_int = torch.randint(-4, 5, (A.n_cols,), generator=gen, device=dev).float()
    x = torch.from_numpy(x_np).to(dev)
    print(f"audit_plan bytes per call (bench): "
          f"{ts.audit_plan(plan, A.nnz)['per_pass_bytes']}")

    def shuffle_plain(data, passes, sdev, fill=0.0):
        for p, d in zip(passes, sdev):
            data = tsh._split_plain(
                data, d["s1"], d["s2"], d["s3"], d["starts"], d["pos"],
                n_steps=p.n_steps, sbt=p.sbt, K=p.K, Q=p.Q,
                rows_per_g=p.out_rows // p.K, fill=fill).reshape(p.out_rows, 128)
        return data

    def pad_fin(prod, F, fill):
        return torch.nn.functional.pad(prod, (0, 0, 0, F * 128 - prod.shape[0]),
                                       value=fill)[:F * 128].contiguous()

    def bench_stages(Ax, xv):
        xnat = torch.nn.functional.pad(
            xv, (0, g["x_nat_rows"] * 128 - A.n_cols)).reshape(-1, 128)
        k1 = (lambda: ts._xprep_pass(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w),
              lambda: ts._xprep_plain(xnat, g["g0"], g["xr1"], g["xr2"], g["xr3"], n_w=n_w))
        x2d = ts._x_table(dplan, xv, A.n_cols)
        kw = dict(sr=PLUS_TIMES, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
                  out_rows=rd["out_rows"])
        args2 = (x2d, Ax, g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"])
        k2 = (lambda: ts._reduce_diff_pass(*args2, **kw),
              lambda: ts._reduce_diff_plain(*args2, **kw))
        part = k2[0]()
        passes, sdev = plan.shuffle.passes, dplan.shuffle_dev
        k5 = (lambda: tsh.apply_shuffle(part, passes, sdev),
              lambda: shuffle_plain(part, passes, sdev))
        prod = pad_fin(k5[0](), F_pad, 0.0)
        args6 = (prod, *[sc[k] for k in ("pm1", "pm2", "pm3", "r2s1", "r2s2",
                                          "r2s3", "q2s1", "q2s2", "q2s3",
                                          "valid2", "counts")])
        k6 = (lambda: ts._scan_diff_pass(*args6, F_pad=F_pad),
              lambda: ts._scan_diff_plain(*args6, F_pad=F_pad))
        return {"K1 xprep": k1, "K2 reduce": k2, "K5 split": k5, "K6 scan": k6}

    normal, ints = bench_stages(g["Ax"], x), bench_stages(Ax_int, x_int)
    for name in ("K1 xprep", "K2 reduce", "K5 split", "K6 scan"):
        exact = name in ("K1 xprep", "K5 split")
        hold(name, *normal[name], exact, ints=None if exact else ints[name])

    def roll_chain(sr, x2d):
        """K7 -> K5 -> K8 on the bench plan for ring sr: the kernel and
        plain calls of K7 and of K8 (fed the kernels' own outputs)."""
        ident = float(sr.identity_for(np.float32))
        kw = dict(sr=sr, n_tiles=plan.n_gather_tiles, Qp=rd["Qp"],
                  out_rows=rd["out_rows"])
        args7 = (x2d, g["Ax"], g["q"], g["xb"], rd["c1"], rd["c2"], rd["c3"], rd["rs"])
        k7 = (lambda: ts._reduce_roll_pass(*args7, **kw),
              lambda: ts._reduce_roll_plain(*args7, **kw))
        prod = pad_fin(tsh.apply_shuffle(k7[0](), plan.shuffle.passes,
                                         dplan.shuffle_dev, fill=ident), F_pad, ident)
        args8 = (prod, *[sc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1",
                                          "r2s2", "r2s3", "valid2")])
        k8 = (lambda: ts._scan_roll_pass(*args8, sr=sr, F_pad=F_pad),
              lambda: ts._scan_roll_plain(*args8, sr=sr, F_pad=F_pad))
        return k7, k8

    x2d_bench = ts._x_table(dplan, x, A.n_cols)
    k7_min, _ = roll_chain(MIN_PLUS, x2d_bench)
    hold("K7 reduce_roll", *k7_min, True, note=" (bench plan, min_plus)")
    k7_max, k8_max = roll_chain(MAX_TIMES, x2d_bench)
    hold("K7 reduce_roll", *k7_max, True, note=" (bench plan, max_times)",
         time_it=False)
    hold("K8 scan_roll (bench plan, max_times)", *k8_max, True)

    # 3b. K4, K3, K5 and K8 on the shortest-paths graph's plan
    from spmv_tpu_torch.examples.shortest_paths import random_graph, sssp

    G = random_graph(1 << 20, 4, seed=0)
    gplan, gdplan, gplan_s = build_plan(G, "sssp graph")
    gp0 = gplan.shuffle.passes[0]
    check(gplan.reduce is None and gp0.sbt == 8
          and gp0.n_steps * 8 == gplan.n_gather_tiles,
          "sssp graph plan is not on the fused no-reduction branch (K3)")
    gg, gsc, gd0 = gdplan.gather, gdplan.scan, gdplan.shuffle_dev[0]
    gF = int(gsc["counts"].shape[0])
    gt = gplan.n_gather_tiles
    d_np = np.random.default_rng(5).uniform(0.0, 30.0, G.n_cols).astype(np.float32)
    d_np[np.random.default_rng(6).random(G.n_cols) < 0.3] = np.inf
    x2d_g = ts._x_table(gdplan, torch.from_numpy(d_np).to(dev), G.n_cols)
    kw3 = dict(sbt=8, n_tiles=gt, K=gp0.K, Q=gp0.Q, rows_per_g=gp0.out_rows // gp0.K)
    args3 = (x2d_g, gg["Ax"], gg["q"], gg["xb"], gd0["s1"], gd0["s2"], gd0["s3"],
             gd0["starts"], gd0["pos"])
    for sr in (MIN_PLUS, PLUS_TIMES):
        note = f" (sssp graph plan, {sr.name})"
        timed = sr is MIN_PLUS
        ident = float(sr.identity_for(np.float32))
        prod4 = hold("K4 gather", lambda: ts._gather_pass(*args3[:4], sr=sr, n_tiles=gt),
                     lambda: ts._gather_plain(*args3[:4], sr=sr, n_tiles=gt), True,
                     note=note, time_it=timed)
        fused = hold("K3 gather_split",
                     lambda: ts._gather_split_pass(*args3, sr=sr, gaps=gd0["gaps"], **kw3),
                     lambda: ts._gather_split_plain(*args3, sr=sr, **kw3), True,
                     note=note, time_it=timed)
        split = tsh._run_split(prod4, gd0["s1"], gd0["s2"], gd0["s3"], gd0["starts"],
                               gd0["pos"], n_steps=gp0.n_steps, sbt=8, K=gp0.K,
                               Q=gp0.Q, rows_per_g=gp0.out_rows // gp0.K,
                               gaps=gd0["gaps"], fill=ident)
        torch.cuda.synchronize()
        check(torch.equal(fused, split), f"K3 != K4 + K5 pass 1{note}")
        print(f"K3 == K4 + one K5 pass, bit for bit{note}")
    fused = ts._gather_split_pass(*args3, sr=MIN_PLUS, gaps=gd0["gaps"], **kw3)
    rest = (gplan.shuffle.passes[1:], gdplan.shuffle_dev[1:])
    hold("K5 split", lambda: tsh.apply_shuffle(fused.reshape(-1, 128), *rest, fill=np.inf),
         lambda: shuffle_plain(fused.reshape(-1, 128), *rest, fill=np.inf), True,
         note=" (sssp graph plan, passes 2..)", time_it=False)
    gprod = pad_fin(tsh.apply_shuffle(fused.reshape(-1, 128), *rest, fill=np.inf),
                    gF, np.inf)
    args8 = (gprod, *[gsc[k] for k in ("relid", "pm1", "pm2", "pm3", "r2s1",
                                        "r2s2", "r2s3", "valid2")])
    hold("K8 scan_roll", lambda: ts._scan_roll_pass(*args8, sr=MIN_PLUS, F_pad=gF),
         lambda: ts._scan_roll_plain(*args8, sr=MIN_PLUS, F_pad=gF), True,
         note=" (sssp graph plan, min_plus)")
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    def end_to_end(label, A_m, x_m_np, plan_s, want):
        """Plus-times `spmv("stream", A_m, x)` on the card against the
        float64 oracle and cuSPARSE; checks the launch counts of one call."""
        x_m = torch.from_numpy(x_m_np).to(dev)
        st.spmv("stream", A_m, x_m)  # uploads the plan, warms the path
        torch.cuda.synchronize()
        reset()
        y = st.spmv("stream", A_m, x_m)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{label}: launches {c}, want {want}")
        y_np = y.cpu().numpy()
        check(y.shape == (A_m.n_rows,) and np.isfinite(y_np).all(),
              f"{label}: y not finite or of the wrong shape")
        y_ref = st.spmv_ref(A_m, x_m_np, y_dtype=np.float64)
        delta = correctness_delta(y_ref, y_np)
        check(np.allclose(y_np, y_ref, rtol=RTOL, atol=ATOL),
              f"{label}: y outside rtol {RTOL} atol {ATOL} of the oracle "
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
        print(f"{label} plus_times: nnz {A_m.nnz}, within rtol {RTOL} atol {ATOL} of "
              f"the oracle, max_rel {delta['max_rel']:.3e}, mean_abs "
              f"{delta['mean_abs']:.3e}; launches {c}; plan build {plan_s:.3f} s "
              f"(host); stream {t:.4f} ms/call = {A_m.nnz / t / 1e6:.3f} Gnnz/s; "
              f"cuSPARSE (torch.sparse_csr_tensor @ x, comparison only) {tcs:.4f} ms "
              f"= {A_m.nnz / tcs / 1e6:.3f} Gnnz/s, max_rel {cs_err:.3e} ({card})")
        return c

    launches = {}

    # 4. plus-times end to end on the bench and wide-row matrices
    W = power_law_csr(1 << 20, 1 << 20, 16_777_216, alpha=1.5, seed=42)
    xw = np.random.default_rng(0).standard_normal(W.n_cols).astype(np.float32)
    wplan, _, wplan_s = build_plan(W, "wide-row")
    for label, A_m, x_m_np, plan_m, plan_m_s in (
            ("bench", A, x_np, plan, plan_s), ("wide_row", W, xw, wplan, wplan_s)):
        want = {"K1 xprep": 1, "K2 reduce": 1,
                "K5 split": len(plan_m.shuffle.passes), "K6 scan": 1}
        c = end_to_end(label, A_m, x_m_np, plan_m_s, want)
        if label == "bench":
            launches.update({k: c[k] for k in ("K1 xprep", "K2 reduce", "K6 scan")})
    del W, wplan

    # 5. the shortest paths through merge_genl, to the fixed point
    n_checked = [0]

    def exact_relaxation(d, relaxed):
        want = st.spmv_ref_semiring(G, d.cpu().numpy(), MIN_PLUS)
        check(np.array_equal(relaxed.cpu().numpy(), want),
              f"sssp relaxation {n_checked[0] + 1} differs from the semiring oracle")
        n_checked[0] += 1

    reset()
    d, iters = sssp(G, 0, kind="merge_genl", device=dev, on_relax=exact_relaxation)
    torch.cuda.synchronize()
    run_counts = counts()
    passes = len(gplan.shuffle.passes)
    check(run_counts == {"K3 gather_split": iters, "K5 split": iters * (passes - 1),
                         "K8 scan_roll": iters},
          f"sssp: launches {run_counts} over {iters} relaxations")
    launches.update({k: run_counts[k] for k in ("K3 gather_split", "K8 scan_roll")})
    launches["K5 split"] = run_counts["K5 split"]
    reset()
    st.spmv("merge_genl", G, d, semiring=MIN_PLUS)
    torch.cuda.synchronize()
    one = counts()
    check(one == {"K3 gather_split": 1, "K5 split": passes - 1, "K8 scan_roll": 1},
          f"sssp: launches of one relaxation {one}")
    ref = dijkstra_scipy(G, 0)
    d_np = d.cpu().numpy()
    reach = np.isfinite(ref)
    check(np.array_equal(np.isfinite(d_np), reach), "sssp: reachable sets differ")
    err = float(np.abs(d_np[reach].astype(np.float64) - ref[reach]).max())
    check(err <= 1e-4, f"sssp: max |d - dijkstra| {err:.3e} > 1e-4")
    t_rel = cuda_time_ms(lambda: st.spmv("merge_genl", G, d, semiring=MIN_PLUS),
                         iters=20)["median_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, iters2 = sssp(G, 0, kind="merge_genl", device=dev)
    torch.cuda.synchronize()
    t_loop = (time.perf_counter() - t0) * 1e3
    print(f"sssp on random_graph(1<<20, 4, seed 0): nnz {G.nnz}, {iters} "
          f"relaxations to the fixed point (the allclose test), each equal to the "
          f"semiring oracle bit for bit; {int(reach.sum())} of {G.n_rows} vertices "
          f"reachable; max |d - scipy dijkstra (float64)| {err:.3e}; launches over "
          f"the run {run_counts}, of one relaxation {one}; one relaxation "
          f"{t_rel:.4f} ms = {G.nnz / t_rel / 1e6:.3f} Gnnz/s (CUDA events, median "
          f"of 20); whole loop {t_loop:.1f} ms for {iters2} relaxations = "
          f"{t_loop / iters2:.4f} ms each, host clock ({card})")

    # 6. the other rings and matrices against their oracles
    xg = np.random.default_rng(7).standard_normal(G.n_cols).astype(np.float32)
    R = random_csr(1 << 20, 1 << 20, 4_194_304, seed=42)
    xr = np.random.default_rng(8).standard_normal(R.n_cols).astype(np.float32)
    rplan, _, rplan_s = build_plan(R, "random 4.2M")
    for label, A_m, x_m_np, plan_m, plan_m_s in (
            ("sssp graph", G, xg, gplan, gplan_s), ("random 4.2M", R, xr, rplan, rplan_s)):
        want = {"K3 gather_split": 1, "K5 split": len(plan_m.shuffle.passes) - 1,
                "K6 scan": 1}
        end_to_end(label, A_m, x_m_np, plan_m_s, want)
    rng = np.random.default_rng(9)
    cases = [("bench", A, x_np, MIN_PLUS, {"K1 xprep": 1, "K7 reduce_roll": 1,
                                           "K5 split": len(plan.shuffle.passes),
                                           "K8 scan_roll": 1}),
             ("bench", A, x_np, MAX_TIMES, {"K1 xprep": 1, "K7 reduce_roll": 1,
                                            "K5 split": len(plan.shuffle.passes),
                                            "K8 scan_roll": 1}),
             ("bench", A, np.where(rng.random(A.n_cols) < 0.9, 0.0, x_np).astype(
                 np.float32), OR_AND, {"K1 xprep": 1, "K2 reduce": 1,
                                       "K5 split": len(plan.shuffle.passes),
                                       "K6 scan": 1}),
             ("sssp graph", G, np.where(rng.random(G.n_cols) < 0.7, 0.0, xg).astype(
                 np.float32), OR_AND, {"K3 gather_split": 1,
                                       "K5 split": len(gplan.shuffle.passes) - 1,
                                       "K6 scan": 1})]
    for label, A_m, x_m_np, sr, want in cases:
        xt = torch.from_numpy(x_m_np).to(dev)
        st.spmv("stream", A_m, xt, semiring=sr)
        torch.cuda.synchronize()
        reset()
        y = st.spmv("stream", A_m, xt, semiring=sr)
        torch.cuda.synchronize()
        c = counts()
        check(c == want, f"{label} {sr.name}: launches {c}, want {want}")
        if label == "bench" and sr is MIN_PLUS:
            launches["K7 reduce_roll"] = c["K7 reduce_roll"]
        y_np = y.cpu().numpy()
        check(np.array_equal(y_np, st.spmv_ref_semiring(A_m, x_m_np, sr)),
              f"{label} {sr.name}: differs from the semiring oracle")
        t = cuda_time_ms(lambda: st.spmv("stream", A_m, xt, semiring=sr),
                         iters=10)["median_ms"]
        print(f"{label} {sr.name}: equals the semiring oracle bit for bit "
              f"({int(np.isfinite(y_np).sum())} finite of {A_m.n_rows}); launches "
              f"{c}; {t:.4f} ms/call = {A_m.nnz / t / 1e6:.3f} Gnnz/s ({card})")

    launches["K4 gather"] = 0  # no plan the planner builds takes K4
    check("jax" not in sys.modules, "jax was imported")
    sources = {
        "K1 xprep": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1348"),
        "K2 reduce": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1309"),
        "K3 gather_split": ("gather_kernels.cu", "spmv_tpu/kernels/stream.py:1195"),
        "K4 gather": ("gather_kernels.cu", "spmv_tpu/kernels/stream.py:1572"),
        "K5 split": ("shuffle_kernels.cu", "spmv_tpu/kernels/shuffle.py:607"),
        "K6 scan": ("stream_kernels.cu", "spmv_tpu/kernels/stream.py:1598"),
        "K7 reduce_roll": ("roll_kernels.cu", "spmv_tpu/kernels/stream.py:1260"),
        "K8 scan_roll": ("roll_kernels.cu", "spmv_tpu/kernels/stream.py:1503"),
    }
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s; K4 is not on "
          f"any path the planner builds (pass 0 is always fused): it is held "
          f"against its plain version and checks K3 above")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"spmv_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name], **results[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dijkstra_scipy(G, source: int) -> np.ndarray:
    """SciPy's Dijkstra in float64 on the graph's out-edges (G holds
    in-edges), duplicate edges collapsed to their least weight first
    (csr_matrix would sum them)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    rows = G.row_ids().astype(np.int64)   # edge target
    cols = np.asarray(G.Aj, np.int64)     # edge source
    w = np.asarray(G.Ax, np.float64)
    order = np.lexsort((w, rows, cols))   # by (source, target), least weight first
    src, dst, w = cols[order], rows[order], w[order]
    first = np.ones(src.size, bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    M = csr_matrix((w[first], (src[first], dst[first])), shape=G.shape)
    return dijkstra(M, directed=True, indices=source)


if __name__ == "__main__":
    sys.exit(main())
