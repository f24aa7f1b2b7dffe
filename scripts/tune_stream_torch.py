"""Measure the stream pipeline's tuning row on the card, as the reference
measured its v5e row (`spmv_tpu/ops/tuning.py`), and hold the pick on
every path that reads the row.

    python scripts/tune_stream_torch.py sweep --width 4 --out FILE
    python scripts/tune_stream_torch.py hold --sweep FILE --out FILE

`sweep` runs `spmv_tpu_torch.ops.tuning.autotune_stream` on bench,
power_law_csr(1<<20, 1<<20, 3.3M, alpha 1.5, seed 42) (`bench.py:91-95`),
with float32 (`--width 4`) or bfloat16 (`--width 2`) values and x: kappa in
{8192, 10240, 12288, 14336, 16384}, then scan_sbt 16 at the winner, each
candidate the median of three `benchmark_fn` kernel_s samples (device time a
call, from CUDA-graph chains). It appends one JSON line to FILE: the card's
name and power limit, every candidate's kernel_s, and the plan at each
kappa (gather tiles, final tiles, shuffle passes, reduce). Run it in at
least three processes per width.

`hold` reads those lines. A width's pick is the kappa of least median
kernel_s over the runs. It then times, in one process, the paths that read
the row at the base kappa 14336 and at the two best other candidates of
the sweep, in turns: base, c1, c2, c2, c1, base. The paths: `spmv("stream")` on bench in plus-times, in min-plus and
with bfloat16 values (the 2-byte candidates), on the wide-row matrix
(16,777,216 nnz), on random 4.2M, on the sssp graph in min-plus, on the
1M-row nonsymmetric matrix of `chip_smoke.py` phase 33; each time the
median of three kernel_s samples. And `distribute_stream` on bench at 2
and 4 local shards: ms a replayed matvec, CUDA events, median of 30. The
policy is installed with `tuning.set_active`, so each path picks it up
where it reads the row. It appends one JSON line a path to FILE: each
kappa's plan, host plan seconds, the times in order, and the outputs held
against the base kappa's (min-plus bit for bit, plus-times within rtol
2e-4 of max |y|); a kappa the planner refuses is recorded as its error.

It imports no JAX and needs the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

BASE = 14336
BENCH = (1 << 20, 3_300_000)           # power_law_csr rows, nnz (alpha 1.5, seed 42)
WIDE_NNZ = 16_777_216                  # the wide-row matrix: bench's rows at this nnz
RANDOM = (1 << 20, 4_194_304)          # random_csr rows, nnz (seed 42)
GRAPH = 1 << 20                        # random_graph(GRAPH, 4, seed 0)
NONSYM = 1 << 20                       # chip_smoke.nonsym_csr(NONSYM)
SHARDS = (2, 4)
ITERS = 20                             # benchmark_fn's chain length


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def bench_csr(width: int, nnz=None):
    """bench (or the wide-row matrix at `nnz`), its values bfloat16 at
    width 2."""
    import torch

    import spmv_tpu_torch as st
    from spmv_tpu_torch.io.generate import power_law_csr

    A = power_law_csr(BENCH[0], BENCH[0], nnz or BENCH[1], alpha=1.5, seed=42)
    if width == 2:
        A = st.CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
                   torch.from_numpy(np.asarray(A.Ax)).bfloat16())
    return A


def x_for(A, dev, width: int, nonneg: bool = False):
    import torch

    x = np.random.default_rng(0).standard_normal(A.n_cols).astype(np.float32)
    x = torch.from_numpy(np.abs(x) if nonneg else x)
    return (x.bfloat16() if width == 2 else x).to(dev)


def plan_shape(A, kappa: int) -> dict:
    """The stream plan cached on A under StreamPolicy(kappa)."""
    from spmv_tpu_torch.kernels import stream as ts
    from spmv_tpu_torch.ops.registry import plan_cache, plan_cached

    key = ts.plan_cache_key(ts.StreamPolicy(kappa=kappa))
    if not plan_cached(A, key):
        return {}
    p = plan_cache(A, key, None)
    return {"gather_tiles": p.n_gather_tiles, "final_tiles": p.n_final_tiles,
            "passes": [[q.sbt, q.n_steps, q.K, q.Q] for q in p.shuffle.passes],
            "reduce": p.reduce is not None}


def dist_shape(D) -> dict:
    u = D.uni
    return {"gather_tiles": u.pad_tiles, "final_tiles": u.F_pad,
            "passes": [[m["sbt"], m["n_steps"], m["K"], m["Q"]] for m in u.split_meta],
            "Qp": u.Qp}


def emit(line: dict, out: str) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    with open(out, "a") as f:
        f.write(text + "\n")


def sweep(dev, width: int, out: str, card: str) -> dict:
    from spmv_tpu_torch.ops import tuning

    A = bench_csr(width)
    x = x_for(A, dev, width)
    t0 = time.perf_counter()
    best, results = tuning.autotune_stream(A, x, iters=ITERS)
    line = {"what": "sweep", "card": card, "width": width, "matrix": "bench",
            "results": results, "best": best,
            "plans": {str(k): plan_shape(A, k) for k in tuning.KAPPAS},
            "seconds": time.perf_counter() - t0}
    emit(line, out)
    return line


def picks(path: str) -> dict:
    """{width: [kappas by median kernel_s over the sweep runs, least first]}
    of the sweep lines in `path` (the scan_sbt stage left out)."""
    times = {}
    with open(path) as f:
        for text in f:
            line = json.loads(text)
            if line.get("what") != "sweep":
                continue
            for r in line["results"]:
                if r["scan_sbt"] == 8:
                    times.setdefault(line["width"], {}).setdefault(r["kappa"], []).append(
                        r["kernel_s"])
    return {w: sorted(t, key=lambda k: float(np.median(t[k]))) for w, t in times.items()}


def same(ys: dict, exact: bool) -> dict:
    """Each kappa's y against the base kappa's: bit for bit (NaN as NaN)
    or the largest |difference| over max(1, max |y|)."""
    import torch

    ref = ys.get(BASE)
    out = {}
    for k, y in ys.items():
        if ref is None or k == BASE:
            continue
        if exact:
            out[k] = bool(torch.equal(torch.nan_to_num(y, nan=0.5), torch.nan_to_num(ref, nan=0.5)))
        else:
            scale = max(1.0, float(ref.float().abs().max()))
            out[k] = float((y.float() - ref.float()).abs().max()) / scale
    return out


def hold_spmv(name, A, x, sr, kappas, dev, out, card):
    """`spmv("stream", A, x, semiring=sr)` at each kappa: plans, then
    median-of-3 kernel_s in turns base, c1, .., c1, base."""
    import torch

    import spmv_tpu_torch as st
    from spmv_tpu_torch.ops import tuning
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.ops.semiring import PLUS_TIMES

    run = lambda v: st.spmv("stream", A, v, semiring=sr)
    line = {"what": "hold", "card": card, "path": name, "nnz": int(A.nnz), "plans": {},
            "plan_s": {}, "errors": {}, "kernel_s": []}
    ys, live = {}, []
    for k in kappas:
        tuning.set_active({"kappa": k, "scan_sbt": 8})
        t = time.perf_counter()
        try:
            ys[k] = run(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except (PlanCapacityError, ValueError) as e:
            line["errors"][k] = f"{type(e).__name__}: {e}"
            continue
        line["plan_s"][k] = time.perf_counter() - t
        line["plans"][k] = plan_shape(A, k)
        live.append(k)
    line["same"] = same(ys, exact=sr is not PLUS_TIMES)
    del ys
    for k in live + live[::-1]:
        tuning.set_active({"kappa": k, "scan_sbt": 8})
        line["kernel_s"].append([k, tuning.med3_kernel_s(run, x, ITERS)])
    tuning.set_active(None)
    emit(line, out)


def hold_dist(A, x, n, kappas, dev, out, card):
    """`distribute_stream` over n local shards at each kappa: ms a
    replayed matvec, in turns; a kappa whose plan does not fit the common
    geometry (PlanCapacityError, where callers fall back to
    distribute_csr) is recorded as its error."""
    import torch

    from spmv_tpu_torch.ops import tuning
    from spmv_tpu_torch.ops.registry import PlanCapacityError
    from spmv_tpu_torch.parallel import distribute_stream, make_mesh

    mesh = make_mesh("shards", n_shards=n, device=dev)
    line = {"what": "hold", "card": card, "path": f"distribute_stream {n} shards",
            "nnz": int(A.nnz), "plans": {}, "plan_s": {}, "errors": {}, "ms": []}
    Ds, ys = {}, {}
    for k in kappas:
        tuning.set_active({"kappa": k, "scan_sbt": 8})
        t = time.perf_counter()
        try:
            Ds[k] = distribute_stream(A, mesh)
        except PlanCapacityError as e:
            line["errors"][k] = f"{type(e).__name__}: {e}"
            continue
        line["plan_s"][k] = time.perf_counter() - t
        line["plans"][k] = dist_shape(Ds[k])
        ys[k] = Ds[k].matvec(x)
    tuning.set_active(None)
    line["same"] = same(ys, exact=False)
    for k in list(Ds) + list(Ds)[::-1]:
        line["ms"].append([k, events_ms(lambda: Ds[k].matvec(x), 30, dev)])
    emit(line, out)


def events_ms(fn, iters: int, dev) -> float:
    """Median ms of one fn() call between a CUDA event pair, over `iters`
    pairs, after two calls (the host clock on the CPU)."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(iters):
        if dev.type != "cuda":
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
            continue
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def candidates(order):
    """14336 and the two best other kappas of a width's sweep."""
    return [BASE] + [k for k in order if k != BASE][:2]


def hold(dev, sweep_path: str, out: str, card: str) -> None:
    from spmv_tpu_torch.examples.shortest_paths import random_graph
    from spmv_tpu_torch.io.generate import random_csr
    from spmv_tpu_torch.ops.semiring import MIN_PLUS, PLUS_TIMES

    order = picks(sweep_path)
    k4, k2 = candidates(order.get(4, [])), candidates(order.get(2, []))
    emit({"what": "picks", "card": card, "order": order, "held_4": k4, "held_2": k2}, out)
    B = bench_csr(4)
    xb = x_for(B, dev, 4)
    hold_spmv("bench plus-times", B, xb, PLUS_TIMES, k4, dev, out, card)
    hold_spmv("bench min-plus", B, x_for(B, dev, 4, nonneg=True), MIN_PLUS, k4, dev, out, card)
    B2 = bench_csr(2)
    hold_spmv("bench bfloat16 plus-times", B2, x_for(B2, dev, 2), PLUS_TIMES, k2, dev, out,
              card)
    del B2
    for n in SHARDS:
        hold_dist(B, xb, n, k4, dev, out, card)
    del B, xb
    for name, make, sr in (
            ("wide_row plus-times", lambda: bench_csr(4, WIDE_NNZ), PLUS_TIMES),
            ("random 4.2M plus-times",
             lambda: random_csr(RANDOM[0], RANDOM[0], RANDOM[1], seed=42), PLUS_TIMES),
            ("sssp graph min-plus", lambda: random_graph(GRAPH, 4, seed=0), MIN_PLUS),
            ("nonsym 1M plus-times", lambda: nonsym_csr(NONSYM), PLUS_TIMES)):
        A = make()
        hold_spmv(name, A, x_for(A, dev, 4, nonneg=sr is MIN_PLUS), sr, k4, dev, out, card)
        del A


def nonsym_csr(n: int):
    """chip_smoke.py's nonsym_csr(n): its phase 33's GMRES matrix."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                                    "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.nonsym_csr(n)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "hold"))
    ap.add_argument("--width", type=int, choices=(2, 4), default=4)
    ap.add_argument("--sweep", help="the sweep lines (hold)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tune_stream_torch: no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_name()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.mode == "sweep":
        sweep(dev, args.width, args.out, card)
    else:
        hold(dev, args.sweep, args.out, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
