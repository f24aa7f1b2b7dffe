"""The multi-device matvec across the ranks of a process group, one card a
rank: the port's counterpart of the reference's `dryrun_multichip`
(`__graft_entry__.py:33`), at a real size.

    torchrun --standalone --nproc-per-node 4 scripts/multicard_torch.py [--json PATH]
    torchrun --standalone --nproc-per-node 4 scripts/multicard_torch.py --tree DIR --order-only

Matrices: bench (`power_law_csr(1<<20, 1<<20, 3_300_000, alpha=1.5,
seed=42)`) and the sssp graph (`random_graph(1<<20, 4, seed=0)`). Cases:
`distribute_csr` in halo and allgather modes in the four built-in rings
on both; `distribute_stream` in plus-times and min-plus on bench;
`distribute_csr` halo in bfloat16 plus-times on bench (A's values and x
rounded to bfloat16). Every rank runs every case in the same order, so
that every rank captures the same collectives in the same order, after
the eager first call that makes the communicator.

Each case, on every rank: the first call (eager, then captured); a
second call with a new x, a replay, against `_matvec_eager` on that x
(bit for bit: the row fold, K16, adds in a fixed order); the launches from
the graph's nodes (`utils/timing.py:graph_kernels`: K11' twice, or the
stream kernels, and NCCL's); in halo mode, where the graph puts the self
block against the exchange (`graph_edges`, `exchange_order`: no path
either way between the exchange's node and the self block's K11' or its
fold, the halo block's K11' downstream of it). Rank 0 joins the ranks'
owned rows, outside any timed window, and holds them to the 4-shard
local mesh on its own card (min, max and or rings bit for bit;
plus-times bit for bit or within one ulp, which is reported: a rank folds
its own shard's leaders, the local mesh every shard's in one K16 call,
and K16's chunks of a row's leaders then fall elsewhere, so its float64
sums may round to a neighbouring float32) and to `PERF.md` section 2's gate against
the float64 or semiring oracle (bfloat16: within 0.08 of max(1,
max|y|)).

Times, as rank 0's, the median over ranks and the slowest rank: ms a
matvec by replay and eagerly (CUDA events, medians), the host's enqueue
of a replay against the device's busy time a replay (torch.profiler,
NCCL's kernels left out: they spin on their own stream), exchange bytes
per shard, and the exchange alone, timed as a captured graph of just
the collective. The card's name and power limit are printed beside
them.

With --tree DIR it imports `spmv_tpu_torch` from DIR (another commit's
checkout). With --order-only it runs only `distribute_csr` halo
plus-times on bench and prints where each rank's graph puts the self
block against the exchange, read by this checkout's helpers whatever DIR
is, without holding it to the overlap: the way to see another commit's
order beside this one's.

It imports no JAX. Every rank needs a card; any failed check exits
non-zero (torchrun then stops the other ranks).
"""

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20  # replays a profiler window, an enqueue window and a timing median


def fail(msg: str):
    raise SystemExit(f"multicard_torch: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def helpers():
    """This checkout's utils/timing.py, loaded as a module of its own: its
    graph readers (`graph_kernels`, `graph_edges`, `exchange_order`),
    `capture_graph` and `cuda_time_ms`, whatever tree --tree names."""
    spec = importlib.util.spec_from_file_location(
        "_multicard_timing", os.path.join(ROOT, "spmv_tpu_torch", "utils", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def ulp_apart(got, want, dtype) -> bool:
    """Every element within one ulp of `dtype` (float32, or bfloat16:
    2**16 float32 ulps of the same value)."""
    import torch

    a, b = got.float().cpu().numpy(), want.float().cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16
    return bool(np.all(np.abs(a - b) <= ulp))


def same_or_ulp(got, want, ulp_ok: bool, dtype, what: str) -> str:
    """got against want: bit for bit, or with `ulp_ok` within one ulp of
    `dtype` per element. Fails otherwise; returns how they agree."""
    import torch

    if torch.equal(got, want):
        return "bit for bit"
    check(ulp_ok, f"{what}: not bit for bit")
    check(ulp_apart(got, want, dtype), f"{what}: more than one ulp apart")
    return "within one ulp"


def ring_x(xv, sr):
    """x for the ring, as chip_smoke.py makes it: |x| for max-times (the
    ring of non-negative values), 30% zeros for or-and."""
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, OR_AND

    if sr is OR_AND:
        keep = np.random.default_rng(13).random(xv.size) >= 0.3
        return np.where(keep, xv, 0.0).astype(np.float32)
    if sr is MAX_TIMES:
        return np.abs(xv)
    return xv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout to import spmv_tpu_torch from (default: this one)")
    ap.add_argument("--order-only", action="store_true",
                    help="only distribute_csr halo plus-times on bench: print each rank's "
                         "graph order, hold no overlap")
    ap.add_argument("--json", default=None, help="write rank 0's results here")
    args = ap.parse_args()
    # keep CUPTI up between traces: torn down and set up again, later
    # traces lose device events once CUDA graphs exist
    os.environ["TEARDOWN_CUPTI"] = "0"
    H = helpers()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("no card: every rank needs one")
    from spmv_tpu_torch.examples.shortest_paths import random_graph
    from spmv_tpu_torch.formats import CSR
    from spmv_tpu_torch.io.generate import power_law_csr
    from spmv_tpu_torch.ops.reference import correctness_delta, spmv_ref, spmv_ref_semiring
    from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
    from spmv_tpu_torch.parallel import (distribute_csr, distribute_stream,
                                         init_distributed, make_mesh)

    world = init_distributed(backend="nccl")
    check(world >= 2, f"world size {world}: run it under torchrun with 2 or more ranks")
    rank = dist.get_rank()
    pg = make_mesh("shards", distributed=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    check(pg.device.type == "cuda" and dist.get_backend() == "nccl", f"mesh {pg}")
    where = os.path.abspath(sys.modules["spmv_tpu_torch"].__file__)
    check(where.startswith(os.path.abspath(args.tree)), f"imported {where}, not --tree")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(card)
    say(f"{world} ranks, NCCL, one card each; spmv_tpu_torch from {os.path.dirname(where)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")

    t0 = time.perf_counter()
    bench = power_law_csr(1 << 20, 1 << 20, 3_300_000, alpha=1.5, seed=42)
    mats = {"bench": bench}
    if not args.order_only:
        mats["sssp graph"] = random_graph(1 << 20, 4, seed=0)
        mats["bench bf16"] = CSR(bench.n_rows, bench.n_cols, bench.Ap, bench.Aj,
                                 torch.from_numpy(np.asarray(bench.Ax)).bfloat16())
    xs_np = {label: [np.random.default_rng(s).standard_normal(M.n_cols).astype(np.float32)
                     for s in (0, 1)] for label, M in mats.items()}
    rings = (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
    cases = [("bench", "csr", "halo", PLUS_TIMES)]
    if not args.order_only:
        cases = ([(label, "csr", mode, sr) for label in ("bench", "sssp graph")
                  for mode in ("halo", "allgather") for sr in rings]
                 + [("bench", "stream", None, sr) for sr in (PLUS_TIMES, MIN_PLUS)]
                 + [("bench bf16", "csr", "halo", PLUS_TIMES)])

    built, local = {}, {}
    local4 = make_mesh("shards", n_shards=world, device=dev, distributed=False)
    for label, impl, _, _ in cases:
        if (label, impl) in built:
            continue
        t = time.perf_counter()
        build = distribute_csr if impl == "csr" else distribute_stream
        built[label, impl] = build(mats[label], pg)
        if rank == 0 and not args.order_only:  # the local mesh the joined rows are held to
            local[label, impl] = build(mats[label], local4)
        torch.cuda.synchronize()
        say(f"{label}: {impl} over {world} ranks, host plan and upload "
            f"{time.perf_counter() - t:.3f} s (rank 0)")
    say(f"set-up {time.perf_counter() - t0:.1f} s")

    def gather_rows(D, y):
        """The ranks' owned rows joined in rank order, on rank 0 (None on
        the others)."""
        owned = [int(o) for o in D.plan.owned[:world]]
        pad = torch.zeros(max(owned), dtype=y.dtype, device=dev)
        pad[:y.shape[0]] = y
        parts = [torch.empty_like(pad) for _ in range(world)]
        dist.all_gather(parts, pad)
        return torch.cat([p[:o] for p, o in zip(parts, owned)]) if rank == 0 else None

    def oracle(label, xv, sr):
        M = mats[label]
        if label == "bench bf16":  # the values as rounded, summed in float64
            M = CSR(M.n_rows, M.n_cols, M.Ap, M.Aj, M.Ax.float().numpy())
        if sr is PLUS_TIMES:
            return spmv_ref(M, xv, y_dtype=np.float64)
        return spmv_ref_semiring(M, xv, sr)

    def gate(label, y, xv, sr):
        """PERF.md section 2's gate on the joined y."""
        want, y_np = oracle(label, xv, sr), y.float().cpu().numpy()
        if not np.isfinite(y_np[np.isfinite(want)]).all() or y_np.shape != want.shape:
            return False, "not finite or of the wrong shape"
        if label == "bench bf16":
            err = float(np.abs(y_np - want).max() / max(1.0, np.abs(want).max()))
            return err < 0.08, f"bf16: max |y - oracle| / max(1, max|oracle|) {err:.3e} < 0.08"
        if sr is PLUS_TIMES:
            ok = np.allclose(y_np, want, rtol=2e-4, atol=1e-5)
            return ok, (f"within rtol 2e-4 atol 1e-5 of float64, max_rel "
                        f"{correctness_delta(want, y_np)['max_rel']:.3e}")
        return bool(np.array_equal(y_np, want)), "equal to the semiring oracle bit for bit"

    def stems_of(D, impl, sr):
        if impl == "csr":
            return {"K11' local_ell": ("local_ell_kernel", 2)}
        npass = len(D.uni.split_meta)
        if sr is PLUS_TIMES:
            return {"K2 reduce": ("_Z13reduce_kernel", 1), "K5 split": ("_Z12split_kernel", npass),
                    "K6 scan": ("_Z16scan_diff_kernel", 1)}
        return {"K7 reduce_roll": ("_Z18reduce_roll_kernel", 1),
                "K5 split": ("_Z12split_kernel", npass),
                "K8 scan_roll": ("_Z16scan_roll_kernel", 1)}

    def exchange_bytes(D, mode, dtype):
        """The bytes a shard sends: its halo payload (world x M values),
        or its whole x block (world x B values) in allgather mode."""
        per = D.plan.B if mode == "allgather" else D.plan.M
        return world * per * torch.empty((), dtype=dtype).element_size()

    def busy_ms(run):
        """Device busy ms a call of `run` (torch.profiler over CALLS calls)
        and NCCL's kernels' ms apart (`profile_stream.kernel_times`, which
        --order-only's older trees may lack)."""
        from spmv_tpu_torch.utils.profile_stream import kernel_times

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                run()
            torch.cuda.synchronize()
        rows, nccl = kernel_times(prof, CALLS)
        return sum(r[0] for r in rows) / 1e3, sum(r[0] for r in nccl) / 1e3

    results = []
    for label, impl, mode, sr in cases:
        D = built[label, impl]
        what = f"{label}, distribute_{impl}{'' if mode is None else ', ' + mode}, {sr.name}"
        kw = {} if mode is None else {"mode": mode}
        dtype = torch.bfloat16 if label == "bench bf16" else torch.float32
        x1_np, x2_np = (ring_x(v, sr) for v in xs_np[label])
        x1, x2 = (torch.from_numpy(v).to(dev).to(dtype) for v in (x1_np, x2_np))
        t = time.perf_counter()
        y1 = D.matvec(x1, semiring=sr, **kw)  # eager, then captured
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        graph = D.graphs[sr, mode, dtype, 1][0]
        r = {"case": what, "first_call_s": first_s}
        # the order of the graph: the exchange against the self block
        if mode == "halo":
            names, edges = H.graph_edges(graph)
            order = H.exchange_order(names, edges)
            r["order"] = order
            r["graph"] = f"{len(names)} nodes, {len(edges)} edges"
            if not args.order_only:
                check(order["exchange nodes"] >= 1 and order["self"] == "apart"
                      and order["fold"] == "apart" and order["halo"] == "downstream",
                      f"{what}, rank {rank}: the graph's order {order}")
        if args.order_only:
            results.append(r)
            continue
        # a replay with a new x against the eager body on that x
        y2 = D.matvec(x2, semiring=sr, **kw)
        ye = D._matvec_eager(x2, semiring=sr, **kw)
        torch.cuda.synchronize()
        r["replay_vs_eager"] = same_or_ulp(y2, ye, False, dtype,
                                           f"{what}, rank {rank}: replay against "
                                           f"_matvec_eager")
        nodes = H.graph_kernels(graph)
        launches = {}
        for name, (stem, want) in stems_of(D, impl, sr).items():
            launches[name] = sum(n for k, n in nodes.items() if stem in k)
            check(launches[name] == want, f"{what}, rank {rank}: {name} {launches[name]} "
                                          f"graph nodes, want {want}")
        launches["NCCL"] = sum(n for k, n in nodes.items() if "nccl" in k)
        check(launches["NCCL"] >= 1, f"{what}, rank {rank}: no NCCL node in the graph")
        r["launches"] = launches
        # the ranks' rows joined, against the local mesh and the oracle
        joined = gather_rows(D, y1)
        if rank == 0:
            yl = local[label, impl]._matvec_eager(x1, semiring=sr, **kw)
            check(joined.shape == yl.shape and joined.dtype == yl.dtype,
                  f"{what}: joined {tuple(joined.shape)} {joined.dtype}, local "
                  f"{tuple(yl.shape)} {yl.dtype}")
            r["joined_vs_local"] = same_or_ulp(joined, yl, sr is PLUS_TIMES, dtype,
                                               f"{what}: the joined ranks against the "
                                               f"{world}-shard local mesh")
            ok, how = gate(label, joined, x1.float().cpu().numpy(), sr)
            check(ok, f"{what}: outside the gate ({how})")
            r["gate"] = how
        dist.barrier()
        # times: replays, eager calls, the host's enqueue, the device's busy
        run = lambda: D.matvec(x1, semiring=sr, **kw)
        r["replay_ms"] = H.cuda_time_ms(run, iters=CALLS)["median_ms"]
        r["eager_ms"] = H.cuda_time_ms(lambda: D._matvec_eager(x1, semiring=sr, **kw),
                                       iters=10)["median_ms"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            run()
        r["enqueue_ms"] = (time.perf_counter() - t) / CALLS * 1e3
        torch.cuda.synchronize()
        r["busy_ms"], r["nccl_ms"] = busy_ms(run)
        r["exchange_bytes"] = exchange_bytes(D, mode, dtype)
        results.append(r)
        say(f"{what}: rank 0: replay {r['replay_vs_eager']} to _matvec_eager; joined rows "
            f"{r.get('joined_vs_local')} to the local mesh; {r.get('gate')}; launches "
            f"{launches} (graph nodes)"
            + (f"; order {r['order']}" if mode == "halo" else ""))

    # the exchange alone: a captured graph of just the collective
    if not args.order_only:
        for (label, impl), D in built.items():
            dtype = torch.bfloat16 if label == "bench bf16" else torch.float32
            for mode in (("halo", "allgather") if impl == "csr" else ("halo",)):
                if mode == "halo":
                    send = torch.zeros((1, world, D.plan.M), dtype=dtype, device=dev)
                    body = lambda: pg.start_all_to_all(send).wait()
                else:
                    xs = torch.zeros((1, D.plan.B), dtype=dtype, device=dev)
                    body = lambda: pg.start_all_gather(xs).wait()
                body()
                torch.cuda.synchronize()
                g = H.capture_graph(body, f"{label} {impl} {mode} exchange", dev)
                ms = H.cuda_time_ms(g.replay, iters=CALLS)["median_ms"]
                results.append({"case": f"{label}, distribute_{impl}, {mode} exchange alone",
                                 "exchange_alone_ms": ms,
                                 "launches": {"NCCL": sum(
                                     n for k, n in H.graph_kernels(g).items() if "nccl" in k)},
                                 "exchange_bytes": exchange_bytes(D, mode, dtype)})
                del g

    every = [None] * world
    dist.all_gather_object(every, results)
    if rank == 0:
        summary = []
        for i, r0 in enumerate(every[0]):
            line = {"case": r0["case"]}
            for key in ("replay_ms", "eager_ms", "enqueue_ms", "busy_ms", "nccl_ms",
                        "exchange_alone_ms", "exchange_bytes", "first_call_s"):
                if key in r0:
                    vals = [every[k][i][key] for k in range(world)]
                    slow = int(np.argmax(vals))
                    line[key] = {"rank0": vals[0], "median": statistics.median(vals),
                                 "slowest": vals[slow], "slowest_rank": slow}
            for key in ("order", "launches", "replay_vs_eager", "graph"):
                if key in r0:
                    line[key] = [every[k][i][key] for k in range(world)]
            for key in ("joined_vs_local", "gate"):
                if key in r0:
                    line[key] = r0[key]
            summary.append(line)
            fmt = lambda v: (f"{v['rank0']:.4f} / {v['median']:.4f} / {v['slowest']:.4f} "
                             f"(rank {v['slowest_rank']})")
            parts = [f"{k} {fmt(line[k])}" for k in ("replay_ms", "eager_ms", "enqueue_ms",
                                                      "busy_ms", "nccl_ms",
                                                      "exchange_alone_ms") if k in line]
            if "exchange_bytes" in line:
                parts.append(f"exchange {line['exchange_bytes']['rank0']} B a shard")
            if "order" in line:
                parts.append("order by rank: " + "; ".join(
                    f"self {o['self']}, fold {o['fold']}, halo {o['halo']}, "
                    f"{o['exchange nodes']} exchange node(s)" for o in line["order"]))
            print(f"== {line['case']}: " + "; ".join(parts) + f" ({card.splitlines()[0]})")
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
            with open(args.json, "w") as f:
                json.dump({"card": card, "world": world, "tree": os.path.dirname(where),
                           "cases": summary}, f, indent=1)
        print(f"multicard_torch: {'order read' if args.order_only else 'every check held'} "
              f"on {world} ranks in {time.perf_counter() - t0:.1f} s; times as rank 0 / "
              f"median over ranks / slowest rank, ms", flush=True)
    # every graph goes before the communicator: NCCL's destroy waits for the
    # graphs that hold its kernels, which hangs the exit (seen on four cards,
    # with graphs cached on the built matrices, and with the last case's
    # graph still bound here)
    built.clear()
    local.clear()
    D = graph = run = None
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
