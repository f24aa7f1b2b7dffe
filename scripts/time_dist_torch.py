"""Time the port's multi-device layer across the cards of one host from one
checkout of the repo, so that two commits can be compared on the same
cards within one call.

    torchrun --standalone --nproc-per-node 4 scripts/time_dist_torch.py --tree DIR --label NAME

imports `spmv_tpu_torch` from DIR (the repo's root or an unpacked `git
archive` of another commit) and runs, in one process a rank:

1. before the process group exists, the one-card point of the
   weak-scaling bench on each rank's own card (`bench/weak_scaling.py`'s
   `run` with one shard on a local mesh), at its defaults (65536 rows and
   524288 nnz a card) with `--impl ell` and `--impl stream`, and at
   bench's size a card (1048576 rows, 3300000 nnz) with `--impl ell`;
2. in the NCCL group, `python -m spmv_tpu_torch.bench.weak_scaling
   --devices 1 2 4` at the same sizes and impls (under a process group
   only the point equal to the world size runs), through its `main`;
3. `python -m spmv_tpu_torch.utils.profile_stream --dist 4 --matrix
   bench`, `--dist-impl csr` and `--dist-impl stream`, through its
   `main`, which prints rank 0's report.

Rank 0 then prints one JSON line: the card's name and power limit, the
label, each point's records and its efficiency t(1) / t(world), t(1) the
median over the ranks' cards. Run parent, change, change, parent in one
call, each in its own torchrun. It imports no JAX.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

# (size, impl) points: the defaults (65536 rows, 524288 nnz a card) in both
# impls, bench's size a card (1048576 rows, 3300000 nnz) in `ell`, the
# four-chip cell's path (`distribute_csr`)
POINTS = {("defaults", "ell"): (1 << 16, 1 << 19), ("defaults", "stream"): (1 << 16, 1 << 19),
          ("bench a card", "ell"): (1 << 20, 3_300_000)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout to import spmv_tpu_torch from")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("time_dist_torch: needs a card on every rank")
    from spmv_tpu_torch.bench import weak_scaling
    from spmv_tpu_torch.parallel import init_distributed
    from spmv_tpu_torch.utils import profile_stream

    where = os.path.abspath(sys.modules["spmv_tpu_torch"].__file__)
    if not where.startswith(os.path.abspath(args.tree)):
        raise SystemExit(f"time_dist_torch: imported {where}, not --tree")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    one = {}
    for (size, impl), (rows, nnz) in POINTS.items():
        r = weak_scaling.run(1, rows, nnz, 20, impl=impl, device=dev)
        one[f"{size} {impl}"] = r["time_s"]

    world = init_distributed(backend="nccl")
    rank = dist.get_rank()
    every = [None] * world
    dist.all_gather_object(every, one)
    points = {}
    for (size, impl), (rows, nnz) in POINTS.items():
        out = weak_scaling.main(["--devices", "1", "2", "4", "--impl", impl,
                                 "--rows-per-dev", str(rows), "--nnz-per-dev", str(nnz),
                                 "--iters", "20"])
        key = f"{size} {impl}"
        t1 = [e[key] for e in every]
        points[key] = {"t1_s_by_rank": t1, "t1_s": statistics.median(t1), "records": out,
                       "efficiency": statistics.median(t1) / out[0]["time_s"]}
    for impl in ("csr", "stream"):
        sys.argv = ["profile_stream", "--dist", str(world), "--dist-impl", impl,
                    "--matrix", "bench"]
        profile_stream.main()
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
        print(json.dumps({"label": args.label, "tree": os.path.dirname(where),
                          "card": card, "world": world, "points": points}), flush=True)
    # every graph (cached on the matrices the runs made) goes before the
    # communicator: NCCL's destroy waits for the graphs that hold its kernels
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
