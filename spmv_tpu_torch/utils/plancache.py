"""Disk cache for stream plans, in the reference's v11 file format.

Counterpart of `spmv_tpu/utils/plancache.py`. A `StreamPlan` round-trips
through one uncompressed `.npz` (arrays) with a small JSON header
(scalars). The format is the reference's, so a plan that
`spmv_tpu.utils.plancache.save_plan` wrote loads here, and the reverse.
The plan is a pure function of (CSR, policy); the key hashes Ap, Aj and
Ax (the plan stores the routed Ax payload) and the structural policy
fields. Plans load as NumPy; `StreamPlan.to(device)` uploads.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

from spmv_tpu_torch.formats import CSR

_FORMAT_VERSION = 11  # v11: variable-span x windows + balanced
# column->sublane lane remap (gather xr1/xr2/xr3, g0, x_nat_rows)


def plan_key(A: CSR, policy) -> str:
    h = hashlib.sha256()
    h.update(np.int64([A.n_rows, A.n_cols, A.nnz]).tobytes())
    h.update(np.ascontiguousarray(np.asarray(A.Ap)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(A.Aj)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(A.Ax)).tobytes())
    fields = (policy.structural_fields()
              if hasattr(policy, "structural_fields") else vars(policy))
    h.update(repr(sorted(fields.items())).encode())
    return h.hexdigest()[:24]


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def _to_host(tree, prefix, arrays, scalars):
    """Flatten a {str: array-or-scalar} dict into npz entries."""
    for k, v in tree.items():
        name = f"{prefix}.{k}"
        if isinstance(v, (bool, int, float, str)):
            scalars[name] = v
        else:
            arrays[name] = _host(v)


def save_plan(plan, path: str) -> None:
    """Serialize a StreamPlan (host or device arrays)."""
    arrays: dict = {}
    scalars: dict = {
        "version": _FORMAT_VERSION,
        "n_gather_tiles": plan.n_gather_tiles,
        "n_final_tiles": plan.n_final_tiles,
        "layers": plan.layers,
        "x_rows_pad": plan.x_rows_pad,
        "n_y_blocks": plan.n_y_blocks,
        "sh.in_rows": plan.shuffle.in_rows,
        "sh.out_rows": plan.shuffle.out_rows,
        "sh.n_passes": len(plan.shuffle.passes),
    }
    arrays["hot_cols"] = _host(plan.hot_cols)
    arrays["sh.slot_of_dst"] = np.asarray(plan.shuffle.slot_of_dst)
    _to_host(plan.gather, "gather", arrays, scalars)
    _to_host(plan.scan, "scan", arrays, scalars)
    if plan.reduce is not None:
        _to_host(plan.reduce, "reduce", arrays, scalars)
    for i, p in enumerate(plan.shuffle.passes):
        pre = f"sh.p{i}"
        for f in ("n_steps", "sbt", "K", "Q", "in_rows", "out_rows"):
            scalars[f"{pre}.{f}"] = getattr(p, f)
        scalars[f"{pre}.stitch"] = str(p.stitch)
        for f in ("s1", "s2", "s3", "starts", "pos"):
            arrays[f"{pre}.{f}"] = np.asarray(getattr(p, f))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, __header__=np.frombuffer(
            json.dumps(scalars).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def load_plan(path: str):
    """Load a StreamPlan saved by either package's save_plan (NumPy)."""
    from spmv_tpu_torch.kernels.shuffle import (
        ShufflePlan,
        SplitPass,
        shuffle_device_arrays,
    )
    from spmv_tpu_torch.kernels.stream import StreamPlan

    z = np.load(path)
    scalars = json.loads(bytes(z["__header__"]).decode())
    if scalars.get("version") != _FORMAT_VERSION:
        raise ValueError(
            f"plan file {path}: version {scalars.get('version')} != "
            f"{_FORMAT_VERSION}")

    passes = []
    for i in range(scalars["sh.n_passes"]):
        pre = f"sh.p{i}"
        passes.append(SplitPass(
            n_steps=scalars[f"{pre}.n_steps"], sbt=scalars[f"{pre}.sbt"],
            K=scalars[f"{pre}.K"], Q=scalars[f"{pre}.Q"],
            in_rows=scalars[f"{pre}.in_rows"],
            out_rows=scalars[f"{pre}.out_rows"],
            stitch=scalars[f"{pre}.stitch"],
            s1=z[f"{pre}.s1"], s2=z[f"{pre}.s2"], s3=z[f"{pre}.s3"],
            starts=z[f"{pre}.starts"], pos=z[f"{pre}.pos"]))
    plan_sh = ShufflePlan(passes=passes, in_rows=scalars["sh.in_rows"],
                          out_rows=scalars["sh.out_rows"],
                          slot_of_dst=z["sh.slot_of_dst"])

    groups: dict = {"gather": {}, "scan": {}, "reduce": {}}
    for k in z.files:
        g, _, name = k.partition(".")
        if g in groups:
            groups[g][name] = z[k]
    for k, v in scalars.items():
        g, _, name = k.partition(".")
        if g in groups:
            groups[g][name] = v
    if "xr1" in groups["gather"] and not (
            "g0" in groups["gather"] and "x_nat_rows" in groups["gather"]):
        raise ValueError(
            f"plan file {path}: remap layout missing g0/x_nat_rows")

    return StreamPlan(
        n_gather_tiles=scalars["n_gather_tiles"],
        n_final_tiles=scalars["n_final_tiles"],
        layers=scalars["layers"],
        x_rows_pad=scalars["x_rows_pad"],
        hot_cols=z["hot_cols"],
        gather=groups["gather"],
        shuffle=plan_sh,
        shuffle_dev=shuffle_device_arrays(plan_sh),
        scan=groups["scan"],
        n_y_blocks=scalars["n_y_blocks"],
        reduce=groups["reduce"] or None,
    )


def stream_plan_cached(A: CSR, policy, cache_dir: str):
    """Fetch-or-build-or-load: `<cache_dir>/stream-<key>.npz`; on a miss
    the plan is built and saved before it is returned."""
    from spmv_tpu_torch.kernels.stream import build_stream_plan

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"stream-{plan_key(A, policy)}.npz")
    if os.path.exists(path):
        try:
            return load_plan(path)
        except ValueError as e:  # stale format version: rebuild in place
            print(f"plan cache {path}: {e}; rebuilding", file=sys.stderr)
    plan = build_stream_plan(A, policy)
    save_plan(plan, path)
    return plan
