"""The process-group mesh on the CPU: gloo ranks spawned with
torch.multiprocessing, one shard per rank.

Each rank runs `distribute_csr` (halo mode) and `distribute_stream` on a
power-law matrix whose hub rows are cut across shards, and saves its
owned rows; put together, the ranks' rows must equal the local mesh's
y at the same shard count bit for bit (the same plain versions on the
same per-shard inputs), and the oracle within the stated tolerance. A
2-rank run does the same with bfloat16 and float16 values and x: the
exchange and the all-gather carry 2-byte values as they are (gloo takes
both dtypes). Another holds the rest of the layer's cases at 2 and 4
ranks: `distribute_csr`'s allgather mode, max-times and or-and in both
modes and through `distribute_stream`. Every exchange a rank runs is
the started one (`ShardMesh.start_all_to_all` / `start_all_gather`,
gloo's `async_op=True`), joined after the self block.

This module imports no JAX: the spawned ranks import it. The rendezvous
is a file under the test's tmp_path, so parallel test workers never
contend for a port."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.ops.reference import spmv_ref, spmv_ref_semiring
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
from spmv_tpu_torch.parallel import (distribute_csr, distribute_stream,
                                     init_distributed, make_mesh, put_global)

torch.set_num_threads(1)


def _case():
    """power_law_csr(20000, 20000, 150000, alpha 1.5, seed 7), the
    reference's dist-stream test matrix: its hub rows hold more than
    nnz/4 entries, so 2 and 4 shards split them."""
    A = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7)
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    return A, x


def _ys(A, x, mesh):
    """y of every path a rank checks: csr halo plus-times and min-plus,
    stream plus-times and min-plus."""
    xa = np.abs(x)
    dc = distribute_csr(A, mesh)
    ds = distribute_stream(A, mesh)
    return {"csr": dc.matvec(x).numpy(),
            "csr_min": dc.matvec(xa, semiring=MIN_PLUS).numpy(),
            "stream": ds.matvec(x).numpy(),
            "stream_min": ds.matvec(xa, semiring=MIN_PLUS).numpy()}


def _rank(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    assert init_distributed(init_method=f"file://{init_file}", world_size=world,
                            rank=rank, backend="gloo") == world
    assert init_distributed() == world  # idempotent once joined
    mesh = make_mesh("shards", device="cpu")
    assert (mesh.distributed, mesh.n_shards, mesh.rank, mesh.n_local) == \
        (True, world, rank, 1)
    stack = np.arange(world * 3, dtype=np.float32).reshape(world, 3)
    put = put_global(stack, mesh).numpy()
    A, x = _case()
    np.savez(f"{out_dir}/rank{rank}.npz", put=put, **_ys(A, x, mesh))
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_reproduce_local_mesh(world, tmp_path):
    mp.spawn(_rank, args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
             nprocs=world, join=True)
    A, x = _case()
    local = _ys(A, x, make_mesh("shards", n_shards=world, device="cpu"))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["put"], np.arange(3, dtype=np.float32)[None]
                                      + 3 * r)
    ref = spmv_ref(A, x, np.float64)
    ref_min = spmv_ref_semiring(A, np.abs(x), MIN_PLUS)
    for key, y_local in local.items():
        joined = np.concatenate([got[key] for got in ranks])
        assert joined.shape == (A.n_rows,)
        np.testing.assert_array_equal(joined, y_local, err_msg=key)
        if key.endswith("_min"):
            np.testing.assert_array_equal(joined, ref_min, err_msg=key)
        else:
            np.testing.assert_allclose(joined, ref, rtol=2e-4, atol=1e-4, err_msg=key)


def _ring_x(x, sr):
    """x for `sr`: |x| for max-times (the ring of non-negative values),
    about 30% zeros for or-and."""
    if sr is MAX_TIMES:
        return np.abs(x)
    if sr is OR_AND:
        return np.where(np.random.default_rng(5).random(x.size) < 0.3, 0.0, x
                        ).astype(np.float32)
    return x


# (impl, mode, ring) of the layer's cases that `_ys` leaves out
MORE_CASES = ([("csr", "allgather", sr) for sr in (PLUS_TIMES, MIN_PLUS)]
              + [("csr", mode, sr) for mode in ("halo", "allgather")
                 for sr in (MAX_TIMES, OR_AND)]
              + [("stream", None, sr) for sr in (MAX_TIMES, OR_AND)])


def _key(impl, mode, sr):
    return f"{impl}-{mode}-{sr.name}"


def _ys_more(A, x, mesh):
    """y of every case of MORE_CASES."""
    built = {"csr": distribute_csr(A, mesh), "stream": distribute_stream(A, mesh)}
    out = {}
    for impl, mode, sr in MORE_CASES:
        kw = {} if mode is None else {"mode": mode}
        out[_key(impl, mode, sr)] = built[impl].matvec(_ring_x(x, sr), semiring=sr,
                                                       **kw).numpy()
    return out


def _rank_more(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                     backend="gloo")
    A, x = _case()
    np.savez(f"{out_dir}/rank{rank}.npz", **_ys_more(A, x, make_mesh("shards",
                                                                        device="cpu")))
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_reproduce_local_mesh_every_ring_and_mode(world, tmp_path):
    """The ranks' rows joined equal the local mesh's y bit for bit in
    `distribute_csr`'s allgather mode, in max-times and or-and (both
    modes, and `distribute_stream`); max-times and or-and equal the
    semiring oracle, plus-times lies within the oracle's tolerance."""
    mp.spawn(_rank_more, args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
             nprocs=world, join=True)
    A, x = _case()
    local = _ys_more(A, x, make_mesh("shards", n_shards=world, device="cpu"))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for impl, mode, sr in MORE_CASES:
        key = _key(impl, mode, sr)
        joined = np.concatenate([got[key] for got in ranks])
        assert joined.shape == (A.n_rows,)
        np.testing.assert_array_equal(joined, local[key], err_msg=key)
        xv = _ring_x(x, sr)
        if sr is PLUS_TIMES:
            np.testing.assert_allclose(joined, spmv_ref(A, xv, np.float64), rtol=2e-4,
                                       atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(joined, spmv_ref_semiring(A, xv, sr),
                                          err_msg=key)


def _ys16(mesh):
    """y of the 2-byte paths, as int16 bits: bf16 A and x through
    distribute_csr (halo and allgather) and distribute_stream, f16 A and
    x (multiples of 1/2) through distribute_csr, bf16 A with a float32 x
    (float32 y) through distribute_csr."""
    A, x = _case()
    half = lambda v: np.clip(np.round(v * 2), -2, 2) / 2
    Ab, Ah = (type(A)(A.n_rows, A.n_cols, A.Ap, A.Aj,
                      torch.from_numpy(f(np.asarray(A.Ax))).to(dt))
              for f, dt in ((lambda v: v, torch.bfloat16), (half, torch.float16)))
    xb = torch.from_numpy(x).bfloat16()
    xh = torch.from_numpy(half(x).astype(np.float32)).half()
    dcb = distribute_csr(Ab, mesh)
    out = {"csr_bf16": dcb.matvec(xb), "csr_bf16_ag": dcb.matvec(xb, mode="allgather"),
           "stream_bf16": distribute_stream(Ab, mesh).matvec(xb),
           "csr_f16": distribute_csr(Ah, mesh).matvec(xh),
           "csr_bf16_f32": dcb.matvec(x)}
    return {k: v.contiguous().view(torch.int16 if v.element_size() == 2 else torch.int32)
            .numpy() for k, v in out.items()}


def _rank16(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                     backend="gloo")
    np.savez(f"{out_dir}/rank{rank}.npz", **_ys16(make_mesh("shards", device="cpu")))
    dist.destroy_process_group()


def test_gloo_ranks_exchange_16_bit_values(tmp_path):
    """2 gloo ranks with bf16 and f16 values: the ranks' rows joined equal
    the local mesh's y bit for bit, in the local mesh's dtype."""
    mp.spawn(_rank16, args=(2, str(tmp_path / "rendezvous"), str(tmp_path)),
             nprocs=2, join=True)
    local = _ys16(make_mesh("shards", n_shards=2, device="cpu"))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key, y_local in local.items():
        joined = np.concatenate([got[key] for got in ranks])
        assert joined.dtype == (np.int32 if key == "csr_bf16_f32" else np.int16), key
        np.testing.assert_array_equal(joined, y_local, err_msg=key)


def test_local_mesh_put_global_and_init():
    assert init_distributed() == 1
    assert init_distributed() == 1
    mesh = make_mesh("shards", n_shards=3, device="cpu")
    assert not mesh.distributed and mesh.n_local == 3
    stack = np.arange(9, dtype=np.int32).reshape(3, 3)
    np.testing.assert_array_equal(put_global(stack, mesh).numpy(), stack)
    with pytest.raises(RuntimeError):
        make_mesh("shards", distributed=True)  # no process group here


def test_weak_scaling_cpu_run(capsys):
    """`python -m spmv_tpu_torch.bench.weak_scaling --device cpu ...` at
    a tiny size: one record per shard count, with the reference's keys
    (spmv_tpu/bench/weak_scaling.py:71-78, :113) and the device."""
    import json

    from spmv_tpu_torch.bench import weak_scaling

    out = weak_scaling.main(["--device", "cpu", "--devices", "1", "2",
                             "--rows-per-dev", "512", "--nnz-per-dev", "4096",
                             "--iters", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert [r["n_devices"] for r in out] == [1, 2]
    for r in out:
        assert set(r) == {"n_devices", "nnz", "time_s", "gnnz_per_s",
                          "comm_bytes_per_shard", "allgather_bytes_per_shard",
                          "weak_scaling_efficiency", "device"}
        assert r["device"] == "cpu" and r["time_s"] > 0
    assert out[0]["weak_scaling_efficiency"] == 1.0
    assert out[1]["nnz"] == 2 * out[0]["nnz"]
