"""The order of `DistributedSpMV._matvec_eager`, on the CPU: the reference's
(spmv_tpu/parallel/dist_spmv.py:233-248: the exchange, then y_self, then
y_halo), so that the exchange overlaps the self block.

Spies on `ShardMesh.start_all_to_all` / `start_all_gather` (and the
handles they return) and on K11''s wrapper `_local_ell_pass` record the
order of one matvec: the collective starts before the self block's K11'
pass, is joined after it, and the halo block's pass comes after the join,
in both modes, on a local CPU mesh and on 2 and 4 gloo ranks (spawned
with torch.multiprocessing, a file rendezvous under tmp_path). Moving
the collective moves no arithmetic: y is bit for bit the y of the
parent's order, the body below (`_parent_matvec_eager`) kept as the
yardstick, and matches the reference's `distribute_csr(...).matvec` on
the conftest's 8-device CPU mesh within test_torch_parallel.py's
tolerances (plus-times rtol 2e-5 / atol 1e-5, the other rings bit for
bit).

The topology the order gives a graph on the card is read by
`utils/timing.py:exchange_order`, held here on made graphs.

The spawned ranks import this module, so JAX is imported only inside the
test that compares with the reference."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
from spmv_tpu_torch.parallel import distribute_csr, init_distributed, make_mesh
from spmv_tpu_torch.parallel import dist_spmv as tds
from spmv_tpu_torch.parallel.bootstrap import ShardMesh
from spmv_tpu_torch.utils.timing import exchange_order

torch.set_num_threads(1)

RINGS = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS, "max_times": MAX_TIMES,
         "or_and": OR_AND}
MODES = ("halo", "allgather")


def _case(ring):
    """power_law_csr(4000, 4000, 30000, alpha 1.5, seed 7), whose hub rows
    are cut across 2 and 4 shards (so `_finish` runs its all-gather
    too), and x, both made for `ring` as test_torch_parallel.py makes
    them: 0/1 values for or-and, |A| and |x| for min-plus and
    max-times."""
    A = power_law_csr(4000, 4000, 30000, alpha=1.5, seed=7)
    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    Ax = np.asarray(A.Ax)
    if ring == "or_and":
        Ax, x = (np.abs(Ax) > 0.5).astype(np.float32), (np.abs(x) > 0.7).astype(np.float32)
    elif ring in ("min_plus", "max_times"):
        Ax, x = np.abs(Ax), np.abs(x)
    return type(A)(A.n_rows, A.n_cols, A.Ap, A.Aj, Ax), x


def _parent_matvec_eager(D, x, sr, mode):
    """The parent's `_matvec_eager`: the self block first, then the table
    (its collective run to its end), then the halo block."""
    xs = D._sharded(x)
    d, R = D.dev, D.plan.R
    identity = float(sr.identity_for(xs.dtype))
    y_self = tds._local_ell_matvec(d["self"], xs, R=R, sr=sr, identity=identity,
                                   ax=D._values("self", xs.dtype))
    y_halo = tds._local_ell_matvec(d["halo"], D.x_table(xs, mode), R=R, sr=sr,
                                   identity=identity, ax=D._values("halo", xs.dtype))
    y = sr.reduce(y_self, y_halo)
    y_own = torch.where(d["own_live"], torch.gather(y, 1, d["own_idx"]), identity)
    return D._finish(y_own, y[:, 0], sr, identity)


def _spied_matvec(D, x, sr, mode):
    """D.matvec(x) with the collectives' starts and joins and the K11'
    passes recorded -> (y, events)."""
    events = []
    starts = {name: getattr(ShardMesh, name)
              for name in ("start_all_to_all", "start_all_gather")}
    k11p = tds._local_ell_pass

    def spy_start(name):
        def start(mesh, t):
            events.append(name)
            started = starts[name](mesh, t)
            wait = started.wait
            started.wait = lambda: (events.append("wait"), wait())[1]
            return started
        return start

    def spy_k11p(aj, *args, **kw):
        events.append("K11' self" if aj is D.dev["self"]["aj"] else "K11' halo")
        return k11p(aj, *args, **kw)

    try:
        for name in starts:
            setattr(ShardMesh, name, spy_start(name))
        tds._local_ell_pass = spy_k11p
        y = D.matvec(x, semiring=sr, mode=mode)
    finally:
        for name, fn in starts.items():
            setattr(ShardMesh, name, fn)
        tds._local_ell_pass = k11p
    return y, events


def _want_events(mode):
    """The reference's order: start, the self block, the join, the halo
    block (`_finish`'s all-gather, where it runs, comes after)."""
    start = "start_all_gather" if mode == "allgather" else "start_all_to_all"
    return [start, "K11' self", "wait", "K11' halo"]


def _run_all(mesh):
    """{(ring, mode): (y, y of the parent's order, events)} on `mesh`."""
    out = {}
    for ring, sr in RINGS.items():
        A, x = _case(ring)
        D = distribute_csr(A, mesh)
        xv = torch.from_numpy(x)
        for mode in MODES:
            y, events = _spied_matvec(D, xv, sr, mode)
            out[ring, mode] = (y, _parent_matvec_eager(D, xv, sr, mode), events)
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_mesh_starts_the_exchange_before_the_self_block(n):
    for (ring, mode), (y, y_parent, events) in _run_all(
            make_mesh("shards", n_shards=n, device="cpu")).items():
        assert events == _want_events(mode), (ring, mode, events)
        assert y.shape == (4000,)
        assert torch.equal(y, y_parent), (ring, mode)


def _rank(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    init_distributed(init_method=f"file://{init_file}", world_size=world, rank=rank,
                     backend="gloo")
    out = {}
    for (ring, mode), (y, y_parent, events) in _run_all(
            make_mesh("shards", device="cpu")).items():
        out[f"{ring}-{mode}"] = y.numpy()
        out[f"{ring}-{mode}-parent"] = y_parent.numpy()
        out[f"{ring}-{mode}-events"] = np.array(events)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_start_the_exchange_before_the_self_block(world, tmp_path):
    """Each rank's matvec starts its collective before its self block and
    joins it before its halo block (the split-row all-gather after it);
    its rows equal the parent order's bit for bit, and the ranks' rows
    joined equal the local mesh's."""
    mp.spawn(_rank, args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
             nprocs=world, join=True)
    local = _run_all(make_mesh("shards", n_shards=world, device="cpu"))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for (ring, mode), (y_local, _, _) in local.items():
        key = f"{ring}-{mode}"
        for got in ranks:
            events = list(got[f"{key}-events"])
            assert events[:4] == _want_events(mode), (key, events)
            assert events[4:] == ["start_all_gather", "wait"], (key, events)
            np.testing.assert_array_equal(got[key], got[f"{key}-parent"], err_msg=key)
        joined = np.concatenate([got[key] for got in ranks])
        np.testing.assert_array_equal(joined, y_local.numpy(), err_msg=key)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_reordered_matvec_matches_the_reference(ring):
    """The port's 8-shard local mesh against the reference's
    `distribute_csr(...).matvec` on the conftest's 8-device CPU mesh, both
    modes."""
    import jax
    from jax.sharding import Mesh

    from spmv_tpu import spmv_ref
    from spmv_tpu.formats import CSR as JCSR
    from spmv_tpu.ops import semiring as jsr
    from spmv_tpu.ops.reference import spmv_ref_semiring
    from spmv_tpu.parallel import dist_spmv as jds

    A, xv = _case(ring)
    JA = JCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))
    jring = getattr(jsr, ring.upper())
    dj = jds.distribute_csr(JA, Mesh(np.array(jax.devices()[:8]), ("shards",)))
    dt = distribute_csr(A, make_mesh("shards", n_shards=8, device="cpu"))
    for mode in MODES:
        yj = np.asarray(dj.matvec(xv, semiring=jring, mode=mode))
        y, events = _spied_matvec(dt, torch.from_numpy(xv), RINGS[ring], mode)
        assert events == _want_events(mode)
        yt = y.numpy()
        if ring == "plus_times":
            np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=1e-5)
            np.testing.assert_allclose(yt, spmv_ref(JA, xv, np.float64), rtol=2e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(yt, yj)
            np.testing.assert_array_equal(yt, spmv_ref_semiring(JA, xv, jring,
                                                                y_dtype=np.float32))


# ---------------------------------------------------------------------------
# exchange_order on made graphs: nodes named as a capture names them
# ---------------------------------------------------------------------------

# a matvec's nodes: 0 the send gather, 1 the exchange (NCCL), 2 the self
# K11', 3 its fold, 4 the halo K11', 5 its fold, 6 the split-row
# all-gather (NCCL)
NAMES = ["gather_kernel", "ncclDevKernel_SendRecv", "_Z16local_ell_kernelPKi",
         "index_add_kernel", "_Z16local_ell_kernelPKi", "index_add_kernel",
         "ncclDevKernel_AllGather_RING_LL"]
# the reference's order: the exchange forks off beside the self block
OVERLAPPED = [(0, 1), (0, 2), (2, 3), (3, 4), (1, 4), (4, 5), (5, 6)]
# the parent's: the self block, then the gather and the exchange
SERIAL = [(2, 3), (3, 0), (0, 1), (1, 4), (4, 5), (5, 6)]


@pytest.mark.parametrize("edges,want", [
    (OVERLAPPED, {"self": "apart", "fold": "apart", "halo": "downstream",
                  "exchange nodes": 1}),
    (SERIAL, {"self": "upstream", "fold": "upstream", "halo": "downstream",
              "exchange nodes": 1}),
    # the self block behind the exchange: no node is the exchange's
    ([(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)],
     {"self": "no exchange node", "fold": "no exchange node",
      "halo": "no exchange node", "exchange nodes": 0}),
])
def test_exchange_order_reads_where_the_self_block_lies(edges, want):
    assert exchange_order(NAMES, edges) == want
    # the nodes listed in another order: the same answer
    perm = [6, 4, 0, 2, 5, 1, 3]
    where = {old: new for new, old in enumerate(perm)}
    assert exchange_order([NAMES[i] for i in perm],
                          [(where[i], where[j]) for i, j in edges]) == want


def test_exchange_order_at_world_size_1_and_without_an_exchange_node():
    """At world size 1 NCCL's exchange is a copy: a "memcpy" node, told
    from the copy that pads x (node 7, upstream of both blocks) by lying
    upstream of the halo block's K11' only."""
    names = [n.replace("ncclDevKernel_SendRecv", "memcpy") for n in NAMES] + ["memcpy"]
    edges = [(7, 0), (7, 2)]
    assert exchange_order(names, OVERLAPPED + edges, exchange="memcpy") == {
        "self": "apart", "fold": "apart", "halo": "downstream", "exchange nodes": 1}
    assert exchange_order(names, SERIAL + edges, exchange="memcpy") == {
        "self": "upstream", "fold": "upstream", "halo": "downstream", "exchange nodes": 1}
    assert exchange_order(names, OVERLAPPED + edges) == {
        "self": "no exchange node", "fold": "no exchange node",
        "halo": "no exchange node", "exchange nodes": 0}


def test_exchange_order_refuses_a_graph_without_two_linked_k11p_nodes():
    with pytest.raises(ValueError, match="want 2"):
        exchange_order(NAMES[:3], [(0, 1), (0, 2)])
    with pytest.raises(ValueError, match="no path between the two K11'"):
        exchange_order(NAMES, [(0, 1), (0, 2), (1, 4)])
