"""The multi-device layer's seam: the port's partition, halo plan,
stacked ELL blocks and uniform stream plans equal the reference's bit
for bit, K11''s plain version matches the reference's per-shard ELL
matvec (Pallas in interpret mode), and `distribute_csr` and
`distribute_stream` on a local mesh match the reference's on the
conftest's 8-device CPU mesh and the oracle.

Counterparts of every test in tests/test_parallel.py, on the same
matrices and seeds. Tolerances: plus-times rtol 2e-5 / atol 1e-5 of
the float64 oracle (test_parallel.py:27), rtol 2e-4 / atol 1e-4 for the
stream pipeline (test_parallel.py:200); min, max and or rings bit for
bit, against the reference and the semiring oracle."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spmv_tpu import spmv_ref
from spmv_tpu.formats import COO as JCOO, coo_to_csr as jcoo_to_csr
from spmv_tpu.io.generate import banded_csr, power_law_csr, random_csr
from spmv_tpu.kernels.stream import StreamPolicy as JStreamPolicy
from spmv_tpu.ops import semiring as jsr
from spmv_tpu.ops.reference import spmv_ref_semiring
from spmv_tpu.parallel import dist_spmv as jds
from spmv_tpu.parallel import dist_stream as jdst
from spmv_tpu.parallel import partition as jpart
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.kernels.stream import StreamPolicy
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.parallel import (distribute_csr, distribute_stream,
                                     init_distributed, make_mesh, put_global)
from spmv_tpu_torch.parallel import dist_spmv as tds
from spmv_tpu_torch.parallel import dist_stream as tdst
from spmv_tpu_torch.parallel import partition as tpart

torch.set_num_threads(1)

RINGS = {"plus_times": (jsr.PLUS_TIMES, tsr.PLUS_TIMES),
         "min_plus": (jsr.MIN_PLUS, tsr.MIN_PLUS),
         "max_times": (jsr.MAX_TIMES, tsr.MAX_TIMES),
         "or_and": (jsr.OR_AND, tsr.OR_AND)}


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj),
               np.asarray(A.Ax))


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("shards",))


def _tmesh(n):
    return make_mesh("shards", n_shards=n, device="cpu")


def _eq(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _hub_matrix():
    """test_parallel.py:129: a 6000-entry hub row (row 37) over 1024 rows,
    split across shards by the exact-nnz balance."""
    rng = np.random.default_rng(3)
    n = 1024
    rows = np.concatenate([np.full(6000, 37), rng.integers(0, n, 4000)])
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = jcoo_to_csr(JCOO(n, n, rows, cols, vals))
    return A, rng.standard_normal(n).astype(np.float32)


def _abs_csr(A):
    return jcoo_to_csr(JCOO(A.n_rows, A.n_cols, A.row_ids(), np.asarray(A.Aj),
                            np.abs(np.asarray(A.Ax)).astype(np.float32)))


def _ring_x(x, ring):
    if ring == "or_and":
        return (np.abs(x) > 0.7).astype(np.float32)
    if ring in ("min_plus", "max_times"):
        return np.abs(x)
    return x


def _ring_A(A, ring):
    if ring == "or_and":
        return jcoo_to_csr(JCOO(A.n_rows, A.n_cols, A.row_ids(), np.asarray(A.Aj),
                                (np.abs(np.asarray(A.Ax)) > 0.5).astype(np.float32)))
    if ring in ("min_plus", "max_times"):
        return _abs_csr(A)
    return A


MATRICES = {
    "power_law": lambda: power_law_csr(500, 500, 6000, seed=3),
    "rect": lambda: random_csr(300, 170, 2500, seed=5),
    "hub": lambda: _hub_matrix()[0],
    "tiny": lambda: banded_csr(5, 1),
    "banded": lambda: banded_csr(4096, bandwidth=2, seed=9),
}


# ---------------------------------------------------------------------------
# host plans: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("balance", ["merge", "rows"])
def test_partition_rows_matches_reference(balance, n):
    A = power_law_csr(1000, 1000, 20000, seed=7)
    pj = jpart.partition_rows(A, n, balance=balance)
    pt = tpart.partition_rows(_port(A), n, balance=balance)
    for f in ("n_shards", "rows_per_shard", "nnz_per_shard"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("row_starts", "Ap", "Aj", "Ax", "halo_counts"):
        _eq(getattr(pj, f), getattr(pt, f), f)
    # test_parallel.py:51 (merge balance) and :75 (weak-scaling structure)
    Ap = np.asarray(A.Ap, np.int64)
    items = (Ap[pt.row_starts[1:]] - Ap[pt.row_starts[:-1]]
             + pt.row_starts[1:] - pt.row_starts[:-1])
    if balance == "merge":
        assert items.max() <= items.mean() + A.row_lengths().max() + 1
    R = random_csr(800, 800, 16000, seed=8)
    assert (tpart.partition_rows(_port(R), 4).nnz_per_shard
            <= tpart.partition_rows(_port(R), 2).nnz_per_shard)


HALO_INTS = ("n_shards", "B", "M", "R", "R_out", "N_self", "N_halo",
             "comm_bytes_per_shard", "allgather_bytes_per_shard")
HALO_ARRAYS = ("row_starts", "idx_own", "export_flag", "export_rows",
               "send_idx", "rows_self", "cols_self", "vals_self", "rows_halo",
               "cols_halo", "vals_halo", "halo_counts")


def assert_same_halo(pj, pt):
    for f in HALO_INTS:
        assert getattr(pj, f) == getattr(pt, f), f
    for f in HALO_ARRAYS:
        _eq(getattr(pj, f), getattr(pt, f), f)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("balance", ["nnz", "merge", "rows"])
@pytest.mark.parametrize("matrix", ["power_law", "hub", "rect", "tiny"])
def test_build_halo_plan_matches_reference(matrix, balance, n):
    A = MATRICES[matrix]()
    assert_same_halo(jpart.build_halo_plan(A, n, balance=balance),
                     tpart.build_halo_plan(_port(A), n, balance=balance))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("matrix", ["power_law", "hub"])
def test_stacked_ell_blocks_match_reference(matrix, n):
    A = MATRICES[matrix]()
    plan = tpart.build_halo_plan(_port(A), n)
    for blk in ("self", "halo"):
        rows, cols, vals = (getattr(plan, f"{k}_{blk}") for k in ("rows", "cols", "vals"))
        W = tds._block_width(rows, plan.R)
        assert W == jds._block_width(rows, plan.R), blk
        bj = jds._block_ell_plans(rows, cols, vals, plan.R, W)
        bt = tds._block_ell_plans(rows, cols, vals, plan.R, W)
        for k in ("Tv", "V", "W"):
            assert bj[k] == bt[k], (blk, k)
        for k in ("aj", "ax", "valid", "vrow"):
            _eq(bj[k], bt[k], f"{blk}.{k}")


UNI_INTS = ("n", "pad_tiles", "x_rows_pad", "n_aug", "F_pad", "Qp", "out_rows",
            "n_y_rows")


def _extras_matrix():
    """test_parallel.py:238: a hot 128-row block in many final tiles at
    kappa 256, so some shard carries merge fixups of depth 2 or more."""
    rng = np.random.default_rng(11)
    n = 4096
    rows = np.concatenate([rng.integers(256, 384, 6000), rng.integers(0, 512, 12000)])
    cols = np.concatenate([rng.integers(0, 8, 6000), rng.integers(8, 16, 12000)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return jcoo_to_csr(JCOO(n, n, rows, cols, vals)), rng


@pytest.mark.parametrize("case", ["power_law_2", "power_law_4", "extras_2"])
def test_uniform_plans_match_reference(case):
    if case == "extras_2":
        A, kappa, n = _extras_matrix()[0], 256, 2
    else:
        A, kappa, n = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7), 12288, int(case[-1])
    plan = tpart.build_halo_plan(_port(A), n)
    uj = jdst.build_uniform_plans(A, jpart.build_halo_plan(A, n),
                                  policy=JStreamPolicy(kappa=kappa))
    ut = tdst.build_uniform_plans(_port(A), plan, policy=StreamPolicy(kappa=kappa))
    for f in UNI_INTS:
        assert getattr(uj, f) == getattr(ut, f), f
    assert uj.split_meta == ut.split_meta
    assert sorted(uj.dev) == sorted(ut.dev)
    for k in uj.dev:
        _eq(uj.dev[k], ut.dev[k], k)
    if case == "extras_2":
        assert ut.dev["fix_out"].shape[1] >= 2  # depth-2 extras really occur


# ---------------------------------------------------------------------------
# K11': the plain version against the reference's per-shard matvec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", list(RINGS))
def test_k11p_plain_matches_reference(ring):
    """The reference's _local_ell_matvec (Pallas `tree` group reduce in
    interpret mode) per shard, against the port's one stacked call, on
    the self and halo blocks of the hub matrix over 4 shards."""
    A, x = _hub_matrix()
    A = _ring_A(A, ring)
    jring, tring = RINGS[ring]
    plan = tpart.build_halo_plan(_port(A), 4)
    mesh = _tmesh(4)
    ident = float(jring.identity_for(np.float32))
    rng = np.random.default_rng(5)
    for blk in ("self", "halo"):
        rows, cols, vals = (getattr(plan, f"{k}_{blk}") for k in ("rows", "cols", "vals"))
        W = tds._block_width(rows, plan.R)
        b = tds._block_ell_plans(rows, cols, vals, plan.R, W)
        C = plan.B if blk == "self" else plan.n_shards * plan.M
        xsrc = _ring_x(rng.standard_normal((4, C)).astype(np.float32), ring)
        yt = tds._local_ell_matvec(tds._upload_block(b, mesh, plan.R),
                                   torch.from_numpy(xsrc), R=plan.R, sr=tring,
                                   identity=ident).numpy()
        for s in range(4):
            yj = np.asarray(jds._local_ell_matvec(
                jnp.asarray(b["aj"][s]), jnp.asarray(b["ax"][s]),
                jnp.asarray(b["valid"][s]), jnp.asarray(b["vrow"][s]),
                jnp.asarray(xsrc[s]), W=W, Tv=b["Tv"], V=b["V"], R=plan.R,
                sr=jring, identity=ident, interpret=True))
            if ring == "plus_times":
                np.testing.assert_allclose(yt[s], yj, rtol=1e-6, atol=1e-6)
            else:
                _eq(yt[s], yj, f"{blk} shard {s}")


def test_k11p_wrapper_checks_width():
    z = torch.zeros((1, 1, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tds._local_ell_pass(z, z.float(), z.bool(), torch.zeros(1, 4), W=3,
                            sr=tsr.PLUS_TIMES)


# ---------------------------------------------------------------------------
# distribute_csr on a local mesh against the reference and the oracle
# ---------------------------------------------------------------------------

def _check_dist(A, n, x, ring="plus_times", modes=("halo", "allgather"),
                balance="nnz"):
    jring, tring = RINGS[ring]
    A, x = _ring_A(A, ring), _ring_x(x, ring)
    dj = jds.distribute_csr(A, _jmesh(n), balance=balance)
    dt = distribute_csr(_port(A), _tmesh(n), balance=balance)
    if ring == "plus_times":
        ref = spmv_ref(A, x, np.float64)
    else:
        ref = spmv_ref_semiring(A, x, jring, y_dtype=np.float32)
    for mode in modes:
        yj = np.asarray(dj.matvec(x, semiring=jring, mode=mode))
        yt = dt.matvec(x, semiring=tring, mode=mode).numpy()
        assert yt.shape == (A.n_rows,) and yt.dtype == np.float32
        if ring == "plus_times":
            np.testing.assert_allclose(yt, ref, rtol=2e-5, atol=1e-5)
            np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=1e-5)
        else:
            _eq(yt, ref, f"{ring} {mode} oracle")
            _eq(yt, yj, f"{ring} {mode} reference")
    return dt


@pytest.mark.parametrize("n", [2, 4, 8])
def test_distributed_matches_reference_and_oracle(n):
    A = power_law_csr(500, 500, 6000, seed=3)
    _check_dist(A, n, np.random.default_rng(0).standard_normal(500).astype(np.float32))


def test_distributed_rectangular():
    A = random_csr(300, 170, 2500, seed=5)
    _check_dist(A, 4, np.random.default_rng(1).standard_normal(170).astype(np.float32))


@pytest.mark.parametrize("impl", ["csr", "stream"])
@pytest.mark.parametrize("off", [-1, 1])
def test_shard_x_requires_n_cols(impl, off):
    """x of any length but n_cols is refused, a short one too although
    it fits in the shards' padded blocks."""
    if impl == "csr":
        A, build = random_csr(300, 170, 2500, seed=5), distribute_csr
    else:
        A, build = power_law_csr(5000, 5000, 40000, seed=1), distribute_stream
    d = build(_port(A), _tmesh(4))
    assert d.x_pad >= A.n_cols
    with pytest.raises(ValueError, match=rf"expected \({A.n_cols},\)"):
        d.matvec(np.ones(A.n_cols + off, np.float32))


@pytest.mark.parametrize("ring", ["min_plus", "or_and", "max_times"])
def test_distributed_semiring(ring):
    A = random_csr(200, 200, 1500, seed=6)
    _check_dist(A, 4, np.random.default_rng(2).standard_normal(200).astype(np.float32),
                ring=ring)


def test_partition_empty_and_tiny():
    A = banded_csr(5, 1)
    assert tpart.partition_rows(_port(A), 8).row_starts[-1] == 5
    _check_dist(A, 8, np.ones(5, np.float32))


@pytest.mark.parametrize("ring", ["plus_times", "min_plus", "or_and"])
def test_nnz_split_hub_row(ring):
    """The hub row split across 8 shards is reassembled by the boundary
    fixup; per-shard padded nnz stays within a pad granule of nnz/8."""
    A, x = _hub_matrix()
    dt = _check_dist(A, 8, x, ring=ring)
    assert dt.plan.export_flag.sum() >= 4
    assert dt.plan.N_self + dt.plan.N_halo <= A.nnz // 8 + 2 * 128
    assert dt.fix is not None and dt.fix["pos"].numel() >= 1


def test_halo_exchange_volume_and_equivalence():
    A = banded_csr(4096, bandwidth=2, seed=9)
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    dt = _check_dist(A, 8, x)
    assert dt.comm_bytes_per_shard < dt.allgather_bytes_per_shard / 8
    np.testing.assert_allclose(dt.matvec(x, mode="halo").numpy(),
                               dt.matvec(x, mode="allgather").numpy(),
                               rtol=1e-6, atol=1e-6)


def test_halo_mode_uses_only_the_all_to_all():
    """test_parallel.py:98's counterpart: in halo mode with row-aligned
    cuts (no boundary exports) the only collective is one all-to-all;
    allgather mode gathers instead."""
    A = banded_csr(512, bandwidth=1, seed=10)
    dt = distribute_csr(_port(A), _tmesh(4), balance="merge")
    assert not dt.plan.export_flag.any()
    calls = []
    mesh = dt.mesh
    a2a, ag = mesh.all_to_all, mesh.all_gather
    mesh.all_to_all = lambda t: (calls.append("all_to_all"), a2a(t))[1]
    mesh.all_gather = lambda t: (calls.append("all_gather"), ag(t))[1]
    x = np.ones(512, np.float32)
    dt.matvec(x, mode="halo")
    assert calls == ["all_to_all"]
    calls.clear()
    dt.matvec(x, mode="allgather")
    assert calls == ["all_gather"]


def test_bootstrap_single_process():
    """init_distributed is a no-op without a process group configured;
    make_mesh builds a local mesh; put_global keeps the whole stack."""
    assert init_distributed() == 1
    assert init_distributed() == 1  # idempotent
    mesh = make_mesh("shards", n_shards=8, device="cpu")
    assert (mesh.n_shards, mesh.n_local, mesh.distributed) == (8, 8, False)
    a = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(put_global(a, mesh).numpy(), a)
    with pytest.raises(ValueError):
        put_global(a[:4], mesh)


def test_local_mesh_without_a_card_raises(monkeypatch):
    """With no `device`, a local mesh goes on the card; without one it
    raises and names device="cpu" instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh("shards", n_shards=2)
    assert make_mesh("shards", n_shards=2, device="cpu").device == torch.device("cpu")


def test_bootstrap_mesh_feeds_distribute():
    A = power_law_csr(400, 400, 4000, seed=8)
    x = np.random.default_rng(2).standard_normal(400).astype(np.float32)
    y = distribute_csr(_port(A), make_mesh("shards", n_shards=8, device="cpu")).matvec(x)
    np.testing.assert_allclose(y.numpy(), spmv_ref(A, x, np.float64),
                               rtol=2e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# distribute_stream on a local mesh against the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dist_stream_matches_reference_and_oracle(n):
    A = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7)
    x = np.random.default_rng(3).standard_normal(20000).astype(np.float32)
    Dt = distribute_stream(_port(A), _tmesh(n))
    assert Dt.plan.export_flag.any()  # hub rows cut across shards
    yt = Dt.matvec(x).numpy()
    np.testing.assert_allclose(yt, spmv_ref(A, x, np.float64), rtol=2e-4, atol=1e-4)
    yj = np.asarray(jdst.distribute_stream(A, _jmesh(n)).matvec(x))
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=1e-4)
    assert Dt.comm_bytes_per_shard <= n * Dt.plan.B * 4


def test_dist_stream_semiring_min_plus_and_or_and():
    A = _abs_csr(power_law_csr(5000, 5000, 40000, seed=1))
    x = np.abs(np.random.default_rng(2).standard_normal(5000)).astype(np.float32)
    Dt = distribute_stream(_port(A), _tmesh(4))
    yt = Dt.matvec(x, semiring=tsr.MIN_PLUS).numpy()
    _eq(yt, spmv_ref_semiring(A, x, jsr.MIN_PLUS, y_dtype=np.float32), "min_plus oracle")
    yj = np.asarray(jdst.distribute_stream(A, _jmesh(4)).matvec(x, semiring=jsr.MIN_PLUS))
    _eq(yt, yj, "min_plus reference")
    Ab = jcoo_to_csr(JCOO(5000, 5000, A.row_ids(), np.asarray(A.Aj),
                          (np.asarray(A.Ax) > 0.5).astype(np.float32)))
    xb = (x > 1.0).astype(np.float32)
    yb = distribute_stream(_port(Ab), _tmesh(4)).matvec(xb, semiring=tsr.OR_AND).numpy()
    _eq(yb, spmv_ref_semiring(Ab, xb, jsr.OR_AND, y_dtype=np.float32), "or_and oracle")


@pytest.mark.parametrize("l", [0, 1])
def test_dist_stream_reduce_inputs_are_the_matvecs(monkeypatch, l):
    """reduce_inputs(x, l) returns what matvec hands shard l's K2 call."""
    A = power_law_csr(5000, 5000, 40000, seed=1)
    x = np.random.default_rng(2).standard_normal(5000).astype(np.float32)
    Dt = distribute_stream(_port(A), _tmesh(2))
    seen, orig = [], tdst.st._reduce_pass
    monkeypatch.setattr(tdst.st, "_reduce_pass",
                        lambda *a, **k: seen.append(a) or orig(*a, **k))
    Dt.matvec(x)
    got = Dt.reduce_inputs(x, l)
    assert len(seen) == 2 and len(got) == len(seen[l]) == 8
    for a, b in zip(got, seen[l]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_dist_stream_multi_extras_depth():
    """Every extra contributor of a y block covered by 3+ final tiles
    lands (one scatter per depth)."""
    A, rng = _extras_matrix()
    Dt = distribute_stream(_port(A), _tmesh(2), policy=StreamPolicy(kappa=256))
    assert max(len(f) for f in Dt.merge_fix) >= 2
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    np.testing.assert_allclose(Dt.matvec(x).numpy(), spmv_ref(A, x, np.float64),
                               rtol=2e-4, atol=1e-4)


def test_weak_scaling_records_match_reference(capsys):
    """The port's weak-scaling bench on the CPU prints the reference's
    record keys (plus the device it ran on)."""
    from spmv_tpu.bench import weak_scaling as jws
    from spmv_tpu_torch.bench import weak_scaling as tws

    rj = jws.run(1, 512, 4096, 2, impl="ell")
    out = tws.main(["--device", "cpu", "--devices", "1", "2", "--rows-per-dev",
                    "512", "--nnz-per-dev", "4096", "--iters", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and [r["n_devices"] for r in out] == [1, 2]
    assert set(out[0]) == set(rj) | {"weak_scaling_efficiency", "device"}
    assert out[0]["nnz"] == rj["nnz"]
    assert out[0]["comm_bytes_per_shard"] == rj["comm_bytes_per_shard"]
