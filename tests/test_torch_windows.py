"""The window invariant the split kernels K3 and K5 rest on: every quota
window of every shuffle pass lies in its own (128,128) tile, 0 <= starts
<= 128 - Q. `shuffle_device_arrays` checks it once per plan, so every
plan that reaches the card passes through it: a freshly built one, one
loaded from a plan file, and the stacked plans of `distribute_stream`.

The port's plans (native planner on and off) and the reference
planner's pass it; a hand-edited `starts` is refused wherever a plan
is uploaded.

K1 rests on a like invariant: each x window, rows [g0[w], g0[w] + 128)
of the natural x table, lies within its x_nat_rows rows.
`StreamPlan.to` refuses a plan that breaks it, built or read from a
plan file."""

import dataclasses

import numpy as np
import pytest
import torch

from spmv_tpu.kernels import shuffle as jshuffle
from spmv_tpu_torch import native as tnative
from spmv_tpu_torch.examples.shortest_paths import random_graph
from spmv_tpu_torch.io.generate import power_law_csr, random_csr
from spmv_tpu_torch.kernels import shuffle as tshuffle
from spmv_tpu_torch.kernels import stream as tstream
from spmv_tpu_torch.ops import routing
from spmv_tpu_torch.utils import plancache as tcache

torch.set_num_threads(1)

MATRICES = {
    "power_law": (lambda: power_law_csr(16384, 16384, 60000, seed=12), 8192),
    "graph": (lambda: random_graph(1 << 14, 4, seed=0), 14336),
    "random": (lambda: random_csr(20000, 30000, 150000, seed=1), 12288),
}


@pytest.fixture(params=["native", "numpy"])
def planner(request, monkeypatch):
    """The native planner, or its NumPy fallback (no native library).
    The windows come from the split simulation; the route stages do not
    bear on them, and the NumPy router takes minutes on these plans
    (tests/test_torch_plan.py holds it against the reference's), so the
    NumPy case leaves every route stage 0."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_tried", True)
        monkeypatch.setattr(routing, "route_tiles_py", lambda src: tuple(
            np.zeros(src.shape, np.uint8) for _ in range(3)))
    assert tnative.available() == (request.param == "native")
    return request.param


def _assert_windows_in_tile(passes):
    for p in passes:
        assert p.starts.shape == (p.n_steps, p.sbt, p.K)
        assert p.starts.min() >= 0 and p.starts.max() <= 128 - p.Q


def _three_pass_dst(seed=5, n_in_tiles=8, F=8, live_per_tile=1800):
    # the geometry of tests/test_shuffle.py's two-level three-pass case
    rng = np.random.default_rng(seed)
    dst = np.full(n_in_tiles * tshuffle.TILE, -1, np.int64)
    live = np.concatenate([t * tshuffle.TILE + rng.choice(
        tshuffle.TILE, live_per_tile, replace=False) for t in range(n_in_tiles)])
    dst[live] = rng.permutation(F * tshuffle.TILE)[:live.size]
    return dst, F


@pytest.mark.parametrize("name", list(MATRICES))
def test_stream_plans_keep_windows_in_their_tile(planner, name):
    make, kappa = MATRICES[name]
    plan = tstream.build_stream_plan(make(), tstream.StreamPolicy(kappa=kappa))
    _assert_windows_in_tile(plan.shuffle.passes)
    assert len(plan.shuffle_dev) == len(plan.shuffle.passes)


def test_three_pass_plan_keeps_windows_in_its_tiles(planner):
    dst, F = _three_pass_dst()
    levels = [(2, 16, 1), (4, 16, 1)]
    plan = tshuffle.plan_shuffle_multi(dst, F, levels=levels, sbt=1)
    assert len(plan.passes) == 3
    _assert_windows_in_tile(plan.passes)
    dev = tshuffle.shuffle_device_arrays(plan)
    # the reference planner's plan passes the same check, with the same starts
    ref = jshuffle.plan_shuffle_multi(dst, F, levels=levels, sbt=1)
    for i, (d, p) in enumerate(zip(dev, ref.passes)):
        tshuffle.check_windows(i, p)
        n_steps, sbt, K = p.starts.shape
        np.testing.assert_array_equal(
            d["starts"][:n_steps, :sbt * K], p.starts.reshape(n_steps, -1))


def _edited(plan, i, value):
    """The shuffle plan with one window start of pass i set to value."""
    p = plan.passes[i]
    starts = p.starts.copy()
    starts[-1, 0, -1] = value
    passes = list(plan.passes)
    passes[i] = dataclasses.replace(p, starts=starts)
    return dataclasses.replace(plan, passes=passes)


@pytest.fixture(scope="module")
def power_law_plan():
    make, kappa = MATRICES["power_law"]
    return tstream.build_stream_plan(make(), tstream.StreamPolicy(kappa=kappa))


@pytest.mark.parametrize("i,over", [(0, 1), (1, 1), (1, -129)])
def test_edited_starts_are_refused(power_law_plan, i, over):
    sh = power_law_plan.shuffle
    tshuffle.shuffle_device_arrays(sh)  # as built, it passes
    value = 128 - sh.passes[i].Q + over
    with pytest.raises(ValueError, match=f"shuffle pass {i}: window start {value} "):
        tshuffle.shuffle_device_arrays(_edited(sh, i, value))


def test_edited_starts_are_refused_in_a_plan_file(power_law_plan, tmp_path):
    path = str(tmp_path / "plan.npz")
    tcache.save_plan(power_law_plan, path)
    assert len(tcache.load_plan(path).shuffle_dev) == 2
    bad = dataclasses.replace(power_law_plan,
                              shuffle=_edited(power_law_plan.shuffle, 1, 127))
    tcache.save_plan(bad, path)
    with pytest.raises(ValueError, match="shuffle pass 1: window start 127 "):
        tcache.load_plan(path)


def test_edited_starts_are_refused_in_distribute_streams_plans(monkeypatch):
    from spmv_tpu_torch.parallel import dist_stream as tdst
    from spmv_tpu_torch.parallel import partition as tpart

    A = power_law_csr(20000, 20000, 150000, alpha=1.5, seed=7)
    plan = tpart.build_halo_plan(A, 2)
    policy = tstream.StreamPolicy(kappa=12288)
    uni = tdst.build_uniform_plans(A, plan, policy=policy)
    for i, m in enumerate(uni.split_meta):
        st = uni.dev[f"sp{i}_starts"]
        assert st.min() >= 0 and st.max() <= 128 - m["Q"]
    for name in ("plan_shuffle_auto", "plan_shuffle_multi"):
        real = getattr(tdst, name)
        monkeypatch.setattr(tdst, name, lambda *a, _real=real, **k: _edited(
            _real(*a, **k), 0, 128))
    with pytest.raises(ValueError, match="shuffle pass 0: window start 128 "):
        tdst.build_uniform_plans(A, plan, policy=policy)


@pytest.mark.parametrize("where,ok", [("at_end", True), ("past_end", False),
                                      ("negative", False)])
def test_x_windows_leaving_the_natural_x_table_are_refused(power_law_plan, where, ok):
    g = power_law_plan.gather
    n = g["x_nat_rows"]
    assert "xr1" in g and g["g0"].max() + 128 <= n
    power_law_plan.to("cpu")  # as built, it passes
    g0 = g["g0"].copy()
    g0[1] = {"at_end": n - 128, "past_end": n - 127, "negative": -1}[where]
    edited = dataclasses.replace(power_law_plan, gather={**g, "g0": g0})
    if ok:
        edited.to("cpu")
    else:
        with pytest.raises(ValueError, match=rf"x window 1: rows \[{g0[1]}, "):
            edited.to("cpu")


def test_x_windows_edited_in_a_plan_file_are_refused(power_law_plan, tmp_path):
    path = str(tmp_path / "plan.npz")
    tcache.save_plan(power_law_plan, path)
    tcache.load_plan(path).to("cpu")
    with np.load(path) as z:
        entries = {k: z[k] for k in z.files}
    n = power_law_plan.gather["x_nat_rows"]
    entries["gather.g0"][-1] = n - 100
    with open(path, "wb") as fh:
        np.savez(fh, **entries)
    plan = tcache.load_plan(path)
    with pytest.raises(ValueError, match=rf"x window {plan.gather['g0'].size - 1}: "
                                         rf"rows \[{n - 100}, {n + 28}\) leave"):
        plan.to("cpu")
