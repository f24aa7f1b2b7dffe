"""The multi-device matvec as one graph replay (parallel/dist_spmv.py:
_Distributed._replay), on the CPU.

On a mesh on the CPU, `matvec` caches no graph and equals `_matvec_eager`
bit for bit, for `distribute_csr` (both modes) and `distribute_stream`,
every built-in ring, x global and sharded. The graph's bookkeeping is
held with `capture_graph` faked (a replay runs the captured body again,
on its static input): one graph per (ring, mode, x dtype, x layout), the
first call of a key eager, a later one a replay of the right graph, each
y a fresh tensor. The card's own capture is tests/test_torch_cuda.py's."""

import numpy as np
import pytest
import torch

from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.ops.semiring import MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES
from spmv_tpu_torch.parallel import distribute_csr, distribute_stream, make_mesh
from spmv_tpu_torch.utils import timing

torch.set_num_threads(1)

RINGS = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS, "max_times": MAX_TIMES,
         "or_and": OR_AND}


@pytest.fixture(scope="module")
def layers():
    A = power_law_csr(3000, 3000, 24000, alpha=1.5, seed=5)
    mesh = make_mesh("shards", n_shards=3, device="cpu")
    return A, {"csr": distribute_csr(A, mesh), "stream": distribute_stream(A, mesh)}


def _x(A, ring, seed=0):
    x = np.random.default_rng(seed).standard_normal(A.n_cols).astype(np.float32)
    if ring is MAX_TIMES:  # the ring of non-negative values
        x = np.abs(x)
    if ring is OR_AND:
        x = np.where(np.random.default_rng(seed + 1).random(x.size) < 0.3, 0.0, x)
    return torch.from_numpy(x.astype(np.float32))


CASES = [("csr", "halo"), ("csr", "allgather"), ("stream", None)]


@pytest.mark.parametrize("layout", ["global", "sharded"])
@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("impl,mode", CASES)
def test_cpu_mesh_matvec_is_the_eager_body(layers, impl, mode, ring, layout):
    A, ds = layers
    D, sr = ds[impl], RINGS[ring]
    x = _x(A, sr)
    if layout == "sharded":
        x = D.shard_x(x)
    kw = {} if mode is None else {"mode": mode}
    y = D.matvec(x, semiring=sr, **kw)
    assert torch.equal(y, D._matvec_eager(x, semiring=sr, **kw))
    assert D.graphs == {} and not D._graphed()


@pytest.mark.parametrize("impl,mode", CASES)
def test_graph_bookkeeping_with_a_faked_capture(layers, impl, mode, monkeypatch):
    """Faked on the CPU: the first call of a key runs eagerly and captures
    once; a later call replays its key's graph on the new x and returns a
    fresh y, which a still later call does not change; each (ring, mode,
    x dtype, x layout) gets its own graph."""
    A, ds = layers
    D = ds[impl]
    captures = []

    class FakeGraph:
        """Runs the captured body again on a replay, and writes its y into
        the static y the capture left, as a replay writes its pool."""

        def __init__(self, body):
            self.body, self.replays = body, 0
            # the list the body appends its y to (`_replay`'s `out`)
            self.out = next(c.cell_contents for c in body.__closure__
                            if isinstance(c.cell_contents, list))

        def replay(self):
            self.replays += 1
            self.body()
            self.out[0].copy_(self.out.pop())

    def fake_capture(body, what, device):
        assert "matvec" in what
        body()  # a capture runs the body once, recording its launches
        captures.append(what)
        return FakeGraph(body)

    monkeypatch.setattr(timing, "capture_graph", fake_capture)
    monkeypatch.setattr(type(D), "_graphed", lambda self: True)
    monkeypatch.setattr(D, "graphs", {})
    kw = {} if mode is None else {"mode": mode}
    x1, x2, x3 = _x(A, PLUS_TIMES, 1), _x(A, PLUS_TIMES, 2), _x(A, PLUS_TIMES, 3)
    y1 = D.matvec(x1, **kw)
    assert len(captures) == 1 and len(D.graphs) == 1
    graph, xs, ys = next(iter(D.graphs.values()))
    assert graph.replays == 0
    y1_copy = y1.clone()
    y2 = D.matvec(x2, **kw)
    assert graph.replays == 1 and len(captures) == 1
    assert torch.equal(xs, x2)
    y3 = D.matvec(x3, **kw)
    assert torch.equal(y1, y1_copy)  # no later call changes an earlier y
    assert torch.equal(y2, D._matvec_eager(x2, **kw))
    assert torch.equal(y3, D._matvec_eager(x3, **kw))
    assert y2.data_ptr() != y3.data_ptr()
    # another ring, x layout and x dtype each get a graph of their own
    D.matvec(x1, semiring=MIN_PLUS, **kw)
    D.matvec(D.shard_x(x1), **kw)
    D.matvec(x1.to(torch.float16), **kw)
    assert len(D.graphs) == 4 and len(captures) == 4
    assert {k[3] for k in D.graphs} == {1, 2}
