"""Where the port's entry points put host inputs (`spmv_tpu_torch.config`):
on the card unless the caller asks for the CPU, as the reference's
`jnp.asarray` puts them on JAX's default device, the TPU.

Every check is parametrised over the entry points: `spmv`, `SpMV`, the
four `spmm` functions, `cg`, `bicgstab`, `gmres`, `sptrsv`, `ilu0_apply`,
`SparseOperator` (`__call__`, `matvec`, `rmatvec`), `spmv_values`,
`spmv_value_grad` and `to_torch_sparse` (host inputs), and `spgemm`,
`make_mesh`, the harness, the examples and `weak_scaling` (no device
given).

- With no card (`torch.cuda.is_available` patched to False where a card
  could be present) and no CPU asked for, each raises RuntimeError
  (SystemExit for the command lines) naming `set_default_device("cpu")`,
  before any plan is built and with no kernel wrapper (K1-K15, plain or
  not) and no glue fold (`segment_reduce_sorted`) called.
- Under `set_default_device("cpu")` each returns CPU tensors that match
  the reference run on the CPU within the tolerances of the entry
  point's own test file: rtol 2e-4 / atol 1e-5 (`spmv`, `SpMV`, the mesh),
  2e-4 / 1e-4 (`spmm`, `spgemm`), 1e-4 / 1e-5 (`sptrsv`, `ilu0_apply`,
  autograd), the solvers' iteration counts within one (GMRES: one restart
  cycle) and x within atol 5e-4 (cg, bicgstab) or 2e-3 (gmres),
  `to_torch_sparse` exactly. The examples, the harness and
  `weak_scaling` match the same call given device="cpu" (--device cpu),
  bit for bit; their own test files hold that call to the reference.
- A CPU tensor stays on the CPU, whatever the default.
- The triangular solve's plan arrays (`vals`, `diag`) are built on the
  host while host inputs go elsewhere (the default patched to a device
  other than the CPU).
"""

import sys

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch as st
from spmv_tpu import solvers as jsolvers
from spmv_tpu.formats import CSR as JCSR
from spmv_tpu.io import interop as jio
from spmv_tpu.kernels import spgemm as jspgemm
from spmv_tpu.kernels import trisolve as jtri
from spmv_tpu.ops import autodiff as jad
from spmv_tpu_torch import config, solvers
from spmv_tpu_torch.bench import harness, weak_scaling
from spmv_tpu_torch.examples import bfs as tbfs
from spmv_tpu_torch.examples import pagerank as tpr
from spmv_tpu_torch.examples import shortest_paths as tsp
from spmv_tpu_torch.examples import solve_poisson as tpoisson
from spmv_tpu_torch.formats import CSR
from spmv_tpu_torch.io import interop as tio
from spmv_tpu_torch.io.generate import power_law_csr, random_csr
from spmv_tpu_torch.kernels import spgemm as tspgemm
from spmv_tpu_torch.kernels import spmm as tspmm
from spmv_tpu_torch.kernels import trisolve as ttri
from spmv_tpu_torch.ops import autodiff as tad
from spmv_tpu_torch.ops import registry
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.parallel import distribute_csr, make_mesh

torch.set_num_threads(1)

ASK = r'set_default_device\("cpu"\)'


@pytest.fixture(autouse=True)
def _card_default():
    """Each case starts from the default (the card) and leaves it so."""
    config.set_default_device(None)
    yield
    config.set_default_device(None)


def _j(A: CSR) -> JCSR:
    return JCSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))


class Case:
    """Fresh matrices (no plan cached on them) and seeded host inputs."""

    def __init__(self):
        rng = np.random.default_rng(21)
        self.A = random_csr(96, 80, 600, seed=1)
        self.B = random_csr(80, 70, 500, seed=2)
        self.P = tpoisson.poisson2d(8)
        self.L, self.U = ttri.ilu0(self.P)
        self.x64 = rng.standard_normal(80)  # float64: narrowed as jnp.asarray does
        self.x = self.x64.astype(np.float32)
        self.y = rng.standard_normal(96).astype(np.float32)
        self.X = rng.standard_normal((80, 8)).astype(np.float32)
        self.b = rng.standard_normal(64).astype(np.float32)
        self.Ax = rng.standard_normal(self.A.nnz).astype(np.float32)

    def matrices(self):
        return [self.A, self.B, self.P, self.L, self.U]


# name -> (port call on (case, its input), the input from the case, the
# reference on the CPU, tolerance); each tolerance is the one of the entry
# point's own test file
HOST_ENTRIES = {
    "spmv": (lambda c, x: st.spmv("stream", c.A, x), lambda c: c.x64,
             lambda c: spmv_tpu.spmv("xla", _j(c.A), c.x64), (2e-4, 1e-5)),
    "SpMV": (lambda c, x: st.SpMV("stream", c.A.n_rows, c.A.n_cols, c.A.nnz, c.A.Ap,
                                  c.A.Aj, c.A.Ax, x), lambda c: c.x64,
             lambda c: spmv_tpu.SpMV("xla", c.A.n_rows, c.A.n_cols, c.A.nnz, c.A.Ap,
                                     c.A.Aj, c.A.Ax, c.x64), (2e-4, 1e-5)),
    "spmm": (lambda c, X: st.spmm(c.A, X), lambda c: c.X,
             lambda c: spmv_tpu.spmm(_j(c.A), c.X, method="xla"), (2e-4, 1e-4)),
    "spmm_stream": (lambda c, X: tspmm.spmm_stream(c.A, X), lambda c: c.X,
                    lambda c: spmv_tpu.spmm(_j(c.A), c.X, method="xla"), (2e-4, 1e-4)),
    "spmm_window": (lambda c, X: tspmm.spmm_window(c.A, X), lambda c: c.X,
                    lambda c: spmv_tpu.spmm(_j(c.A), c.X, method="xla"), (2e-4, 1e-4)),
    "spmm_xla": (lambda c, X: tspmm.spmm_xla(c.A, X), lambda c: c.X,
                 lambda c: spmv_tpu.spmm(_j(c.A), c.X, method="xla"), (2e-4, 1e-4)),
    "cg": (lambda c, b: solvers.cg(c.P, b, rtol=1e-6, kind="csr_vector"), lambda c: c.b,
           lambda c: jsolvers.cg(_j(c.P), c.b, rtol=1e-6, kind="xla"), ("iters", 1, 5e-4)),
    "bicgstab": (lambda c, b: solvers.bicgstab(c.P, b, rtol=1e-6, kind="csr_vector"),
                 lambda c: c.b,
                 lambda c: jsolvers.bicgstab(_j(c.P), c.b, rtol=1e-6, kind="xla"),
                 ("iters", 1, 5e-4)),
    "gmres": (lambda c, b: solvers.gmres(c.P, b, rtol=1e-5, restart=20, kind="stream"),
              lambda c: c.b,
              lambda c: jsolvers.gmres(_j(c.P), c.b, rtol=1e-5, restart=20, kind="xla"),
              ("iters", 20, 2e-3)),
    "sptrsv": (lambda c, b: ttri.sptrsv(c.L, b, lower=True, unit_diagonal=True),
               lambda c: c.b,
               lambda c: jtri.sptrsv(_j(c.L), c.b, lower=True, unit_diagonal=True),
               (1e-4, 1e-5)),
    "ilu0_apply": (lambda c, b: ttri.ilu0_apply(c.L, c.U, b), lambda c: c.b,
                   lambda c: jtri.ilu0_apply(_j(c.L), _j(c.U), c.b), (1e-4, 1e-5)),
    "SparseOperator": (lambda c, x: tad.SparseOperator(c.A, kind="stream")(x),
                       lambda c: c.x, lambda c: jad.SparseOperator(_j(c.A))(c.x),
                       (1e-4, 1e-5)),
    "SparseOperator.matvec": (lambda c, x: tad.SparseOperator(c.A, kind="stream").matvec(x),
                              lambda c: c.x,
                              lambda c: jad.SparseOperator(_j(c.A)).matvec(c.x),
                              (1e-4, 1e-5)),
    "SparseOperator.rmatvec": (
        lambda c, y: tad.SparseOperator(c.A, kind="stream").rmatvec(y), lambda c: c.y,
        lambda c: jad.SparseOperator(_j(c.A)).rmatvec(c.y), (1e-4, 1e-5)),
    "spmv_values": (lambda c, x: tad.spmv_values(c.A, c.Ax, x), lambda c: c.x,
                    lambda c: jad.spmv_values(_j(c.A), c.Ax, c.x), (1e-4, 1e-5)),
    "spmv_value_grad": (lambda c, x: tad.spmv_value_grad(c.A, x, c.y), lambda c: c.x,
                        lambda c: jad.spmv_value_grad(_j(c.A), c.x, c.y), (1e-4, 1e-5)),
}
# entry points whose CPU run goes through a kernel wrapper or the glue fold
# (so the spies below see the plain versions run)
SPIED = set(HOST_ENTRIES) - {"spmv_value_grad"}


def _harness_args():
    return ["--synthetic", "random", "--rows", "512", "--nnz", "4096", "--iters", "2",
            "xla", "stream"]


def _weak_args():
    return ["--devices", "1", "2", "--rows-per-dev", "512", "--nnz-per-dev", "4000",
            "--iters", "2", "--impl", "ell"]


def _graph():
    G = power_law_csr(300, 300, 1500, alpha=1.5, seed=4)
    return G, G.transpose()


# name -> (call with no device, the same call given the CPU): the
# entry points that take a device rather than a host input
DEVICE_ENTRIES = {
    "to_torch_sparse": (lambda c: tio.to_torch_sparse(c.A),
                        lambda c: tio.to_torch_sparse(c.A, device="cpu")),
    "spgemm": (lambda c: tspgemm.spgemm(c.A, c.B),
               lambda c: tspgemm.spgemm(c.A, c.B, device="cpu")),
    "make_mesh": (lambda c: distribute_csr(c.A, make_mesh("shards", n_shards=2)).matvec(
                      torch.from_numpy(c.x)),
                  lambda c: distribute_csr(c.A, make_mesh("shards", n_shards=2,
                                                          device="cpu")).matvec(
                      torch.from_numpy(c.x))),
    "bfs": (lambda c: tbfs.bfs(_graph()[1], 0, "xla"),
            lambda c: tbfs.bfs(_graph()[1], 0, "xla", device="cpu")),
    "pagerank": (lambda c: tpr.pagerank(*tpr.build(300, 1500)[1:], "xla"),
                 lambda c: tpr.pagerank(*tpr.build(300, 1500)[1:], "xla", device="cpu")),
    "sssp": (lambda c: tsp.sssp(tsp.random_graph(300), 0, kind="xla"),
             lambda c: tsp.sssp(tsp.random_graph(300), 0, kind="xla", device="cpu")),
    "solve_poisson": (lambda c: tpoisson.main(8, "xla"),
                      lambda c: tpoisson.main(8, "xla", device="cpu")),
    "harness": (lambda c: harness.main(_harness_args()),
                lambda c: harness.main(["--device", "cpu"] + _harness_args())),
    "weak_scaling": (lambda c: weak_scaling.main(_weak_args()),
                     lambda c: weak_scaling.main(["--device", "cpu"] + _weak_args())),
}
CLI_ENTRIES = {"harness", "weak_scaling"}


def _spy(monkeypatch) -> list:
    """Replace every kernel wrapper (a function with a `launches` count:
    K1-K15 and K11') and `segment_reduce_sorted`, wherever a module of
    the port binds it, by a spy that records each call and calls
    through; returns the record."""
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("spmv_tpu_torch") and m is not None]
    targets = {id(f): f for m in mods for f in vars(m).values()
               if callable(f) and hasattr(f, "launches")}
    targets[id(tsr.segment_reduce_sorted)] = tsr.segment_reduce_sorted
    calls = []
    spies = {}
    for key, f in targets.items():
        def spy(*a, _f=f, **k):
            calls.append(_f.__name__)
            return _f(*a, **k)
        spy.launches = 0
        spies[key] = spy
    for m in mods:
        for name, v in list(vars(m).items()):
            if id(v) in spies and v is targets[id(v)]:
                monkeypatch.setattr(m, name, spies[id(v)])
    return calls


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _devices(out):
    """The device types of every tensor in an entry point's result (a
    tensor, or tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device.type}
    if isinstance(out, (tuple, list)):
        return set().union(*(_devices(o) for o in out)) if out else set()
    if isinstance(out, dict):
        return set().union(*(_devices(o) for o in out.values())) if out else set()
    return set()


@pytest.mark.parametrize("name", list(HOST_ENTRIES))
def test_host_input_without_a_card_raises(monkeypatch, name):
    call, arg, _, _ = HOST_ENTRIES[name]
    c = Case()
    _no_card(monkeypatch)
    calls = _spy(monkeypatch)
    with pytest.raises(RuntimeError, match=ASK) as e:
        call(c, arg(c))
    assert "pass CPU tensors" in str(e.value)
    assert calls == []
    assert not any(registry._PLAN_CACHES.get(M) for M in c.matrices())


@pytest.mark.parametrize("name", list(DEVICE_ENTRIES))
def test_no_device_without_a_card_raises(monkeypatch, name):
    c = Case()
    _no_card(monkeypatch)
    calls = _spy(monkeypatch)
    err = SystemExit if name in CLI_ENTRIES else RuntimeError
    with pytest.raises(err, match=ASK) as e:
        DEVICE_ENTRIES[name][0](c)
    assert "cpu" in str(e.value)
    assert calls == []
    assert not any(registry._PLAN_CACHES.get(M) for M in c.matrices())


def _close(got, want, tol):
    if tol[0] == "iters":
        (xt, it), (xj, ij) = got, want
        assert it["converged"] and ij["converged"]
        assert abs(it["iters"] - ij["iters"]) <= tol[1], (it, ij)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=tol[2])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", list(HOST_ENTRIES))
def test_host_input_on_the_cpu_when_asked(monkeypatch, name):
    call, arg, ref, tol = HOST_ENTRIES[name]
    c = Case()
    calls = _spy(monkeypatch)
    config.set_default_device("cpu")
    got = call(c, arg(c))
    assert _devices(got) == {"cpu"}
    _close(got, ref(c), tol)
    assert bool(calls) == (name in SPIED), calls


def test_to_torch_sparse_on_the_cpu_when_asked():
    c = Case()
    config.set_default_device("cpu")
    for layout in (torch.sparse_csr, torch.sparse_coo):
        T = tio.to_torch_sparse(c.A, layout)
        assert T.device.type == "cpu" and T.layout == layout
        np.testing.assert_array_equal(T.to_dense().numpy(),
                                      np.asarray(jio.to_bcoo(_j(c.A)).todense()))


def test_spgemm_on_the_cpu_when_asked():
    c = Case()
    config.set_default_device("cpu")
    C = tspgemm.spgemm(c.A, c.B)
    Cj = jspgemm.spgemm(_j(c.A), _j(c.B), method="xla")
    np.testing.assert_array_equal(C.Ap, np.asarray(Cj.Ap))
    np.testing.assert_array_equal(C.Aj, np.asarray(Cj.Aj))
    np.testing.assert_allclose(C.Ax, np.asarray(Cj.Ax), rtol=2e-4, atol=1e-4)


def test_make_mesh_on_the_cpu_when_asked():
    c = Case()
    config.set_default_device("cpu")
    mesh = make_mesh("shards", n_shards=2)
    assert mesh.device == torch.device("cpu")
    y = distribute_csr(c.A, mesh).matvec(c.x)
    assert y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), np.asarray(spmv_tpu.spmv("xla", _j(c.A), c.x)),
                               rtol=2e-4, atol=1e-5)


def _same(a, b):
    """a and b equal bit for bit (host-clock seconds aside), tensors on
    the same device."""
    if isinstance(a, torch.Tensor):
        assert a.device == b.device
        assert torch.equal(a.to_dense(), b.to_dense())
    elif isinstance(a, CSR):
        for f in ("Ap", "Aj", "Ax"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a.keys() - {"seconds"}:
            _same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("name", [n for n in DEVICE_ENTRIES if n not in CLI_ENTRIES])
def test_no_device_on_the_cpu_when_asked(name):
    c = Case()
    config.set_default_device("cpu")
    got = DEVICE_ENTRIES[name][0](c)
    assert _devices(got) <= {"cpu"}
    config.set_default_device(None)
    _same(got, DEVICE_ENTRIES[name][1](c))


@pytest.mark.parametrize("name", sorted(CLI_ENTRIES))
def test_command_line_on_the_cpu_when_asked(name, capsys):
    config.set_default_device("cpu")
    got = DEVICE_ENTRIES[name][0](None)
    config.set_default_device(None)
    want = DEVICE_ENTRIES[name][1](None)
    if name == "harness":
        assert [r.kind for r in got] == [r.kind for r in want] == ["xla", "stream"]
        assert [r.delta for r in got] == [r.delta for r in want]
    else:
        assert [r["n_devices"] for r in got] == [r["n_devices"] for r in want] == [1, 2]
        assert {r["device"] for r in got} == {r["device"] for r in want} == {"cpu"}


@pytest.mark.parametrize("default", [None, "cpu"])
@pytest.mark.parametrize("name", list(HOST_ENTRIES))
def test_cpu_tensor_stays_on_the_cpu(monkeypatch, name, default):
    call, arg, _, _ = HOST_ENTRIES[name]
    c = Case()
    _no_card(monkeypatch)
    config.set_default_device(default)
    v = torch.from_numpy(np.asarray(arg(c)))
    got = call(c, v)
    assert _devices(got) == {"cpu"}


def test_solve_plan_arrays_stay_on_the_host(monkeypatch):
    """The plan of a triangular solve is built on the host and moved by
    sptrsv; host inputs going to another device (the card, here modelled
    by the meta device) must not take its arrays along."""
    monkeypatch.setattr(registry, "device_for",
                        lambda device=None, **k: torch.device(
                            "meta" if device is None else device))
    assert registry.as_input(np.ones(3, np.float32)).device.type == "meta"
    L, U = ttri.ilu0(tpoisson.poisson2d(6))
    for T, lower, unit in ((L, True, True), (U, False, False)):
        plan = ttri._solve_plan(T, lower, unit)
        for k in ("rows", "cols", "vals", "diag"):
            assert plan[k].device.type == "cpu", k
