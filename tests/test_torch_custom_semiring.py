"""User-defined semirings in the port against the reference's
(`tests/test_custom_semiring.py`), and the codegen that takes them onto
the card (`spmv_tpu_torch/ops/ring_codegen.py`).

On a CPU tensor a user ring runs through the plain versions, which call
its torch callables; on a CUDA tensor through its traced CUDA source
(tests/test_torch_cuda.py). Here:
- the reference's cases: MAX_PLUS on its seven GENERIC_KINDS,
  SAT_ADD_TIMES on merge_genl and stream, or-and boolean on signed data,
  `y_dtype=bfloat16` and float64 raising, each against the reference
  and its oracle at the reference's rtol 2e-5 / atol 1e-5;
- the emitted source as text;
- the emitted expression trees, evaluated by a NumPy interpreter of the
  CUDA semantics (`_eval` below: the `_rn` operations, spmv_tmin's and
  spmv_tmax's NaN and signed-zero rule, clamp's order), against the
  torch callables on float32 edge values (±inf, NaN, -0.0, subnormals),
  bit for bit (NaN as NaN);
- an untraceable ring and an off-menu op raising by name;
- the dtype promotion table against `jnp.promote_types`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.ops import semiring as jsr
from spmv_tpu_torch.formats import COO, CSR, coo_to_csr
from spmv_tpu_torch.ops import ring_codegen as rc
from spmv_tpu_torch.ops import semiring as tsr
from spmv_tpu_torch.ops.registry import promote
from spmv_tpu_torch.config import set_default_device


@pytest.fixture(autouse=True, scope="module")
def _cpu_default():
    """Host inputs go to the card unless the CPU is asked for; these
    cases run on the CPU, so they ask for it."""
    set_default_device("cpu")
    yield
    set_default_device(None)


torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-5
CAP = 4.0


def _rings(name, initialize, combine, reduce_j, reduce_t):
    return (jsr.Semiring(name, initialize, combine, reduce_j),
            tsr.Semiring(name, initialize, combine, reduce_t))


J_MAX_PLUS, MAX_PLUS = _rings("max_plus", lambda: float("-inf"), lambda a, x: a + x,
                              lambda acc, v: jnp.maximum(acc, v),
                              lambda acc, v: torch.maximum(acc, v))
J_SAT, SAT_ADD_TIMES = _rings("sat_add_times", lambda: 0.0, lambda a, x: a * x,
                              lambda acc, v: jnp.minimum(acc + v, CAP),
                              lambda acc, v: torch.clamp(acc + v, max=CAP))

GENERIC_KINDS = ["merge_genl", "stream", "xla", "csr_vector", "light_vec",
                 "csr_scalar", "merge"]


def _port(A):
    return CSR(A.n_rows, A.n_cols, np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax))


@pytest.fixture(scope="module")
def posmat():
    A = power_law_csr(180, 180, 1600, seed=5)
    Ax = np.abs(np.asarray(A.Ax)).astype(np.float32) + 0.05
    Aj = spmv_tpu.formats.coo_to_csr(spmv_tpu.formats.COO(
        180, 180, A.row_ids(), np.asarray(A.Aj), Ax))
    return Aj, coo_to_csr(COO(180, 180, A.row_ids(), np.asarray(A.Aj), Ax))


@pytest.mark.parametrize("kind", GENERIC_KINDS)
def test_custom_max_plus_matches_oracle(posmat, kind):
    Aj, At = posmat
    x = np.abs(np.random.default_rng(2).standard_normal(180)).astype(np.float32)
    y = spmv_tpu_torch.spmv(kind, At, x, semiring=MAX_PLUS).numpy()
    np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref_semiring(
        At, x, MAX_PLUS, y_dtype=np.float32), rtol=RTOL, atol=ATOL, err_msg=kind)
    yj = np.asarray(spmv_tpu.spmv(kind, Aj, x, semiring=J_MAX_PLUS))
    np.testing.assert_allclose(y, yj, rtol=RTOL, atol=ATOL, err_msg=kind)


@pytest.mark.parametrize("kind", ["merge_genl", "stream"])
def test_custom_saturating_semiring(posmat, kind):
    Aj, At = posmat
    x = np.full(180, 0.01, np.float32)
    y = spmv_tpu_torch.spmv(kind, At, x, semiring=SAT_ADD_TIMES).numpy()
    np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref_semiring(
        At, x, SAT_ADD_TIMES, y_dtype=np.float32), rtol=RTOL, atol=ATOL, err_msg=kind)
    yj = np.asarray(spmv_tpu.spmv(kind, Aj, x, semiring=J_SAT))
    np.testing.assert_allclose(y, yj, rtol=RTOL, atol=ATOL, err_msg=kind)


@pytest.mark.parametrize("kind", GENERIC_KINDS)
def test_or_and_is_boolean_on_arbitrary_data(kind):
    A = random_csr(90, 90, 700, seed=13)  # signed values
    rng = np.random.default_rng(3)
    x = rng.standard_normal(90).astype(np.float32)
    x[rng.random(90) < 0.5] = 0.0
    y = spmv_tpu_torch.spmv(kind, _port(A), x, semiring=spmv_tpu_torch.OR_AND).numpy()
    np.testing.assert_array_equal(y, spmv_tpu_torch.spmv_ref_semiring(
        _port(A), x, spmv_tpu_torch.OR_AND, y_dtype=np.float32), err_msg=kind)
    np.testing.assert_array_equal(
        y, np.asarray(spmv_tpu.spmv(kind, A, x, semiring=spmv_tpu.OR_AND)), err_msg=kind)


def test_y_dtype_is_independently_selectable():
    A = random_csr(40, 40, 200, seed=1)
    x = np.ones(40, np.float32)
    y = spmv_tpu_torch.spmv("merge", _port(A), x, y_dtype=ml_dtypes.bfloat16)
    assert y.dtype == torch.bfloat16
    y32 = spmv_tpu_torch.spmv("merge", _port(A), x).numpy()
    np.testing.assert_allclose(y.float().numpy(), y32, rtol=1e-2, atol=1e-2)
    yj = np.asarray(spmv_tpu.spmv("merge", A, x, y_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(y.view(torch.int16).numpy().view(np.uint16),
                                  yj.view(np.uint16))


@pytest.mark.parametrize("kind", ["merge", "stream", "csr_vector"])
def test_fp64_without_x64_raises_loudly(kind):
    assert not jax.config.jax_enable_x64
    A = random_csr(20, 20, 60, seed=4, value_dtype=np.float64)
    x = np.ones(20, np.float64)
    with pytest.raises(ValueError, match="float64"):
        spmv_tpu.spmv(kind, A, x)
    with pytest.raises(ValueError, match="float64"):
        spmv_tpu_torch.spmv(kind, _port(A), x)


# --- the codegen --------------------------------------------------------

SAT_MIN = tsr.Semiring("sat_min", lambda: 0.1, lambda a, x: a * x,
                       lambda acc, v: torch.minimum(acc + v, torch.tensor(4.0)))
OR_AND_USER = tsr.Semiring("or_and_user", lambda: 0.0, tsr._or_and_combine,
                           lambda acc, v: torch.maximum(acc, v))
WIDE = tsr.Semiring(
    "wide_menu", lambda: float("nan"),
    lambda a, x: torch.where((a > x) | ~(a <= -x), torch.abs(a) / x, -(a - x)),
    lambda acc, v: torch.fmax(torch.clamp(acc, min=-2.5, max=2.5),
                              torch.fmin(v, acc * 2).to(acc.dtype)))
CODEGEN_RINGS = {"max_plus": MAX_PLUS, "sat_add_times": SAT_ADD_TIMES,
                 "sat_min": SAT_MIN, "or_and_user": OR_AND_USER, "wide_menu": WIDE}


def test_emitted_source_as_text():
    h = rc.ring_header(MAX_PLUS)
    assert "#define SPMV_RING_USER 5" in h and '#include "ring.cuh"' in h
    assert "struct Ring<SPMV_RING_USER>" in h
    assert "return __int_as_float(0xff800000); }" in h  # -inf by bit pattern
    assert "const float t0 = __fadd_rn(a0, a1);" in h
    assert "const float t0 = spmv_tmax(a0, a1);" in h
    h = rc.ring_header(SAT_ADD_TIMES)
    assert "__fmul_rn(a0, a1)" in h and "0x1.0000000000000p+2f" in h
    h = rc.ring_header(SAT_MIN)  # identity 0.1 as float32, in hex
    assert "identity() { return 0x1.99999a0000000p-4f; }" in h
    assert "spmv_tmin(t0, 0x1.0000000000000p+2f)" in h  # the 0-d tensor constant
    h = rc.ring_header(OR_AND_USER)
    assert "(a0 != 0x0.0p+0f)" in h and "(t2 ? 1.f : 0.f)" in h
    assert rc.c_literal(rc.f32_bits(float("nan"))) == "__int_as_float(0x7fc00000)"


def _f(bits):
    return np.uint32(bits).view(np.float32)


def _eval(e, a, b):
    """The CUDA semantics of an emitted tree on float32 arrays."""
    op = e[0]
    if op == "arg":
        return (a, b)[e[1]]
    if op == "const":
        return np.full_like(a, _f(e[1]))
    if op == "bconst":
        return np.full(a.shape, e[1])
    v = [_eval(x, a, b) for x in e[1:]]
    with np.errstate(all="ignore"):
        if op in ("add", "sub", "mul", "div"):
            return {"add": np.add, "sub": np.subtract, "mul": np.multiply,
                    "div": np.divide}[op](v[0], v[1], dtype=np.float32)
        if op == "min":  # spmv_tmin: b where b is NaN or b < a, else a
            return np.where(np.isnan(v[1]) | (v[1] < v[0]), v[1], v[0])
        if op == "max":
            return np.where(np.isnan(v[1]) | (v[1] > v[0]), v[1], v[0])
        if op == "fmin":
            return np.where(np.isnan(v[0]) | (v[1] < v[0]), v[1], v[0])
        if op == "fmax":
            return np.where(np.isnan(v[0]) | (v[1] > v[0]), v[1], v[0])
        if op == "clamp_min":
            return np.where(np.isnan(v[1]) | (v[0] < v[1]), v[1], v[0])
        if op == "clamp_max":
            return np.where(np.isnan(v[1]) | (v[0] > v[1]), v[1], v[0])
        if op in rc.CMPS:
            return getattr(np, {"lt": "less", "le": "less_equal", "gt": "greater",
                                "ge": "greater_equal", "eq": "equal",
                                "ne": "not_equal"}[op])(v[0], v[1])
        if op == "and":
            return v[0] & v[1]
        if op == "or":
            return v[0] | v[1]
        if op == "not":
            return ~v[0]
        if op == "neg":
            return -v[0]
        if op == "abs":
            return np.abs(v[0])
        if op == "where":
            return np.where(v[0], v[1], v[2])
        if op == "float":
            return v[0].astype(np.float32)
    raise AssertionError(op)


EDGES = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 3.0, -2.75, 4.0, 1e-45, -1e-45,
                  1.1754942e-38, 3.4028235e38, -3.4028235e38, np.inf, -np.inf,
                  np.nan, 0.1, 7.5], np.float32)


def _same_bits(got, want):
    """Bit for bit, NaN as NaN, and a zero as a zero of either sign:
    torch's own min and max of +0 and -0 give either sign, by code path
    (the scalar loop returns the first operand, the vector loop the
    second)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    zero = want == 0
    np.testing.assert_array_equal(got[zero], 0)
    keep = ~nan & ~zero
    np.testing.assert_array_equal(got[keep].view(np.uint32), want[keep].view(np.uint32))


@pytest.mark.parametrize("name", list(CODEGEN_RINGS))
def test_emitted_trees_equal_the_callables_bit_for_bit(name):
    sr = CODEGEN_RINGS[name]
    t = rc.trace_ring(sr)
    a, b = (m.ravel() for m in np.meshgrid(EDGES, EDGES, indexing="ij"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same_bits(_eval(t.combine, a, b), sr.combine(ta, tb).float().numpy())
    _same_bits(_eval(t.reduce, a, b), sr.reduce(ta, tb).float().numpy())
    _same_bits(_f(t.identity), np.float32(sr.initialize()))


def test_untraceable_and_off_menu_rings_raise_by_name():
    cf = tsr.Semiring("control_flow", lambda: 0.0, lambda a, x: a * x,
                      lambda acc, v: acc + v if acc.numel() > 0 else acc)
    with pytest.raises(NotImplementedError, match="'control_flow': its reduce cannot "
                                                  "be traced.*CPU tensor"):
        rc.ring_header(cf)
    sin = tsr.Semiring("sine", lambda: 0.0, lambda a, x: torch.sin(a) * x,
                       lambda acc, v: acc + v)
    with pytest.raises(NotImplementedError, match="'sine': torch.sin is not on the "
                                                  "menu.*CPU tensor"):
        tsr.device_ring_code(sin)
    half = tsr.Semiring("to_half", lambda: 0.0,
                        lambda a, x: (a * x).to(torch.float16), lambda acc, v: acc + v)
    with pytest.raises(NotImplementedError, match="cast to torch.float16"):
        rc.trace_ring(half)
    # both run on a CPU tensor
    A = _port(random_csr(30, 30, 120, seed=2))
    x = np.abs(np.random.default_rng(1).standard_normal(30)).astype(np.float32)
    for ring in (cf, sin):
        y = spmv_tpu_torch.spmv("stream", A, x, semiring=ring).numpy()
        np.testing.assert_allclose(y, spmv_tpu_torch.spmv_ref_semiring(
            A, x, ring, y_dtype=np.float32), rtol=RTOL, atol=ATOL)


PROMOTE = ("bfloat16", "float16", "float32", "int8", "int32", "uint8")


@pytest.mark.parametrize("a", PROMOTE)
@pytest.mark.parametrize("b", PROMOTE)
def test_promotion_matches_the_reference(a, b):
    """Pairs with bfloat16 promote by JAX's table (NumPy has no bfloat16);
    the rest by NumPy's, as the reference's resolve_val_dtype does."""
    ta, tb = (getattr(torch, d) for d in (a, b))
    want = (jnp.promote_types(jnp.dtype(a), jnp.dtype(b)) if "bfloat16" in (a, b)
            else np.promote_types(a, b))
    assert promote(ta, tb) == getattr(torch, np.dtype(want).name)
