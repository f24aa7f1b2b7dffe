"""A user-defined semiring as CUDA source.

The reference traces any `Semiring`'s callables into its Pallas kernels
with JAX; a CUDA kernel cannot call Python. So the port traces `combine`
and `reduce` with `torch.fx.symbolic_trace`, maps each node of the graph,
by a fixed menu, to a float32 C++ expression, and writes the ring as
`Ring<SPMV_RING_USER>` (csrc/ring.cuh) in a header that
`kernels/_cuda.py:ring_lib` compiles the ring-templated kernels with.

The menu (every value is a float32 register or a bool):
  - `+ - * /` (operators, `torch.add`/`sub`/`mul`/`div` and the methods)
    through the `_rn` intrinsics, so nvcc contracts nothing into an FMA;
  - unary `-`, `abs`;
  - `torch.minimum`/`maximum` (and two-tensor `torch.min`/`max`) with
    NaN propagated and, of equal operands, the first, as torch returns
    them; `torch.fmin`/`fmax`; `clamp`/`clip`/`clamp_min`/`clamp_max`;
  - `torch.where`, the six comparisons, `& | ~` on bools (and the
    `logical_*` functions);
  - `.to(dtype)` and `.float()` where the dtype is float32 or read from
    an operand (`x.dtype`, `torch.promote_types` of such), the values
    being float32 in the kernel;
  - Python numbers and 0-d tensor constants, rounded to float32 as torch
    rounds a scalar against a float32 tensor.
`initialize()` becomes a literal: ±inf and NaN by bit pattern, anything
else as a hex float. A node outside the menu, or a callable that does
not trace, raises NotImplementedError naming it: such a ring runs on a
CPU tensor, where the plain versions call its Python callables.

`trace_ring` returns the expression trees (`Traced`), which the tests
evaluate in NumPy against the callables; `ring_header` emits them.
"""

from __future__ import annotations

import dataclasses
import operator
import struct

import numpy as np
import torch
import torch.fx

# IR: a tuple (op, *operands) of kind "f" (float32) or "b" (bool):
#   ("arg", i) f, ("const", float32 bits as int) f, ("bconst", bool) b,
#   ("add"|"sub"|"mul"|"div"|"min"|"max"|"fmin"|"fmax", a, b) f,
#   ("neg"|"abs", a) f, ("clamp_min"|"clamp_max", a, bound) f,
#   ("lt"|"le"|"gt"|"ge"|"eq"|"ne", a, b) b, ("and"|"or", a, b) b,
#   ("not", a) b, ("where", c, a, b) f, ("float", b) f.
CMPS = ("lt", "le", "gt", "ge", "eq", "ne")
_DTYPE = object()  # a traced dtype: float32 inside the kernel

_BINARY = {
    operator.add: "add", torch.add: "add", "add": "add",
    operator.sub: "sub", torch.sub: "sub", torch.subtract: "sub", "sub": "sub",
    operator.mul: "mul", torch.mul: "mul", torch.multiply: "mul", "mul": "mul",
    operator.truediv: "div", torch.div: "div", torch.true_divide: "div",
    torch.divide: "div", "div": "div", "true_divide": "div",
    torch.minimum: "min", "minimum": "min", torch.maximum: "max",
    "maximum": "max", torch.min: "min", torch.max: "max",
    torch.fmin: "fmin", "fmin": "fmin", torch.fmax: "fmax", "fmax": "fmax",
    operator.lt: "lt", torch.lt: "lt", torch.less: "lt", "lt": "lt",
    operator.le: "le", torch.le: "le", torch.less_equal: "le", "le": "le",
    operator.gt: "gt", torch.gt: "gt", torch.greater: "gt", "gt": "gt",
    operator.ge: "ge", torch.ge: "ge", torch.greater_equal: "ge", "ge": "ge",
    operator.eq: "eq", torch.eq: "eq", "eq": "eq",
    operator.ne: "ne", torch.ne: "ne", torch.not_equal: "ne", "ne": "ne",
    operator.and_: "and", torch.logical_and: "and", "logical_and": "and",
    operator.or_: "or", torch.logical_or: "or", "logical_or": "or",
}
_UNARY = {
    operator.neg: "neg", torch.neg: "neg", torch.negative: "neg", "neg": "neg",
    operator.abs: "abs", torch.abs: "abs", "abs": "abs",
    operator.invert: "not", torch.logical_not: "not", "logical_not": "not",
}
_CLAMPS = {torch.clamp: "clamp", torch.clip: "clamp", "clamp": "clamp",
           "clip": "clamp", torch.clamp_min: "clamp_min", "clamp_min": "clamp_min",
           torch.clamp_max: "clamp_max", "clamp_max": "clamp_max"}
_C_OPS = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
          "div": "__fdiv_rn", "min": "spmv_tmin", "max": "spmv_tmax",
          "fmin": "spmv_tfmin", "fmax": "spmv_tfmax"}
_C_CMPS = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}


@dataclasses.dataclass(frozen=True)
class Traced:
    """A user ring as expression trees: `identity` as float32 bits,
    `combine` over (a_ij, x_j) and `reduce` over (earlier, later)."""
    name: str
    identity: int
    combine: tuple
    reduce: tuple


def f32_bits(v) -> int:
    return struct.unpack("<I", np.float32(v).tobytes())[0]


def kind(e) -> str:
    return "b" if e[0] in CMPS + ("and", "or", "not", "bconst") else "f"


def _off_menu(what: str, ring: str) -> NotImplementedError:
    return NotImplementedError(
        f"semiring {ring!r}: {what} is not on the menu of operations a "
        f"user-defined ring can take into a CUDA kernel "
        f"(spmv_tpu_torch/ops/ring_codegen.py); run the ring on a CPU tensor, "
        f"where the plain versions call its Python callables")


def _name(target) -> str:
    if isinstance(target, str):
        return f"the method .{target}()"
    mod = getattr(target, "__module__", None) or ""
    mod = "torch" if mod.startswith("torch") else mod
    return f"{mod + '.' if mod else ''}{getattr(target, '__name__', repr(target))}"


def _trace_fn(fn, ring: str, what: str) -> tuple:
    """The expression tree of the 2-argument callable `fn`."""
    try:
        gm = torch.fx.symbolic_trace(fn)
    except Exception as e:  # noqa: BLE001 - any failure to trace is the same refusal
        raise NotImplementedError(
            f"semiring {ring!r}: its {what} cannot be traced by torch.fx "
            f"({type(e).__name__}: {e}), so it cannot enter a CUDA kernel; run "
            f"the ring on a CPU tensor, where the plain versions call its "
            f"Python callables") from e
    env = {}
    n_args = 0
    out = None

    def val(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, bool):
            return ("bconst", a)
        if isinstance(a, (int, float)):
            return ("const", f32_bits(a))
        if isinstance(a, torch.dtype):
            if a != torch.float32:
                raise _off_menu(f"a cast to {a} in its {what}", ring)
            return _DTYPE
        raise _off_menu(f"the operand {a!r} in its {what}", ring)

    def flt(e):
        if e is _DTYPE:
            raise _off_menu(f"a dtype used as a value in its {what}", ring)
        return ("float", e) if kind(e) == "b" else e

    def boolean(e):
        if e is _DTYPE or kind(e) != "b":
            raise _off_menu(f"a logical operation on float values in its {what}",
                            ring)
        return e

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = ("arg", n_args)
            n_args += 1
            continue
        if node.op == "output":
            out = val(node.args[0]) if isinstance(node.args[0], torch.fx.Node) \
                else None
            if out is None or out is _DTYPE:
                raise _off_menu(f"the result {node.args[0]!r} of its {what}", ring)
            continue
        if node.op == "get_attr":
            t = gm
            for part in node.target.split("."):
                t = getattr(t, part)
            if not isinstance(t, torch.Tensor) or t.numel() != 1 or t.dim() != 0:
                raise _off_menu(f"the constant {node.target} (not a 0-d tensor) "
                                f"in its {what}", ring)
            env[node] = (("bconst", bool(t)) if t.dtype == torch.bool
                         else ("const", f32_bits(float(t))))
            continue
        target = node.target
        args = list(node.args)
        kw = dict(node.kwargs)
        if node.op == "call_function" and target is getattr:
            if args[1] != "dtype":
                raise _off_menu(f"the attribute .{args[1]} in its {what}", ring)
            env[node] = _DTYPE
            continue
        if node.op == "call_function" and target is torch.promote_types:
            if any(val(a) is not _DTYPE for a in args):
                raise _off_menu(f"torch.promote_types of a constant dtype in "
                                f"its {what}", ring)
            env[node] = _DTYPE
            continue
        if node.op not in ("call_function", "call_method"):
            raise _off_menu(f"the {node.op} node {target!r} in its {what}", ring)
        if node.op == "call_method" and target in ("to", "type", "float"):
            dt = kw.pop("dtype", args[1] if len(args) > 1 else torch.float32)
            if target == "float":
                dt = torch.float32
            if len(args) > 2 or kw or val(dt) is not _DTYPE:
                raise _off_menu(f"the call .{target}{tuple(args[1:])} in its {what}",
                                ring)
            env[node] = flt(val(args[0]))
            continue
        if target in _CLAMPS:
            op = _CLAMPS[target]
            rest = args[1:]
            if op == "clamp_max":
                rest = [None] + rest
            lo = kw.pop("min", rest[0] if len(rest) > 0 else None)
            hi = kw.pop("max", rest[1] if len(rest) > 1 else None)
            if kw or len(rest) > 2 or (lo is None and hi is None):
                raise _off_menu(f"{_name(target)}{tuple(args[1:])} in its {what}", ring)
            x = flt(val(args[0]))
            if lo is not None:
                x = ("clamp_min", x, flt(val(lo)))
            if hi is not None:
                x = ("clamp_max", x, flt(val(hi)))
            env[node] = x
            continue
        if target in (torch.where, "where") and len(args) == 3 and not kw:
            env[node] = ("where", boolean(val(args[0])), flt(val(args[1])),
                         flt(val(args[2])))
            continue
        if target in _BINARY and len(args) == 2 and not kw:
            op = _BINARY[target]
            a, b = val(args[0]), val(args[1])
            if op in ("and", "or"):
                env[node] = (op, boolean(a), boolean(b))
            else:
                env[node] = (op, flt(a), flt(b))
            continue
        if target in _UNARY and len(args) == 1 and not kw:
            op = _UNARY[target]
            a = val(args[0])
            env[node] = ("not", boolean(a)) if op == "not" else (op, flt(a))
            continue
        raise _off_menu(_name(target), ring)
    if n_args != 2:
        raise _off_menu(f"a {what} of {n_args} arguments (it takes 2)", ring)
    return flt(out)


def trace_ring(sr) -> Traced:
    """The expression trees of the ring `sr`'s combine and reduce and its
    identity's float32 bits. Raises NotImplementedError where `sr` leaves
    the menu or does not trace."""
    try:
        ident = f32_bits(float(sr.initialize()))
    except Exception as e:  # noqa: BLE001 - any failure is the same refusal
        raise NotImplementedError(
            f"semiring {sr.name!r}: its initialize() gives no number ({e}); "
            f"run the ring on a CPU tensor") from e
    return Traced(sr.name, ident, _trace_fn(sr.combine, sr.name, "combine"),
                  _trace_fn(sr.reduce, sr.name, "reduce"))


def c_literal(bits: int) -> str:
    """A float32 literal: ±inf and NaN by bit pattern, else a hex float."""
    v = struct.unpack("<f", struct.pack("<I", bits))[0]
    if not np.isfinite(v):
        return f"__int_as_float(0x{bits:08x})"
    return f"{float(v).hex()}f"


def _emit(e, lines: list, memo: dict) -> str:
    """The C++ name of e's value, its statements appended to `lines`."""
    key = id(e)
    if key in memo:
        return memo[key]
    op = e[0]
    if op == "arg":
        return f"a{e[1]}"
    if op == "const":
        return c_literal(e[1])
    if op == "bconst":
        return "true" if e[1] else "false"
    a = [_emit(x, lines, memo) for x in e[1:]]
    if op in _C_OPS:
        expr = f"{_C_OPS[op]}({a[0]}, {a[1]})"
    elif op in _C_CMPS:
        expr = f"({a[0]} {_C_CMPS[op]} {a[1]})"
    elif op == "and":
        expr = f"({a[0]} && {a[1]})"
    elif op == "or":
        expr = f"({a[0]} || {a[1]})"
    elif op == "not":
        expr = f"(!{a[0]})"
    elif op == "neg":
        expr = f"(-{a[0]})"
    elif op == "abs":
        expr = f"fabsf({a[0]})"
    elif op == "clamp_min":  # torch.clamp: x unless x < lo; a NaN bound wins
        expr = f"(({a[1]} != {a[1]} || {a[0]} < {a[1]}) ? {a[1]} : {a[0]})"
    elif op == "clamp_max":
        expr = f"(({a[1]} != {a[1]} || {a[0]} > {a[1]}) ? {a[1]} : {a[0]})"
    elif op == "where":
        expr = f"({a[0]} ? {a[1]} : {a[2]})"
    elif op == "float":
        expr = f"({a[0]} ? 1.f : 0.f)"
    else:  # pragma: no cover - trace_ring builds no other node
        raise AssertionError(op)
    name = f"t{len(lines)}"
    lines.append(f"    const {'bool' if kind(e) == 'b' else 'float'} {name} = {expr};")
    memo[key] = name
    return name


def _method(name: str, tree: tuple) -> str:
    lines: list = []
    res = _emit(tree, lines, {})
    body = "\n".join(lines + [f"    return {res};"])
    return (f"  static __device__ __forceinline__ float {name}(float a0, float a1) {{\n"
            f"{body}\n  }}")


def ring_header(sr) -> str:
    """The CUDA header that makes `sr` Ring<SPMV_RING_USER>. Raises
    NotImplementedError where `sr` leaves the menu."""
    t = trace_ring(sr)
    return "\n".join([
        f"// Generated by spmv_tpu_torch/ops/ring_codegen.py for the user-defined",
        f"// semiring {t.name!r}: combine(a0 = a_ij, a1 = x_j), reduce(a0 = earlier,",
        f"// a1 = later), in float32.",
        "#pragma once",
        "#define SPMV_RING_USER 5",
        '#include "ring.cuh"',
        "",
        "template <>",
        "struct Ring<SPMV_RING_USER> {",
        f"  static __device__ __forceinline__ float identity() {{ return "
        f"{c_literal(t.identity)}; }}",
        _method("combine", t.combine),
        _method("reduce", t.reduce),
        "};",
        "",
    ])
