"""Integer-range abstract interpretation over traced torch graphs.

Counterpart of `hefl_tpu.analysis.ranges`. The packed-quantized CKKS
pipeline rests on arithmetic invariants: the carry-free headroom
`field_bits = b + ceil(log2 C)`, the guard band that absorbs decrypt noise,
the 2**62 exact-integer ceiling of the hi/lo split, the q/2 wall of the
centred decode, the no-wrap bound of the lazy sum and of the fold. This
module proves them for ALL inputs by interval abstract interpretation of
the port's own code, traced, so a refactor that widens a shift is refuted
rather than shipped:

  * :class:`Interval` — the abstract domain: one [lo, hi] pair per value,
    exact Python ints for integer dtypes (no 64-bit ceiling in the
    analysis, which is how an op that would overflow int64 is caught rather
    than wrapped), floats with ±inf for float dtypes.
  * :func:`trace_graph` — `torch.fx.experimental.proxy_tensor.make_fx` in
    "fake" mode: the probe's aten ops are recorded on FakeTensors, so
    tracing runs nothing on the device (a shift by 70, the point of an
    unsafe geometry, traces as well as a safe one) and costs the same on a
    card as on the CPU. Loops are PyTorch's loop operators,
    `torch._higher_order_ops.while_loop` and `.scan` (the counterparts of
    `lax.while_loop` and `lax.scan`), recorded with their bodies as
    sub-GraphModules; `torch.cond` has the JAX `cond` branch semantics.
    Constants reach the graph as `get_attr` nodes and their intervals are
    read from the tensor.
  * :func:`eval_graph_ranges` — the interpreter. Each aten op is evaluated
    as the sequence of jaxpr primitives `jax.numpy` lowers the same
    operation to (`x % p`: the divisor's zero guard, `rem` and the
    floor-sign correction; `index_select`: the index wrap and a `gather`;
    `x[j]`: `slice` + `squeeze`), each with the JAX interpreter's transfer
    function. So a finding names the JAX primitive (`RangeFinding.op`) and
    the position (`eqn_index`) the JAX interpreter reports for the same
    program, and the output intervals, loop reports and findings compare
    across the two packages. An unsupported op yields an unbounded
    interval and a note (sound: it can only cause false alarms).
  * loop fixpoints — a `scan` with a static trip count up to
    :data:`SCAN_EXACT_LIMIT` is iterated exactly; longer scans and every
    `while_loop` join iterates and, after :data:`WIDEN_DELAY` unstable
    rounds, widen the moving bounds up a threshold ladder (declared ceiling
    -> dtype bounds -> ±inf), then take one narrowing pass. A final AUDITED
    body pass at the proven invariant emits the findings, so a carry that
    can grow past a ceiling cites the op inside the loop. A while condition
    of the shape `carry OP bound` refines the carry on entry (and, negated,
    on exit). Every loop adds a :class:`LoopReport`.
  * the certifiers (`certify_packing`, `certify_aggregation`,
    `certify_fold_inductive`, `certify_fold_tree`, `certify_inference`,
    `certify_keyswitch`, `certify_transciphering`), each tracing the
    range probe its module exports and checking the JAX certificate's
    bounds, with its fields, checks and messages.

The wrapping Montgomery cores and the kernels are not range-probed: the
probes mirror their canonical-residue contract with `%` standing in for
REDC, and the kernels are held bitwise against their plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import operator
from typing import Any

import torch

_POS_INF = float("inf")
_NEG_INF = float("-inf")

# Loop-fixpoint knobs (the JAX module's). A scan with static length <= the
# exact limit is iterated exactly; longer scans and every while_loop go
# through join-then-widen. WIDEN_DELAY is how many unstable joined
# iterations to observe before widening a moving bound.
SCAN_EXACT_LIMIT = 4096
WIDEN_DELAY = 3
# The declared iteration-count ceiling the loop probes certify against
# ("any arrival count / ladder depth up to 2**48").
LOOP_COUNT_CEILING = 1 << 48
# `parallel.collectives.MAX_PSUM_CLIENTS` (the JAX package's), restated: the canonical
# residues one lazy sum adds before its single reduction.
MAX_PSUM_CLIENTS = 32


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi]; ints stay exact Python ints (unbounded)."""

    lo: Any
    hi: Any

    def __post_init__(self):
        if self.lo > self.hi:  # pragma: no cover - internal invariant
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def __repr__(self):
        return f"[{_fmt(self.lo)}, {_fmt(self.hi)}]"


TOP = Interval(_NEG_INF, _POS_INF)
BOOL = Interval(0, 1)
_TRUE = Interval(1, 1)
_FALSE = Interval(0, 0)
_ZERO = Interval(0, 0)


def _compare(name: str, a: Interval, b: Interval):
    """[1,1] / [0,0] when the comparison is decided by the intervals,
    None when it is not."""
    if name == "lt":
        if a.hi < b.lo:
            return _TRUE
        if a.lo >= b.hi:
            return _FALSE
    elif name == "le":
        if a.hi <= b.lo:
            return _TRUE
        if a.lo > b.hi:
            return _FALSE
    elif name == "gt":
        if a.lo > b.hi:
            return _TRUE
        if a.hi <= b.lo:
            return _FALSE
    elif name == "ge":
        if a.lo >= b.hi:
            return _TRUE
        if a.hi < b.lo:
            return _FALSE
    elif name == "eq":
        if a.hi < b.lo or a.lo > b.hi:
            return _FALSE
        if a.lo == a.hi == b.lo == b.hi:
            return _TRUE
    elif name == "ne":
        if a.hi < b.lo or a.lo > b.hi:
            return _TRUE
        if a.lo == a.hi == b.lo == b.hi:
            return _FALSE
    return None


def _fmt(v) -> str:
    """Log-friendly bound: huge exact ints print as 2**k, not 40 digits."""
    if isinstance(v, int) and abs(v) >= 1 << 40:
        sign = "-" if v < 0 else ""
        a = abs(v)
        if a & (a - 1) == 0:
            return f"{sign}2**{a.bit_length() - 1}"
        if (a + 1) & a == 0:
            return f"{sign}(2**{a.bit_length()}-1)"
        return f"{sign}~2**{a.bit_length() - 1}"
    return str(v)


@dataclasses.dataclass(frozen=True)
class RangeFinding:
    """One op whose statically derived range violates a declared bound."""

    kind: str        # "ceiling" | "dtype-overflow" | "output-bound"
    op: str          # the JAX primitive the op lowers to (or the aten op)
    eqn_index: int   # position in the flattened primitive walk
    interval: Interval
    bound: Interval
    message: str

    def __str__(self):
        return self.message


@dataclasses.dataclass(frozen=True)
class LoopReport:
    """How one scan/while reached its post-fixpoint (always sound: TOP is a
    post-fixpoint; `widened` records that precision was traded)."""

    op: str            # "scan" | "while"
    eqn_index: int     # position in the flattened primitive walk
    mode: str          # "exact" (static trip count iterated) | "fixpoint"
    length: int | None # static trip count for scans, None for while
    rounds: int        # abstract body iterations evaluated
    widened: bool      # the threshold-ladder widening fired
    narrowed: bool     # the narrowing pass tightened the invariant


@dataclasses.dataclass
class RangeResult:
    out_intervals: list
    findings: list
    notes: list      # non-fatal analysis caveats (unsupported ops, ...)
    loops: list = dataclasses.field(default_factory=list)    # LoopReports
    out_ops: list = dataclasses.field(default_factory=list)  # op producing each output


def _contains(outer: Interval, inner: Interval) -> bool:
    return outer.lo <= inner.lo and outer.hi >= inner.hi


_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
               torch.uint16, torch.uint32, torch.uint64)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _is_int_dtype(dtype) -> bool:
    return dtype in _INT_DTYPES


def _dtype_interval(dtype) -> Interval:
    info = torch.iinfo(dtype)
    return Interval(int(info.min), int(info.max))


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _mul_bound(a, b):
    if a == 0 or b == 0:
        return 0
    return a * b


def _imul(a: Interval, b: Interval) -> Interval:
    cands = [
        _mul_bound(a.lo, b.lo), _mul_bound(a.lo, b.hi),
        _mul_bound(a.hi, b.lo), _mul_bound(a.hi, b.hi),
    ]
    return Interval(min(cands), max(cands))


def _pow2_shift(x: Interval, s: Interval) -> Interval:
    """x << s as x * 2**s (mathematical, never wrapping)."""
    s_lo = max(int(s.lo), 0) if s.lo != _NEG_INF else 0
    if s.hi == _POS_INF:
        return TOP
    return _imul(x, Interval(1 << s_lo, 1 << int(s.hi)))


def _floordiv_pow2(x: Interval, s: Interval) -> Interval:
    s_lo = max(int(s.lo), 0) if s.lo != _NEG_INF else 0
    s_hi = int(s.hi) if s.hi != _POS_INF else s_lo
    cands = []
    for v in (x.lo, x.hi):
        for sh in (s_lo, s_hi):
            if v in (_NEG_INF, _POS_INF):
                cands.append(v)
            else:
                cands.append(math.floor(v / (1 << sh)))
    return Interval(min(cands), max(cands))


def _bitwise(a: Interval, b: Interval, dtype) -> Interval:
    """and/or/xor bound for non-negative operands; dtype range otherwise."""
    if a.lo >= 0 and b.lo >= 0 and a.hi != _POS_INF and b.hi != _POS_INF:
        bits = max(int(a.hi).bit_length(), int(b.hi).bit_length())
        return Interval(0, (1 << bits) - 1)
    return _dtype_interval(dtype) if _is_int_dtype(dtype) else TOP


def _array_interval(x) -> Interval:
    """The interval of a constant: a (real) tensor or a Python scalar."""
    if isinstance(x, torch.Tensor):
        arr = x.detach().cpu()
        if arr.numel() == 0:
            return Interval(0, 0)
        if arr.dtype == torch.bool or _is_int_dtype(arr.dtype):
            flat = arr.reshape(-1).tolist()
            return Interval(int(min(flat)), int(max(flat)))
        return Interval(float(arr.min()), float(arr.max()))
    if isinstance(x, bool):
        return Interval(int(x), int(x))
    if isinstance(x, int):
        return Interval(x, x)
    return Interval(float(x), float(x))


def trace_graph(fn, args) -> torch.fx.GraphModule:
    """`fn(*args)` as an aten GraphModule, traced on FakeTensors (nothing
    runs on the device; constants the function closes over stay real and
    become `get_attr` nodes)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)


def _meta(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _dtype_of(node):
    val = _meta(node)
    if isinstance(val, torch.Tensor):
        return val.dtype
    if isinstance(node, bool):
        return torch.bool
    if isinstance(node, int):
        return torch.int64
    if isinstance(node, float):
        return torch.float32
    return None


def _ndim(node) -> int:
    val = _meta(node)
    return val.dim() if isinstance(val, torch.Tensor) else 0


def _numel(node) -> int:
    val = _meta(node)
    return int(val.numel()) if isinstance(val, torch.Tensor) else 1


def _fetch_attr(gm, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


@functools.cache
def _higher_order_ops() -> dict:
    """{op: "while" | "scan" | "cond"} for PyTorch's loop and branch
    operators, the counterparts of the JAX primitives."""
    ho = torch.ops.higher_order
    return {getattr(ho, name): prim
            for name, prim in (("while_loop", "while"), ("scan", "scan"), ("cond", "cond"))
            if hasattr(ho, name)}


# aten comparisons -> the JAX primitive (cond refiners and lowering).
_COMPARE = {"eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge"}


class _RangeInterpreter:
    def __init__(self, ceiling: Interval | None, check_dtype: bool,
                 axis_sizes: dict | None = None):
        self.ceiling = ceiling
        self.check_dtype = check_dtype
        self.axis_sizes = dict(axis_sizes or {})
        self.findings: list[RangeFinding] = []
        self.notes: list[str] = []
        self.loops: list[LoopReport] = []
        self.counter = 0
        self._quiet = 0
        self._note_seen: set[str] = set()
        self._last_prim = "input"

    @contextlib.contextmanager
    def _quieted(self):
        """Suppress findings/notes/loop reports during the exploratory
        fixpoint iterations; the AUDITED pass at the proven invariant is the
        one that reports, so each in-loop violation fires once."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _note(self, msg: str) -> None:
        if self._quiet or msg in self._note_seen:
            return
        self._note_seen.add(msg)
        self.notes.append(msg)

    def _report_loop(self, rep: LoopReport) -> None:
        if not self._quiet:
            self.loops.append(rep)

    # -- one primitive ----------------------------------------------------
    def _check(self, name: str, out: Interval, dtype) -> None:
        if self._quiet or not _is_int_dtype(dtype):
            return
        finding = None
        if self.ceiling is not None and (
            out.lo < self.ceiling.lo or out.hi > self.ceiling.hi
        ):
            finding = RangeFinding(
                kind="ceiling", op=name, eqn_index=self.counter,
                interval=out, bound=self.ceiling,
                message=(
                    f"`{name}` (eqn {self.counter}) produces values in "
                    f"{out}, outside the declared exact-integer ceiling "
                    f"{self.ceiling}"
                ),
            )
        elif self.check_dtype:
            drange = _dtype_interval(dtype)
            if out.lo < drange.lo or out.hi > drange.hi:
                finding = RangeFinding(
                    kind="dtype-overflow", op=name, eqn_index=self.counter,
                    interval=out, bound=drange,
                    message=(
                        f"`{name}` (eqn {self.counter}) produces values in "
                        f"{out}, wrapping its {_dtype_name(dtype)} carrier {drange}"
                    ),
                )
        # A multi-output op (loop carries) can derive the identical finding
        # per output; report it once.
        if finding is not None and finding not in self.findings[-4:]:
            self.findings.append(finding)

    def _emit(self, name: str, ins: list, dtype, **params) -> Interval:
        """Evaluate one JAX primitive on intervals, check it, count it."""
        try:
            out = self._transfer(name, ins, dtype, params)
        except Exception as e:  # a handler hole must not kill the analysis
            self._note(f"`{name}`: interval evaluation failed "
                       f"({type(e).__name__}: {e}); output unbounded")
            out = TOP
        self._check(name, out, dtype)
        self.counter += 1
        self._last_prim = name
        return out

    def _transfer(self, name: str, ins: list, dtype, params: dict) -> Interval:
        """The JAX interpreter's transfer function of one primitive."""
        a = ins[0] if ins else TOP
        b = ins[1] if len(ins) > 1 else None
        if name == "add":
            return Interval(a.lo + b.lo, a.hi + b.hi)
        if name == "sub":
            return Interval(a.lo - b.hi, a.hi - b.lo)
        if name == "mul":
            return _imul(a, b)
        if name == "neg":
            return Interval(-a.hi, -a.lo)
        if name == "abs":
            lo = 0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
            return Interval(lo, max(abs(a.lo), abs(a.hi)))
        if name == "max":
            return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
        if name == "min":
            return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
        if name == "div":
            if b.lo <= 0 <= b.hi:
                return TOP
            cands = [a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi]
            return Interval(min(cands), max(cands))
        if name == "rem":
            if a.lo >= 0 and b.lo > 0 and b.hi != _POS_INF:
                # Non-negative dividend, positive divisor: the canonical
                # residue case; rem < b and rem <= a.
                hi = b.hi - 1
                if a.hi != _POS_INF:
                    hi = min(hi, a.hi)
                return Interval(0, hi)
            if b.lo in (_NEG_INF,) or b.hi in (_POS_INF,):
                return TOP
            m = max(abs(b.lo), abs(b.hi))
            return Interval(-m, m)
        if name == "integer_pow":
            p = int(params.get("y", 2))
            cands = [x**p for x in (a.lo, a.hi) if x not in (_NEG_INF, _POS_INF)]
            if not cands:
                return TOP
            if p % 2 == 0 and a.lo <= 0 <= a.hi:
                cands.append(0)
            return Interval(min(cands), max(cands))
        if name in ("floor", "ceil", "round"):
            lo = a.lo if a.lo in (_NEG_INF,) else math.floor(a.lo)
            hi = a.hi if a.hi in (_POS_INF,) else math.ceil(a.hi)
            return Interval(lo, hi)
        if name == "sign":
            return Interval(-1, 1)
        if name == "shift_left":
            return _pow2_shift(a, b)
        if name == "shift_right_arithmetic":
            return _floordiv_pow2(a, b)
        if name == "shift_right_logical":
            if a.lo >= 0:
                return _floordiv_pow2(a, b)
            return _dtype_interval(dtype)
        if name == "and":
            # x & y <= min(x, y) for non-negative operands: one bounded
            # non-negative side caps the result (the mask idiom).
            caps = [x.hi for x in (a, b) if x.lo >= 0 and x.hi != _POS_INF]
            if caps:
                return Interval(0, min(caps))
            return _bitwise(a, b, dtype)
        if name in ("or", "xor"):
            return _bitwise(a, b, dtype)
        if name == "not":
            return _dtype_interval(dtype) if _is_int_dtype(dtype) else BOOL
        if name == "select_n":
            pred, cases = ins[0], ins[1:]
            # Dead-branch elimination: a predicate the comparisons proved
            # constant selects exactly one case (what keeps the remainder's
            # sign correction, dead for canonical operands, out of the bound).
            if (pred.lo == pred.hi and isinstance(pred.lo, int)
                    and 0 <= pred.lo < len(cases)):
                return cases[pred.lo]
            out = cases[0]
            for case in cases[1:]:
                out = out.union(case)
            return out
        if name == "convert_element_type":
            if dtype == torch.bool:
                return BOOL
            if _is_int_dtype(dtype) and not isinstance(a.lo, int):
                lo = a.lo if a.lo == _NEG_INF else math.floor(a.lo)
                hi = a.hi if a.hi == _POS_INF else math.ceil(a.hi)
                return Interval(lo, hi)
            return a
        if name == "psum":
            n = params["n"]
            return Interval(_mul_bound(n, a.lo), _mul_bound(n, a.hi))
        if name == "reduce_sum":
            n = int(params["n"])
            return Interval(_mul_bound(n, a.lo), _mul_bound(n, a.hi))
        if name == "cumsum":
            n = int(params["n"])
            return Interval(_mul_bound(n, min(a.lo, 0)), _mul_bound(n, max(a.hi, 0)))
        if name in ("reduce_max", "reduce_min"):
            return a
        if name in ("broadcast_in_dim", "reshape", "squeeze", "transpose", "slice",
                    "rev", "gather", "copy"):
            return a
        if name == "concatenate":
            out = ins[0]
            for iv in ins[1:]:
                out = out.union(iv)
            return out
        if name == "iota":
            return Interval(0, max(int(params["n"]) - 1, 0))
        if name in _COMPARE:
            verdict = _compare(name, a, b)
            return verdict if verdict is not None else BOOL
        if name == "is_finite":
            return BOOL
        raise NotImplementedError(name)  # pragma: no cover - lowering drift

    # -- aten ops as their jnp lowerings ----------------------------------
    def _iv(self, env, x) -> Interval:
        if isinstance(x, torch.fx.Node):
            return env[x]
        if x is None:
            return TOP
        return _array_interval(x)

    def _lit_or_broadcast(self, env, x, dtype) -> Interval:
        """A Python scalar operand that jnp broadcasts to an array shape
        first (jnp.where's scalar cases)."""
        if isinstance(x, torch.fx.Node):
            return env[x]
        return self._emit("broadcast_in_dim", [_array_interval(x)], dtype)

    def _remainder(self, env, node, x, d) -> Interval:
        """jnp.remainder: the divisor's zero guard (a broadcast of the 1 for
        an array divisor), rem, and the floor-sign correction."""
        dt = _dtype_of(node)
        div = self._iv(env, d)
        is_zero = self._emit("eq", [div, _ZERO], torch.bool)
        one = Interval(1, 1)
        if _ndim(d) > 0:
            one = self._emit("broadcast_in_dim", [one], dt)
        div = self._emit("select_n", [is_zero, div, one], dt)
        r = self._emit("rem", [self._iv(env, x), div], dt)
        nonzero = self._emit("ne", [r, _ZERO], torch.bool)
        r_neg = self._emit("lt", [r, _ZERO], torch.bool)
        d_neg = self._emit("lt", [div, _ZERO], torch.bool)
        signs = self._emit("ne", [r_neg, d_neg], torch.bool)
        fix = self._emit("and", [signs, nonzero], torch.bool)
        plus = self._emit("add", [r, div], dt)
        return self._emit("select_n", [fix, r, plus], dt)

    def _floor_divide(self, env, node, x, d) -> Interval:
        """jnp.floor_divide on integers: div, the sign test, rem, and the
        round-toward-minus-infinity correction."""
        dt = _dtype_of(node)
        a, b = self._iv(env, x), self._iv(env, d)
        q = self._emit("div", [a, b], dt)
        sa = self._emit("sign", [a], dt)
        sb = self._emit("sign", [b], dt)
        differ = self._emit("ne", [sa, sb], torch.bool)
        r = self._emit("rem", [a, b], dt)
        inexact = self._emit("ne", [r, _ZERO], torch.bool)
        fix = self._emit("and", [differ, inexact], torch.bool)
        q1 = self._emit("sub", [q, Interval(1, 1)], dt)
        return self._emit("select_n", [fix, q, q1], dt)

    def _take(self, env, x, dim, index, out_dtype) -> Interval:
        """jnp.take(x, index, axis): wrap negative indices, then gather."""
        it = _dtype_of(index)
        idx = self._iv(env, index)
        size = int(_meta(x).shape[dim])
        neg = self._emit("lt", [idx, _ZERO], torch.bool)
        wrapped = self._emit("add", [idx, Interval(size, size)], it)
        idx = self._emit("select_n", [neg, idx, wrapped], it)
        idx = self._emit("broadcast_in_dim", [idx], it)
        return self._emit("gather", [self._iv(env, x), idx], out_dtype)

    def _eval_aten(self, env, node) -> Interval:
        name = node.target.overloadpacket.__name__
        args = list(node.args)
        kw = dict(node.kwargs)
        dt = _dtype_of(node)
        iv = functools.partial(self._iv, env)
        simple = {
            "add": "add", "sub": "sub", "mul": "mul", "maximum": "max", "minimum": "min",
            "bitwise_and": "and", "__and__": "and", "logical_and": "and",
            "bitwise_or": "or", "__or__": "or", "logical_or": "or",
            "bitwise_xor": "xor", "__xor__": "xor", "__lshift__": "shift_left",
            "bitwise_left_shift": "shift_left",
        }
        if name in ("add", "sub") and kw.get("alpha", 1) != 1:
            b = self._emit("mul", [iv(args[1]), _array_interval(kw["alpha"])], dt)
            return self._emit(simple[name], [iv(args[0]), b], dt)
        if name in simple:
            return self._emit(simple[name], [iv(args[0]), iv(args[1])], dt)
        if name == "rsub":
            return self._emit("sub", [iv(args[1]), iv(args[0])], dt)
        if name in ("__rshift__", "bitwise_right_shift"):
            prim = ("shift_right_logical" if dt in _UNSIGNED
                    else "shift_right_arithmetic")
            return self._emit(prim, [iv(args[0]), iv(args[1])], dt)
        if name in ("neg", "abs", "sign", "round", "floor", "ceil"):
            return self._emit(name, [iv(args[0])], dt)
        if name in ("bitwise_not", "logical_not"):
            return self._emit("not", [iv(args[0])], dt)
        if name in _COMPARE:
            return self._emit(_COMPARE[name], [iv(args[0]), iv(args[1])], torch.bool)
        if name == "where":
            cond = iv(args[0])
            x = self._lit_or_broadcast(env, args[1], dt)
            y = self._lit_or_broadcast(env, args[2], dt)
            return self._emit("select_n", [cond, y, x], dt)
        if name in ("clamp", "clamp_min", "clamp_max"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            out = iv(args[0])
            if lo is not None:
                out = self._emit("max", [iv(lo), out], dt)
            if hi is not None:
                out = self._emit("min", [iv(hi), out], dt)
            return out
        if name == "div":
            mode = kw.get("rounding_mode")
            if mode == "floor" and _is_int_dtype(dt):
                return self._floor_divide(env, node, args[0], args[1])
            if mode is None:
                return self._emit("div", [iv(args[0]), iv(args[1])], dt)
        if name == "remainder":
            return self._remainder(env, node, args[0], args[1])
        if name == "floor_divide":
            return self._floor_divide(env, node, args[0], args[1])
        if name == "pow" and isinstance(args[1], int) and not isinstance(args[1], bool):
            return self._emit("integer_pow", [iv(args[0])], dt, y=args[1])
        if name in ("_to_copy", "to", "type_as", "_convert_element_type"):
            src = _dtype_of(args[0])
            if dt == src:
                return iv(args[0])
            return self._emit("convert_element_type", [iv(args[0])], dt)
        if name in ("sum", "cumsum"):
            x = iv(args[0])
            want = kw.get("dtype")
            if want is not None and want != _dtype_of(args[0]):
                x = self._emit("convert_element_type", [x], want)
            if name == "cumsum":
                return self._emit("cumsum", [x], dt, n=_numel(args[0]))
            n = max(_numel(args[0]) // max(_numel(node), 1), 1)
            return self._emit("reduce_sum", [x], dt, n=n)
        if name == "all_reduce" and args[1] == "sum":
            # A sum over a process group: the operand times the group's
            # declared worst-case size, as the JAX interpreter's psum.
            size = self.axis_sizes.get(args[2])
            if size is None:
                self._note(f"all_reduce over group {args[2]!r} with undeclared size: "
                           "output unbounded (pass axis_sizes)")
                return self._emit_top("psum", node)
            return self._emit("psum", [iv(args[0])], dt, n=int(size))
        if name == "wait_tensor":
            return iv(args[0])
        if name in ("amax", "amin"):
            return self._emit("reduce_max" if name == "amax" else "reduce_min",
                              [iv(args[0])], dt)
        if name == "index_select":
            dim = args[1] % max(_ndim(args[0]), 1)
            return self._take(env, args[0], dim, args[2], dt)
        if name == "index":
            picks = [(d, i) for d, i in enumerate(args[1]) if i is not None]
            if len(picks) == 1 and _ndim(picks[0][1]) == 1 and _dtype_of(picks[0][1]) in (
                    torch.int32, torch.int64):
                return self._take(env, args[0], picks[0][0], picks[0][1], dt)
        if name == "select":
            out = self._emit("slice", [iv(args[0])], dt)
            return self._emit("squeeze", [out], dt)
        if name in ("slice", "narrow"):
            return self._emit("slice", [iv(args[0])], dt)
        if name in ("view", "reshape", "_unsafe_view", "flatten"):
            return self._emit("reshape", [iv(args[0])], dt)
        if name in ("expand", "unsqueeze", "broadcast_to"):
            return self._emit("broadcast_in_dim", [iv(args[0])], dt)
        if name in ("permute", "transpose", "t"):
            return self._emit("transpose", [iv(args[0])], dt)
        if name == "squeeze":
            return self._emit("squeeze", [iv(args[0])], dt)
        if name == "flip":
            return self._emit("rev", [iv(args[0])], dt)
        if name in ("clone", "alias", "detach", "lift_fresh_copy", "contiguous"):
            return iv(args[0])
        if name == "cat":
            return self._emit("concatenate", [iv(t) for t in args[0]], dt)
        if name == "stack":
            parts = [self._emit("broadcast_in_dim", [iv(t)], dt) for t in args[0]]
            return self._emit("concatenate", parts, dt)
        fills = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1, "ones_like": 1,
                 "new_ones": 1}
        if name in fills or name in ("full", "full_like", "new_full", "scalar_tensor"):
            if name in fills:
                value = fills[name]
            else:
                value = args[0] if name == "scalar_tensor" else args[1]
            value = _array_interval(value)
            if _ndim(node) == 0:
                return value
            return self._emit("broadcast_in_dim", [value], dt)
        if name == "arange" and len(args) == 1:
            return self._emit("iota", [], dt, n=int(args[0]))
        if name == "isfinite":
            return self._emit("is_finite", [iv(args[0])], torch.bool)
        self._note(f"unsupported op `aten.{name}`: output unbounded")
        return self._emit_top(f"aten.{name}", node)

    def _emit_top(self, name: str, node) -> Interval:
        self._check(name, TOP, _dtype_of(node))
        self.counter += 1
        self._last_prim = name
        return TOP

    # -- loop fixpoints ---------------------------------------------------
    def _widen(self, joined: Interval, prev: Interval, dtype) -> Interval:
        """Escalate whichever bound is still moving up the threshold ladder:
        declared ceiling -> dtype bounds -> ±inf. Each unstable round
        strictly climbs the finite ladder, so the fixpoint loop terminates;
        a carry pushed past its dtype threshold is exactly the loop overflow
        the audited pass then reports."""
        los: list = []
        his: list = []
        if self.ceiling is not None:
            los.append(self.ceiling.lo)
            his.append(self.ceiling.hi)
        if dtype is not None and _is_int_dtype(dtype):
            d = _dtype_interval(dtype)
            los.append(d.lo)
            his.append(d.hi)
        lo, hi = joined.lo, joined.hi
        if joined.lo < prev.lo:
            cands = [t for t in los if t <= joined.lo]
            lo = max(cands) if cands else _NEG_INF
        if joined.hi > prev.hi:
            cands = [t for t in his if t >= joined.hi]
            hi = min(cands) if cands else _POS_INF
        return Interval(lo, hi)

    def _loop_fixpoint(self, body, init, dtypes, refine):
        """Join-iterate `body` over the carried intervals to a post-fixpoint
        (body(carry) ⊆ carry), widening after WIDEN_DELAY unstable rounds,
        then one narrowing pass re-anchored at the initial carry.
        -> (invariant, rounds, widened, narrowed)."""
        carry = list(init)
        widened = narrowed = False
        rounds = 0
        max_rounds = WIDEN_DELAY + 8

        def step(c):
            entry = refine(c) if refine is not None else c
            if entry is None:       # refinement contradicts: body dead
                return None
            with self._quieted():
                return body(entry)[:len(init)]

        while True:
            out = step(carry)
            rounds += 1
            if out is None or all(_contains(c, o) for c, o in zip(carry, out)):
                break               # post-fixpoint reached
            joined = [c.union(o) for c, o in zip(carry, out)]
            if rounds >= WIDEN_DELAY:
                joined = [
                    j if _contains(c, j) else self._widen(j, c, d)
                    for j, c, d in zip(joined, carry, dtypes)
                ]
                widened = True
            carry = joined
            if rounds >= max_rounds:  # pragma: no cover - ladder backstop
                carry = [TOP for _ in init]
                widened = True
                break
        out = step(carry)
        if out is not None:
            cand = [i.union(o) for i, o in zip(init, out)]
            if any(n.lo > c.lo or n.hi < c.hi for n, c in zip(cand, carry)) and all(
                _contains(c, n) for c, n in zip(carry, cand)
            ):
                out2 = step(cand)
                if out2 is not None and all(
                    _contains(n, i.union(o)) for n, i, o in zip(cand, init, out2)
                ):
                    carry = cand
                    narrowed = True
        return carry, rounds, widened, narrowed

    def _eval_scan(self, env, gm, node):
        args = node.args
        combine = _fetch_attr(gm, args[0].target)
        init = [env[n] for n in args[1]]
        xs_nodes = list(args[2])
        xs = [env[n] for n in xs_nodes]
        extra = [env[n] if isinstance(n, torch.fx.Node) else _array_interval(n)
                 for n in (args[-1] if len(args) > 3 else ())]
        ncar = len(init)
        length = int(_meta(xs_nodes[0]).shape[0]) if xs_nodes else None
        outs_meta = _meta(node)
        n_ys = len(outs_meta) - ncar
        dtypes = [v.dtype for v in outs_meta[:ncar]]

        def body(c):
            return self._eval_graph(combine, list(c) + xs + extra)

        if length is not None and length == 0:
            with self._quieted():
                outs = body(list(init))
            self._report_loop(LoopReport(
                op="scan", eqn_index=self.counter, mode="exact", length=0,
                rounds=0, widened=False, narrowed=False,
            ))
            return list(init) + list(outs[ncar:])

        widened = narrowed = False
        rounds = 0
        ys: list = [None] * n_ys
        if length is not None and 0 < length <= SCAN_EXACT_LIMIT:
            mode = "exact"
            carry = list(init)
            # Join of carry ENTRY values only: auditing the body at this
            # join covers every iteration that runs, without a phantom
            # iteration C+1 a boundary-exact headroom must not be charged.
            entry_join: list | None = None
            for _ in range(length):
                entry_join = (list(carry) if entry_join is None else
                              [e.union(c) for e, c in zip(entry_join, carry)])
                with self._quieted():
                    outs = body(carry)
                new = outs[:ncar]
                for i, y in enumerate(outs[ncar:]):
                    ys[i] = y if ys[i] is None else ys[i].union(y)
                rounds += 1
                stable = all(n.lo == c.lo and n.hi == c.hi for n, c in zip(new, carry))
                carry = new
                if stable:
                    break           # deterministic: later iterates equal
            invariant = entry_join if entry_join is not None else list(init)
        else:
            mode = "fixpoint"
            invariant, rounds, widened, narrowed = self._loop_fixpoint(
                body, init, dtypes, None)
            carry = invariant
        audited = body(invariant)
        if mode == "fixpoint" or any(y is None for y in ys):
            ys = list(audited[ncar:])
        self._report_loop(LoopReport(
            op="scan", eqn_index=self.counter, mode=mode, length=length,
            rounds=rounds, widened=widened, narrowed=narrowed,
        ))
        return list(carry) + list(ys)

    def _cond_refiners(self, cond_gm, n_carry: int, extra: list):
        """Entry/exit carry refiners from a while condition of the shape
        `carry[i] OP bound` (bound = a literal, an additional input or a
        constant). -> (entry, exit) callables, or Nones when the pattern
        does not match (sound, just less precise)."""
        nodes = list(cond_gm.graph.nodes)
        out = nodes[-1].args[0]
        if isinstance(out, (tuple, list)):
            if len(out) != 1:
                return None, None
            out = out[0]
        if not isinstance(out, torch.fx.Node) or out.op != "call_function":
            return None, None
        flips = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        target = getattr(out.target, "overloadpacket", None)
        rel = target.__name__ if target is not None else None
        if rel not in flips:
            return None, None
        placeholders = [n for n in nodes if n.op == "placeholder"]

        def classify(v):
            if not isinstance(v, torch.fx.Node):
                return "iv", _array_interval(v)
            if v.op == "get_attr":
                return "iv", _array_interval(_fetch_attr(cond_gm, v.target))
            if v.op == "placeholder":
                idx = placeholders.index(v)
                if idx < n_carry:
                    return "carry", idx
                return "iv", extra[idx - n_carry]
            return None, None

        a_kind, a_val = classify(out.args[0])
        b_kind, b_val = classify(out.args[1])
        if a_kind == "carry" and b_kind == "iv":
            ci, bound = a_val, b_val
        elif b_kind == "carry" and a_kind == "iv":
            ci, bound = b_val, a_val
            rel = flips[rel]
        else:
            return None, None
        step = 1 if _is_int_dtype(_dtype_of(out.args[0])) else 0

        def make(r):
            def refine(carry):
                c = carry[ci]
                lo, hi = c.lo, c.hi
                if r == "lt":
                    hi = min(hi, bound.hi - step)
                elif r == "le":
                    hi = min(hi, bound.hi)
                elif r == "gt":
                    lo = max(lo, bound.lo + step)
                elif r == "ge":
                    lo = max(lo, bound.lo)
                if lo > hi:
                    return None      # contradiction: branch unreachable
                new = list(carry)
                new[ci] = Interval(lo, hi)
                return new

            return refine

        negations = {"lt": "ge", "le": "gt", "gt": "le", "ge": "lt"}
        return make(rel), make(negations[rel])

    def _eval_while(self, env, gm, node):
        args = node.args
        cond_gm = _fetch_attr(gm, args[0].target)
        body_gm = _fetch_attr(gm, args[1].target)
        init = [env[n] for n in args[2]]
        extra = [env[n] if isinstance(n, torch.fx.Node) else _array_interval(n)
                 for n in (args[3] if len(args) > 3 else ())]
        dtypes = [v.dtype for v in _meta(node)]
        entry_refine, exit_refine = self._cond_refiners(cond_gm, len(init), extra)

        def body(c):
            return self._eval_graph(body_gm, list(c) + extra)

        invariant, rounds, widened, narrowed = self._loop_fixpoint(
            body, init, dtypes, entry_refine)
        # AUDITED pass at the invariant (skipped when the entry refinement
        # proves the body unreachable).
        entry = entry_refine(invariant) if entry_refine is not None else invariant
        if entry is not None:
            body(entry)
        self._report_loop(LoopReport(
            op="while", eqn_index=self.counter, mode="fixpoint",
            length=None, rounds=rounds, widened=widened, narrowed=narrowed,
        ))
        # Loop output: the invariant under the NEGATED condition, plus the
        # initial carry whenever the condition may be false on entry.
        out = exit_refine(invariant) if exit_refine is not None else list(invariant)
        if out is None:
            out = list(invariant)
        with self._quieted():
            cond0 = self._eval_graph(cond_gm, init + extra)
        if not cond0 or cond0[0].lo <= 0:
            out = [o.union(i) for o, i in zip(out, init)]
        return out

    def _eval_cond(self, env, gm, node):
        """torch.cond: either branch may run; both are evaluated (audited),
        the false branch first as in the JAX `cond`'s branch order, and
        their outputs joined."""
        _pred, true_g, false_g, operands = node.args[:4]
        ins = [env[n] if isinstance(n, torch.fx.Node) else _array_interval(n)
               for n in operands]
        outs = None
        for g in (false_g, true_g):
            res = self._eval_graph(_fetch_attr(gm, g.target), ins)
            outs = res if outs is None else [o.union(r) for o, r in zip(res, outs)]
        return outs

    # -- a whole graph ----------------------------------------------------
    def _eval_graph(self, gm, in_intervals: list, out_ops: list | None = None):
        env: dict = {}
        ops: dict = {}
        ins = list(in_intervals)
        pos = 0
        higher = _higher_order_ops()
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = ins[pos] if pos < len(ins) else TOP
                ops[node] = "input"
                pos += 1
            elif node.op == "get_attr":
                obj = _fetch_attr(gm, node.target)
                if isinstance(obj, torch.Tensor):
                    env[node] = _array_interval(obj)
                ops[node] = "input"
            elif node.op == "call_function":
                if node.target is operator.getitem:
                    src, idx = node.args
                    value = env.get(src)
                    env[node] = value[idx] if isinstance(value, list) else TOP
                    ops[node] = ops.get(src, "input")
                    continue
                prim = higher.get(node.target)
                if prim is not None:
                    handler = {"while": self._eval_while, "scan": self._eval_scan,
                               "cond": self._eval_cond}[prim]
                    try:
                        outs = handler(env, gm, node)
                    except Exception as e:  # a handler hole must not kill analysis
                        self._note(f"`{prim}`: interval evaluation failed "
                                   f"({type(e).__name__}: {e}); output unbounded")
                        outs = None
                    metas = list(_meta(node))
                    if outs is None or len(outs) != len(metas):
                        outs = [TOP for _ in metas]
                    for out, m in zip(outs, metas):
                        self._check(prim, out, m.dtype)
                    self.counter += 1
                    env[node] = list(outs)
                    ops[node] = prim
                    continue
                if isinstance(node.target, torch._ops.OpOverload):
                    try:
                        env[node] = self._eval_aten(env, node)
                    except Exception as e:  # a handler hole must not kill analysis
                        self._note(f"`{node.target}`: interval evaluation failed "
                                   f"({type(e).__name__}: {e}); output unbounded")
                        env[node] = self._emit_top(str(node.target), node)
                    ops[node] = self._last_prim
                    continue
                self._note(f"unsupported call `{node.target}`: output unbounded")
                env[node] = self._emit_top(str(node.target), node)
                ops[node] = self._last_prim
            elif node.op == "output":
                outs = node.args[0]
                outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
                if out_ops is not None:
                    out_ops.extend(ops.get(o, "input") if isinstance(o, torch.fx.Node)
                                   else "input" for o in outs)
                return [self._iv(env, o) for o in outs]
        return []  # pragma: no cover - every graph has an output node


def eval_graph_ranges(
    gm: torch.fx.GraphModule,
    in_intervals: list[Interval],
    *,
    ceiling: Interval | None = None,
    check_dtype: bool = True,
    axis_sizes: dict | None = None,
) -> RangeResult:
    """Propagate intervals through a traced aten graph (`trace_graph`),
    recursing into while_loop / scan / cond sub-graphs.

    `ceiling` declares the exact-integer carrier bound every integer op
    must respect (e.g. the packed pipeline's min(q/2, 2**62)); without it,
    integer ops are checked against their own dtype (`check_dtype`).
    Violations are recorded as findings citing the primitive; the analysis
    continues with the mathematical interval, so the FIRST offending op is
    the root cause, not a cascade. `out_ops` names the primitive that
    produces each output ("input" for a graph input). `axis_sizes` maps a
    process group's name to the declared worst-case size of its axis: a
    functional `all_reduce` sum over it is the JAX `psum` (an undeclared
    group leaves the sum unbounded, with a note)."""
    interp = _RangeInterpreter(ceiling, check_dtype, axis_sizes)
    out_ops: list = []
    outs = interp._eval_graph(gm, in_intervals, out_ops)
    return RangeResult(outs, interp.findings, interp.notes, interp.loops, out_ops)


# ---------------------------------------------------------------------------
# Certificates.
# ---------------------------------------------------------------------------


def _out_check(res: RangeResult, idx: int, bound: Interval, what: str,
               findings: list, checks: list) -> None:
    """An output's interval against its declared bound: a proven fact, or
    an output-bound finding naming the op that produces the output."""
    iv = res.out_intervals[idx]
    if iv.lo < bound.lo or iv.hi > bound.hi:
        op = res.out_ops[idx]
        findings.append(RangeFinding(
            kind="output-bound", op=op, eqn_index=-1, interval=iv, bound=bound,
            message=f"{what}: `{op}` yields {iv}, outside {bound}",
        ))
    else:
        checks.append(f"{what} in {iv} ⊆ {bound}")


def _no_loop(res: RangeResult, op: str, bound: Interval, message: str) -> list:
    """The drift tripwire: a loop probe that traced without its loop."""
    if any(rep.op == op for rep in res.loops):
        return []
    return [RangeFinding(kind="output-bound", op=op, eqn_index=-1,  # pragma: no cover
                         interval=res.out_intervals[0], bound=bound, message=message)]


@dataclasses.dataclass(frozen=True)
class PackingCertificate:
    """Static proof (or refutation) of one packed-aggregation geometry."""

    ok: bool
    modulus_bits: int   # bit length of q
    bits: int           # quantizer width b
    k: int              # interleave factor
    fbits: int          # field width b + ceil(log2 C)
    guard: int          # effective guard guard_bits + ceil(log2 C)
    clients: int
    ceiling_bits: int   # log2 of the binding wall: min(q/2, 2**62)
    findings: tuple     # RangeFinding tuple, empty when ok
    checks: tuple       # human-readable proven facts

    def summary(self) -> str:
        head = (
            f"packing b={self.bits} k={self.k} C={self.clients} "
            f"(field {self.fbits}b, guard {self.guard}b, "
            f"wall 2**{self.ceiling_bits})"
        )
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=256)
def certify_packing(modulus: int, bits: int, k: int, clients: int, guard_bits: int,
                    *, device: str = "cpu") -> PackingCertificate:
    """Prove (or refute) the carry-free headroom of one packing geometry by
    interval analysis of `ckks.quantize.packing_sum_probe` (the plaintext
    integer math the encrypted path computes: quantize, offset, interleave,
    the C-client fold as a `scan`, the decrypt noise), checking every op
    against min(q/2, 2**62) and the outputs against:

      field_sums <= 2**fbits - 1          (the C-client sum never carries)
      |noise_sum| < 2**(guard_eff - 1)    (decrypt noise stays in the guard)
      packed total < min(q/2, 2**62)      (centred decode + int64 exactness)

    A failed check names the offending op. Cached: `PackedSpec.for_params`
    and `max_interleave` certify on every build."""
    from hefl_tpu_torch.ckks import quantize

    fbits = quantize.field_bits(bits, clients)
    guard_eff = guard_bits + max(int(clients) - 1, 0).bit_length()
    ceiling_val = min(modulus // 2, 1 << quantize.MAX_PACKED_BITS)
    ceiling = Interval(-(ceiling_val - 1), ceiling_val - 1)
    probe, args = quantize.packing_sum_probe(bits, k, fbits, guard_eff, clients, device)
    noise_per_client = (1 << max(guard_bits - 1, 0)) - 1
    res = eval_graph_ranges(
        trace_graph(probe, args),
        [TOP, Interval(-noise_per_client, noise_per_client)],
        ceiling=ceiling,
    )
    findings = list(res.findings)
    checks: list[str] = []
    _out_check(res, 0, Interval(0, (1 << fbits) - 1),
               f"per-field {clients}-client sum (carry-free)", findings, checks)
    half_guard = 1 << max(guard_eff - 1, 0)
    _out_check(res, 1, Interval(-(half_guard - 1), half_guard - 1),
               "accumulated decrypt noise (guard band)", findings, checks)
    _out_check(res, 2, ceiling, "packed client-sum (q/2 & 2**62 wall)", findings, checks)
    return PackingCertificate(
        ok=not findings, modulus_bits=modulus.bit_length(), bits=bits, k=k, fbits=fbits,
        guard=guard_eff, clients=int(clients), ceiling_bits=ceiling_val.bit_length() - 1,
        findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class AggregationCertificate:
    """Static no-wrap proof of the aggregation hot path at one prime size."""

    ok: bool
    prime_bits: int
    chunk: int          # lazy-sum participants proven per reduction
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = f"aggregation p<2**{self.prime_bits} chunk={self.chunk}"
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=32)
def certify_aggregation(prime: int, *, device: str = "cpu") -> AggregationCertificate:
    """Prove the aggregation folds never wrap their carriers at one prime
    size, over ALL inputs:

      1. `fl.secure.lazy_sum_mod`'s int64 sum of MAX_PSUM_CLIENTS canonical
         residues before its one reduction (`lazy_sum_chunk_probe`);
      2. `parallel.collectives.psum_mod`'s lazy all-reduce (int64) at
         MAX_PSUM_CLIENTS ranks on the client axis, whatever group traced
         it, on the 1-D client mesh and (2b) on the 2-D ("clients", "ct")
         mesh, where the ct axis partitions rows and adds no summand;
      3. `fl.stream.OnlineAccumulator`'s int64 fold, proven inductively for
         any arrival count (`certify_fold_inductive`).

    The all-reduce is traced on a process group (`collectives.
    tracing_group`: the world's, or a one-rank gloo group for the trace)."""
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.parallel import collectives

    prime = int(prime)
    canonical = Interval(0, prime - 1)
    findings: list[RangeFinding] = []
    checks: list[str] = []

    def run(name, gm, **kw):
        res = eval_graph_ranges(gm, [canonical], **kw)
        if res.findings:
            findings.extend(dataclasses.replace(f, message=f"{name}: {f.message}")
                            for f in res.findings)
        else:
            checks.append(f"{name} stays in {res.out_intervals[0]}")

    run("lazy_sum_mod chunk", trace_graph(*secure.lazy_sum_chunk_probe(MAX_PSUM_CLIENTS, device)))
    with collectives.tracing_group() as group:
        flat = trace_graph(*collectives.psum_range_probe(prime, device))
        two_d = trace_graph(*collectives.psum_range_probe_2d(prime, device))
        sizes = {group.group_name: MAX_PSUM_CLIENTS}
    run(f"psum_mod[{MAX_PSUM_CLIENTS} participants]", flat, axis_sizes=sizes)
    run(f"psum_mod 2-D[{MAX_PSUM_CLIENTS} clients x {MAX_PSUM_CLIENTS} ct]", two_d,
        axis_sizes=sizes)
    fold = certify_fold_inductive(prime, device=device)
    findings.extend(fold.findings)
    checks.extend(fold.checks)
    return AggregationCertificate(
        ok=not findings, prime_bits=prime.bit_length(), chunk=MAX_PSUM_CLIENTS,
        findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class FoldCertificate:
    """Inductive proof of the streaming fold invariant: accumulator in
    [0, p-1] and one fold step => accumulator in [0, p-1], a while-loop
    post-fixpoint over an abstract arrival count (any count up to 2**48).
    With a PackedSpec, the headroom-capped packed C-client sum rides along
    (`certify_packing`'s scan fold)."""

    ok: bool
    prime_bits: int
    count_ceiling_bits: int
    bits: int | None     # packed leg (None when certifying unpacked)
    k: int | None
    clients: int | None
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (
            f"fold-inductive p<2**{self.prime_bits} "
            f"arrivals<=2**{self.count_ceiling_bits}"
        )
        if self.bits is not None:
            head += f" packed(b={self.bits} k={self.k} C={self.clients})"
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_fold_inductive(prime: int, spec=None, modulus: int | None = None, *,
                           device: str = "cpu") -> FoldCertificate:
    """Prove the `OnlineAccumulator` invariant inductively for any arrival
    count: traces `fl.stream.fold_loop_probe` (the fold as a `while_loop`
    over an abstract count in [0, 2**48]) and establishes, as the loop's
    post-fixpoint, that the carried sum stays canonical ([0, p-1]) after
    every fold and that the int64 carrier never wraps.

    With `spec` (a hashable `PackedSpec`) and `modulus`, the packed half
    rides along: the headroom-capped C-client packed sum is re-derived by
    `certify_packing` at the spec's geometry, which backs the streaming
    engine's fold cap."""
    from hefl_tpu_torch.fl import stream

    prime = int(prime)
    canonical = Interval(0, prime - 1)
    probe, args = stream.fold_loop_probe(prime, device)
    res = eval_graph_ranges(trace_graph(probe, args),
                            [Interval(0, LOOP_COUNT_CEILING), canonical, canonical])
    findings = list(res.findings)
    checks: list[str] = []
    out = res.out_intervals[0]
    findings += _no_loop(res, "while", canonical,
                         "fold probe traced without a while loop — the inductive "
                         "machinery was not exercised")
    if out.lo < canonical.lo or out.hi > canonical.hi:
        findings.append(RangeFinding(
            kind="output-bound", op="while", eqn_index=-1, interval=out, bound=canonical,
            message=(f"OnlineAccumulator fold: carried sum reaches {out}, "
                     f"escaping the canonical residue range {canonical}"),
        ))
    else:
        checks.append(
            f"OnlineAccumulator fold invariant {out} ⊆ {canonical} closed "
            f"under any arrival count <= 2**{LOOP_COUNT_CEILING.bit_length() - 1}"
            " (inductive)"
        )
    bits = k = clients = None
    if spec is not None:
        if modulus is None:
            raise ValueError("certify_fold_inductive: a PackedSpec needs the ring modulus "
                             "to re-derive the packed C-client sum")
        bits, k, clients = int(spec.bits), int(spec.k), int(spec.clients)
        raw_guard = spec.guard - max(clients - 1, 0).bit_length()
        packed = certify_packing(int(modulus), bits, k, clients, raw_guard, device=device)
        findings.extend(dataclasses.replace(f, message=f"packed fold: {f.message}")
                        for f in packed.findings)
        if packed.ok:
            checks.append(f"headroom-capped packed fold (C={clients} scan): "
                          + "; ".join(packed.checks))
    return FoldCertificate(
        ok=not findings, prime_bits=prime.bit_length(),
        count_ceiling_bits=LOOP_COUNT_CEILING.bit_length() - 1, bits=bits, k=k,
        clients=clients, findings=tuple(findings), checks=tuple(checks),
    )


@functools.lru_cache(maxsize=64)
def certify_fold_tree(prime: int, *, device: str = "cpu") -> FoldCertificate:
    """Certify the two-tier fold tree (`fl.hierarchy`) on top of the
    inductive loop proof: the tree runs the same certified fold loop per
    host and at the root, so the certificate is the inductive one plus the
    facts it makes checkable — tier partials are canonical (the root fold's
    precondition), any bracketing of the same uploads gives the same
    residues (exact canonical addition mod p is associative and
    commutative), and a sealed partial folded at a later round's root is
    the same certified loop on the same value. An unsafe loop makes the
    tree unsafe."""
    base = certify_fold_inductive(int(prime), device=device)
    if not base.ok:
        return base
    checks = base.checks + (
        "tier partials canonical: each host fold ends in the loop "
        "post-fixpoint [0, p-1], satisfying the root fold's canonical-"
        "input precondition — the root is the same certified loop",
        "fold-tree = flat fold bitwise: exact canonical add mod p is "
        "associative+commutative, so any bracketing/arrival order of the "
        "same uploads yields identical residues",
        "carried partials certified: a sealed tier partial is a frozen "
        "canonical residue, so a stale tier fold at a later round's root "
        "is the same certified loop on the same value — late folding "
        "cannot leave the proven region",
    )
    return dataclasses.replace(base, checks=checks)


@dataclasses.dataclass(frozen=True)
class InferenceCertificate:
    """Static proof (or refutation) of the serving programs' integer
    invariants: the rotate-and-sum ladder, the hoisted sweep and the
    composed two-layer MLP."""

    ok: bool
    prime_bits: int
    digit_bits: int
    num_digits: int
    depth_ceiling_bits: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (
            f"inference ladder p<2**{self.prime_bits} "
            f"gadget(w={self.digit_bits} d={self.num_digits}) "
            f"depth<=2**{self.depth_ceiling_bits}"
        )
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_inference(prime: int, digit_bits: int, num_digits: int, *,
                      device: str = "cpu") -> InferenceCertificate:
    """Range-certify the serving programs for one ring geometry, each a
    loop over an abstract depth:

      * `he_inference.rotation_ladder_range_probe` — a ladder stage
        (automorphism gather at its worst-case sign flip, the centred gadget
        key-switch, the rotate+add) as a `while_loop`: the carried (c0, c1)
        stay canonical at ANY ladder depth, every digit x key product
        inside the 2**62 wall;
      * `ckks.ops.hoisted_gadget_probe` — the hoisted sweep's UNCENTERED
        digits must be canonical as extracted (2**w inside the prime), its
        outputs canonical at any step count;
      * `he_inference.mlp_bsgs_range_probe` — sweep, square, relinearize,
        rescale, sweep, canonical throughout.

    A geometry is CERTIFIED only when all three hold; a rejection cites the
    producing op."""
    from hefl_tpu_torch import he_inference
    from hefl_tpu_torch.ckks import ops, quantize

    prime = int(prime)
    canonical = Interval(0, prime - 1)
    wall = (1 << quantize.MAX_PACKED_BITS) - 1
    ceiling = Interval(-wall, wall)
    probe, args = he_inference.rotation_ladder_range_probe(prime, digit_bits, num_digits,
                                                           device)
    res = eval_graph_ranges(trace_graph(probe, args), [
        Interval(0, LOOP_COUNT_CEILING),   # abstract ladder depth
        canonical, canonical,              # carried ciphertext residues
        canonical, canonical,              # gadget/rotation key tensors
        # automorphism table indices: gather is range-preserving, so the
        # index bound is immaterial to the carried invariant.
        Interval(0, LOOP_COUNT_CEILING),
    ], ceiling=ceiling)
    findings = list(res.findings)
    checks: list[str] = []
    findings += _no_loop(res, "while", canonical,
                         "ladder probe traced without a while loop — the inductive "
                         "machinery was not exercised")
    _out_check(res, 0, canonical, "carried c0 residues (any ladder depth)", findings, checks)
    _out_check(res, 1, canonical, "carried c1 residues (any ladder depth)", findings, checks)
    if not findings:
        checks.append(f"gadget digit x key products inside the 2**62 wall "
                      f"(w={digit_bits}, d={num_digits})")

    def probe_checks(name: str, fn_args, in_ivs, out_specs) -> None:
        res2 = eval_graph_ranges(trace_graph(*fn_args), in_ivs, ceiling=ceiling)
        findings.extend(res2.findings)
        findings.extend(_no_loop(res2, "while", canonical,
                                 f"{name} probe traced without a while loop — the "
                                 "inductive machinery was not exercised"))
        for idx, what, bound in out_specs:
            _out_check(res2, idx, bound, f"{name}: {what}", findings, checks)

    # The hoisted path skips centring, so its digits must be canonical AS
    # EXTRACTED: the 2**w gadget bound has to sit inside [0, p-1].
    digit_bound = Interval(0, min((1 << int(digit_bits)) - 1, prime - 1))
    probe_checks(
        "hoisted sweep", ops.hoisted_gadget_probe(prime, digit_bits, num_digits, device),
        [
            Interval(0, LOOP_COUNT_CEILING),   # abstract step count
            canonical, canonical,              # shared (c0, c1) residues
            canonical, canonical,              # pre-permuted key tensors
            Interval(0, LOOP_COUNT_CEILING),   # eval permutation indices
        ],
        [
            (0, "uncentered gadget digits (shared across every step)", digit_bound),
            (1, "hoisted c0 outputs (any step count)", canonical),
            (2, "hoisted c1 outputs (any step count)", canonical),
        ],
    )
    probe_checks(
        "mlp compose", he_inference.mlp_bsgs_range_probe(prime, digit_bits, num_digits,
                                                         device),
        [
            Interval(0, LOOP_COUNT_CEILING),   # layer-1 step count
            Interval(0, LOOP_COUNT_CEILING),   # layer-2 step count
            canonical, canonical,              # input ciphertext residues
            canonical, canonical,              # key tensors
            Interval(0, LOOP_COUNT_CEILING),   # permutation indices
            canonical,                         # rescale p_last^{-1} mod p
        ],
        [
            (0, "composed c0 residues (sweep→square→relin→rescale→sweep)", canonical),
            (1, "composed c1 residues (full two-layer circuit)", canonical),
        ],
    )
    return InferenceCertificate(
        ok=not findings, prime_bits=prime.bit_length(), digit_bits=int(digit_bits),
        num_digits=int(num_digits), depth_ceiling_bits=LOOP_COUNT_CEILING.bit_length() - 1,
        findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class KeyswitchCertificate:
    """Static proof (or refutation) of one key-switch gadget geometry: the
    gadget-tensor contract K5 and its plain version implement."""

    ok: bool
    prime_bits: int
    digit_bits: int
    num_digits: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (
            f"keyswitch gadget p<2**{self.prime_bits} "
            f"(w={self.digit_bits} d={self.num_digits})"
        )
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_keyswitch(prime: int, digit_bits: int, num_digits: int, *,
                      device: str = "cpu") -> KeyswitchCertificate:
    """Range-certify the gadget key-switch for one geometry by tracing
    `ckks.ops.keyswitch_gadget_probe` (digit extraction, centring, the
    digit x key inner product over every gadget component, the modular
    tree-sum on the int64 carrier): every digit below 2**w AND below the
    prime (the centring's sub_mod precondition), every product inside the
    2**62 wall, the accumulated (c0, c1) correction canonical."""
    from hefl_tpu_torch.ckks import ops, quantize

    prime = int(prime)
    canonical = Interval(0, prime - 1)
    wall = (1 << quantize.MAX_PACKED_BITS) - 1
    probe, args = ops.keyswitch_gadget_probe(prime, digit_bits, num_digits, device)
    res = eval_graph_ranges(trace_graph(probe, args), [canonical, canonical, canonical],
                            ceiling=Interval(-wall, wall))
    findings = list(res.findings)
    checks: list[str] = []
    _out_check(res, 0, Interval(0, (1 << int(digit_bits)) - 1),
               "gadget digits (base-2**w bound)", findings, checks)
    _out_check(res, 0, canonical,
               "gadget digits canonical (the kernel's sub_mod precondition)", findings, checks)
    _out_check(res, 1, canonical, "accumulated c0 correction", findings, checks)
    _out_check(res, 2, canonical, "accumulated c1 correction", findings, checks)
    if not findings:
        checks.append(f"digit x key products inside the 2**62 wall "
                      f"(w={digit_bits}, d={num_digits})")
    return KeyswitchCertificate(
        ok=not findings, prime_bits=prime.bit_length(), digit_bits=int(digit_bits),
        num_digits=int(num_digits), findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class TranscipherCertificate:
    """Static proof (or refutation) of one hybrid-HE transciphering geometry."""

    ok: bool
    modulus_bits: int
    bits: int
    k: int
    fbits: int
    guard: int          # effective guard guard_bits + ceil(log2 C)
    clients: int
    findings: tuple     # RangeFinding tuple, empty when ok
    checks: tuple       # human-readable proven facts

    def summary(self) -> str:
        head = (
            f"transciphering b={self.bits} k={self.k} C={self.clients} "
            f"(field {self.fbits}b, guard {self.guard}b, "
            f"q/2 wall 2**{self.modulus_bits - 1})"
        )
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=256)
def certify_transciphering(modulus: int, bits: int, k: int, clients: int, guard_bits: int,
                           *, device: str = "cpu") -> TranscipherCertificate:
    """Prove (or refute) the hybrid-HE transciphering invariants for one
    (q, bits, k, clients, guard) point over ALL inputs, by tracing
    `hhe.cipher.transcipher_sum_probe` (the cipher's wrap carry gamma in
    {0, 1} abstracted as an input):

      field_sums <= 2**fbits - 1       (the C-client sum never carries)
      |noise_sum| < 2**(guard_eff-1)   (decrypt noise stays in the guard)
      |transciphered total| < q/2      (the centred CRT decode holds
                                        sum(v) - 2**62*Gamma + E exactly)
      recovered+2**(g-1) in [0, 2**62) (hhe_center_mod's window)

    with `check_dtype=False` (the probe's int64 is a tracing carrier: the
    decode reads the centred value modulo 2**64, benign for the mod-2**62
    recovery), plus the counter-mode keystream loop
    (`keystream_counter_probe`): the round counter (mod 2**32) and both
    cipher words stay in their carriers at any round count. Cached: the
    streaming engine certifies on every HHE round set-up."""
    from hefl_tpu_torch.ckks import quantize
    from hefl_tpu_torch.hhe import cipher as hhe_cipher

    fbits = quantize.field_bits(bits, clients)
    guard_eff = guard_bits + max(int(clients) - 1, 0).bit_length()
    half_q = modulus // 2
    ceiling = Interval(-(half_q - 1), half_q - 1)
    domain = 1 << hhe_cipher.HHE_DOMAIN_BITS
    probe, args = hhe_cipher.transcipher_sum_probe(bits, k, fbits, guard_eff, clients, device)
    noise_per_client = (1 << max(guard_bits - 1, 0)) - 1
    res = eval_graph_ranges(trace_graph(probe, args), [
        TOP,                                            # raw float updates
        Interval(0, 1),                                 # wrap carry gamma
        Interval(-noise_per_client, noise_per_client),  # per-client noise
    ], ceiling=ceiling, check_dtype=False)
    findings = list(res.findings)
    checks: list[str] = []
    _out_check(res, 0, Interval(0, (1 << fbits) - 1),
               f"per-field {clients}-client sum (carry-free)", findings, checks)
    half_guard = 1 << max(guard_eff - 1, 0)
    _out_check(res, 1, Interval(-(half_guard - 1), half_guard - 1),
               "accumulated decrypt noise (guard band)", findings, checks)
    _out_check(res, 2, ceiling, "transciphered total (q/2 wall)", findings, checks)
    _out_check(res, 3, Interval(0, domain - 1), "shifted recovery (mod-2**62 window)",
               findings, checks)

    cprobe, cargs = hhe_cipher.keystream_counter_probe(device)
    word = Interval(0, (1 << 31) - 1)
    cres = eval_graph_ranges(trace_graph(cprobe, cargs), [
        Interval(0, LOOP_COUNT_CEILING),         # abstract round count
        Interval(0, (1 << 32) - 1),              # round counter (mod 2**32)
        Interval((1 << 32) - 1, (1 << 32) - 1),  # the mod-2**32 mask
        word, word,                              # packed (hi, lo) payload
        word, word,                              # keystream (hi, lo) draws
    ])
    findings.extend(dataclasses.replace(f, message=f"keystream counter loop: {f.message}")
                    for f in cres.findings)
    findings += _no_loop(cres, "while", word,
                         "keystream counter probe traced without a while loop")
    ctr_out, whi_out, wlo_out = cres.out_intervals
    for what, iv, bound in (
        ("round counter (mod 2**32)", ctr_out, Interval(0, (1 << 32) - 1)),
        ("cipher word hi", whi_out, word),
        ("cipher word lo", wlo_out, word),
    ):
        if iv.lo < bound.lo or iv.hi > bound.hi:
            findings.append(RangeFinding(
                kind="output-bound", op="while", eqn_index=-1, interval=iv, bound=bound,
                message=f"keystream counter loop: {what} reaches {iv}, outside {bound}",
            ))
        else:
            checks.append(f"{what} in {iv} ⊆ {bound} at any round count")
    return TranscipherCertificate(
        ok=not findings, modulus_bits=modulus.bit_length(), bits=bits, k=k, fbits=fbits,
        guard=guard_eff, clients=int(clients), findings=tuple(findings),
        checks=tuple(checks),
    )


def certified_max_interleave(modulus: int, bits: int, clients: int, guard_bits: int) -> int:
    """The largest k `certify_packing` certifies, searched upward from 1 (the
    cross-check target of `quantize.max_interleave`'s closed form)."""
    k = 0
    while certify_packing(modulus, bits, k + 1, clients, guard_bits).ok:
        k += 1
        if k > 64:  # one packed slot cannot hold more than 64 one-bit fields
            break
    return k


__all__ = [
    "Interval",
    "TOP",
    "LOOP_COUNT_CEILING",
    "SCAN_EXACT_LIMIT",
    "WIDEN_DELAY",
    "RangeFinding",
    "RangeResult",
    "LoopReport",
    "eval_graph_ranges",
    "trace_graph",
    "PackingCertificate",
    "AggregationCertificate",
    "FoldCertificate",
    "InferenceCertificate",
    "KeyswitchCertificate",
    "TranscipherCertificate",
    "certify_packing",
    "certify_aggregation",
    "certify_fold_inductive",
    "certify_fold_tree",
    "certify_inference",
    "certify_keyswitch",
    "certify_transciphering",
    "certified_max_interleave",
]
