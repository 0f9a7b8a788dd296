"""Forbidden-primitive, dtype-contamination, host-sync and donation lint.

Counterpart of `hefl_tpu.analysis.lint`, with its names and rules. The JAX
module reads jaxprs; eager PyTorch has none, so this one RUNS each region
on small tensors under a `TorchDispatchMode` that records every aten op
with its input and output dtypes and devices (and the `hefl.*` profiler
ranges open around it), and checks the rules on that record.

Rules (each with a per-rule allowlist, see :data:`ALLOWLIST`):

  * ``forbidden-primitive`` — `aten.remainder`, `fmod`, `floor_divide`,
    or `div` with a `rounding_mode`. Inside a declared exact-integer region
    (the modules' ``exact_int_probes()``) flagged whatever the dtype; in the
    round programs (hot-path mode) only on integer dtypes: float division
    is training math, an integer divide is the divide the modular path
    must not issue.
  * ``float-contamination`` — any floating dtype inside a declared
    exact-integer region (one float round-trip shears packed bits).
  * ``f64`` — float64 anywhere in an analysed program.
  * ``host-callback`` — the counterpart of a callback in a jitted program,
    a device-to-host sync: `aten._local_scalar_dense` (`.item()`), or a
    `copy_`/`_to_copy` from a CUDA tensor to the CPU, inside an SGD step
    (a `hefl.sgd_core` range: one per-client or fused step), inside the
    ciphertext sum (`hefl.psum_aggregate`: `aggregate_encrypted`, the
    fold), or anywhere in an exact-integer region.
  * ``broken-donation`` — the counterpart of a donated buffer that
    silently becomes a copy: an in-place accumulator whose result no
    longer holds the storage of its input (`OnlineAccumulator.fold`'s
    running sum, the fused step's parameter and Adam update).
  * ``source-forbidden`` — an AST sweep of `hefl_tpu_torch/` for
    attribute references to `torch.remainder`, `torch.fmod` and
    `torch.floor_divide` (docstrings and comments cannot trip it).

The kernels K1-K7 are launched through ctypes and never reach the
dispatcher, so on the card this lint checks the PyTorch glue around them;
on the CPU the same regions run the kernels' plain versions, so it checks
those too. The range probes `analysis.ranges` traces are checked on their
traced graphs (`lint_range_probes`: forbidden primitives, each probe's `%`
allowlisted at that probe only). `lint_exact_regions` +
`lint_range_probes` + `lint_round_programs` + `check_tree_donations` +
`source_sweep` are the whole-tree gates
`python -m hefl_tpu_torch.analysis` runs; `lint_fn` is the building block
the violation fixtures exercise.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import sys
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str      # rule id (see module docstring)
    where: str     # region / program / file the violation lives in
    message: str

    def __str__(self):
        return f"[{self.rule}] {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Allow:
    """One allowlist entry: exempts `primitive` (an aten op name without its
    overload, e.g. "remainder") from `rule` in regions matching the fnmatch
    `region` pattern, with a recorded justification.

    `max_size` restricts the exemption to ops whose output has at most that
    many elements. `source` restricts it to ops dispatched with a Python
    frame matching the `file:function` fnmatch pattern on the stack, the
    way to bless ONE call site without blessing every future op of its
    kind in the same program."""

    region: str
    rule: str
    primitive: str
    reason: str
    max_size: int | None = None
    source: str | None = None


# Every entry is a deliberate, justified exception: an unexplained new
# remainder, divide or float must fail the gate, not grow this list.
ALLOWLIST: tuple[Allow, ...] = (
    Allow(
        region="*",
        rule="forbidden-primitive",
        primitive="floor_divide",
        source="*/ckks/modular.py:barrett_mu",
        max_size=64,
        reason=(
            "ckks.modular.barrett_mu: floor(2**32 / p) on the [L, 1] prime "
            "table, once a Barrett reduction, never per element (the JAX "
            "package's own entry for barrett_mu). Pinned to the one call "
            "site and capped by size, so any other small divide still fails"
        ),
    ),
    Allow(
        region="*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/he_inference.py:contract",
        reason=(
            "the depth-2 MLP's output contraction: one int64 remainder of "
            "the sum of H canonical Montgomery products a score; the H100 "
            "has no TPU divide constraint, and a chain of H add_mods would "
            "cost H launches a score"
        ),
    ),
    Allow(
        region="*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/fl/secure.py:lazy_sum_mod",
        reason=(
            "fl.secure.lazy_sum_mod: one int64 remainder a ciphertext sum, "
            "after the int64 sum of every client's canonical residues (the "
            "JAX package reduces a uint32 chunk with Barrett steps because "
            "the TPU has no integer divide; the H100 has no such constraint, "
            "and the reduction runs once a round, not per client)"
        ),
    ),
    Allow(
        region="*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/fl/stream.py:_mod",
        reason=(
            "OnlineAccumulator._mod: one int64 remainder a fold (the JAX "
            "package's host-side numpy `(a + b) % p`, allowlisted there as "
            "fl.stream.accumulator_fold / fold_loop); the H100 has no TPU "
            "divide constraint"
        ),
    ),
    # The range probes (`analysis.ranges`' certifiers trace them; never run
    # on a device) mirror canonical-residue arithmetic with `%` standing in
    # for the Montgomery REDC contract. `lint_range_probes` walks their
    # traced graphs; each entry blesses the `%` of ONE probe.
    Allow(
        region="ranges:*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/fl/stream.py:fold_loop_probe",
        reason=(
            "fold_loop_probe: the arrival-loop form of OnlineAccumulator._add's "
            "(row + acc) % p, traced so the inductive invariant proof analyses "
            "the real loop shape (the JAX package's fl.stream.fold_loop entry)"
        ),
    ),
    Allow(
        region="ranges:*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/he_inference.py:rotation_ladder_range_probe",
        reason=(
            "rotation_ladder_range_probe mirrors the serving ladder's "
            "canonical-residue arithmetic with `%` standing in for the "
            "Montgomery REDC contract; traced for range analysis, never run. "
            "The real ladder (rotate_and_sum_scan) is linted as the "
            "he_inference.rotate_ladder region (the JAX package's entry)"
        ),
    ),
    Allow(
        region="ranges:*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/ckks/ops.py:keyswitch_gadget_probe",
        reason=(
            "keyswitch_gadget_probe mirrors K5's digit x key accumulation "
            "with `%` standing in for the Montgomery REDC contract; traced "
            "for range analysis, never run. The real key-switch (K5 and its "
            "plain version) is division-free and bitwise-tested (the JAX "
            "package's ckks.ops.keyswitch_gadget entry)"
        ),
    ),
    Allow(
        region="ranges:*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/ckks/ops.py:hoisted_gadget_probe",
        reason=(
            "hoisted_gadget_probe mirrors the hoisted sweep (uncentred digits, "
            "digit x pre-permuted key accumulation, the output gather) with "
            "`%` standing in for REDC, certifying the 2**w <= p digit width; "
            "traced, never run. The real sweep (K6 and its plain version) is "
            "division-free and bitwise-tested (the JAX package's "
            "ckks.ops.hoisted_gadget entry)"
        ),
    ),
    Allow(
        region="ranges:*",
        rule="forbidden-primitive",
        primitive="remainder",
        source="*/he_inference.py:mlp_bsgs_range_probe",
        reason=(
            "mlp_bsgs_range_probe mirrors the composed two-layer circuit "
            "(hoisted sweep, square, relinearisation, rescale, sweep) with `%` "
            "standing in for REDC; traced for range analysis only. The real "
            "program is linted as the he_inference.mlp_compose region (the JAX "
            "package's entry)"
        ),
    ),
    Allow(
        region="*",
        rule="source-forbidden",
        primitive="remainder",
        source="*/fl/secure.py:lazy_sum_mod",
        reason="the one remainder of fl.secure.lazy_sum_mod, allowlisted above",
    ),
    Allow(
        region="*",
        rule="source-forbidden",
        primitive="remainder",
        source="*/fl/stream.py:_mod",
        reason="the one remainder of OnlineAccumulator._mod, allowlisted above",
    ),
)

# aten op names (overload packet, a trailing in-place "_" dropped).
FORBIDDEN = ("remainder", "fmod", "floor_divide")
SYNC_OPS = ("_local_scalar_dense",)
COPY_OPS = ("_to_copy", "copy")
# The ranges whose ops must not sync with the host: one SGD step, the
# ciphertext sum / fold.
HOT_SCOPES = ("hefl.sgd_core", "hefl.psum_aggregate")

_TORCH_DIR = os.path.dirname(torch.__file__)


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _is_inexact(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _sources() -> list[str]:
    """`file:function` of the Python frames on the stack outside torch and
    this module: the call site of the op being dispatched."""
    out = []
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if not path.startswith(_TORCH_DIR) and path != __file__:
            out.append(f"{path.replace(os.sep, '/')}:{frame.f_code.co_name}")
        frame = frame.f_back
    return out


def _allowed(allow: tuple[Allow, ...], region: str, rule: str, prim: str, size: int,
             sources: Callable[[], list[str]]) -> Allow | None:
    for a in allow:
        if a.rule != rule or a.primitive not in ("*", prim):
            continue
        if not fnmatch.fnmatch(region, a.region):
            continue
        if a.max_size is not None and size > a.max_size:
            continue
        if a.source is not None and not any(fnmatch.fnmatch(s, a.source) for s in sources()):
            continue
        return a
    return None


class _Recorder(TorchDispatchMode):
    """Runs the rules on every aten op dispatched inside it; tracks the
    `record_function` ranges open around each op (their enter and exit are
    profiler ops that pass through the dispatcher too)."""

    def __init__(self, region: str, exact_int: bool, allow: tuple[Allow, ...]):
        super().__init__()
        self.region, self.exact_int, self.allow = region, exact_int, allow
        self.findings: dict[tuple, LintFinding] = {}
        self.scopes: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "profiler":
            self._track_scope(_op_name(func), args)
        else:
            self._check(func, args, kwargs, out)
        return out

    def _track_scope(self, name: str, args) -> None:
        # `record_function` ranges are `with` blocks, so they close in the
        # reverse order they opened.
        if name.startswith("_record_function_enter"):
            self.scopes.append(str(args[0]))
        elif name == "_record_function_exit" and self.scopes:
            self.scopes.pop()

    def _flag(self, rule: str, prim: str, size: int, message: str, sources) -> None:
        if _allowed(self.allow, self.region, rule, prim, size, sources) is None:
            site = sources()[0].rsplit("/", 2)[-2:] if sources() else ["?"]
            message = f"{message} (at {'/'.join(site)})"
            self.findings.setdefault((rule, message),
                                     LintFinding(rule=rule, where=self.region, message=message))

    def _check(self, func, args, kwargs, out) -> None:
        prim = _op_name(func)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        dtypes = [t.dtype for t in ins + outs]
        size = int(outs[0].numel()) if outs else 1
        shown = sorted({str(d).removeprefix("torch.") for d in dtypes})
        cache: list = []

        def sources() -> list[str]:
            if not cache:
                cache.append(_sources())
            return cache[0]

        if torch.float64 in dtypes:
            self._flag("f64", prim, size, f"`{func}` carries float64 ({shown})", sources)
        divide = prim in FORBIDDEN or (prim == "div" and kwargs.get("rounding_mode") is not None)
        if divide and (self.exact_int or any(_is_int(d) for d in dtypes)):
            kind = "exact-integer region" if self.exact_int else "hot path"
            self._flag("forbidden-primitive", prim, size,
                       f"`{func}` in {kind} (dtypes {shown}) — an integer divide the modular "
                       "path must not issue", sources)
        if self.exact_int and any(_is_inexact(d) for d in dtypes):
            self._flag("float-contamination", prim, size,
                       f"`{func}` carries inexact dtypes ({shown}) inside a declared "
                       "exact-integer region — one float round-trip shears packed bits",
                       sources)
        # .item() syncs on a card; on the CPU it is flagged where the card
        # would sync. A copy syncs when it brings a CUDA tensor to the CPU.
        src = (ins[-1] if prim == "copy" else ins[0]) if ins else None
        copy_down = prim in COPY_OPS and src is not None and outs and src.is_cuda \
            and not outs[0].is_cuda
        if (prim in SYNC_OPS or copy_down) and (self.exact_int or self._hot()):
            where = "an exact-integer region" if self.exact_int else f"`{self._hot()}`"
            self._flag("host-callback", prim, size,
                       f"`{func}` inside {where} — a device-to-host sync on the hot path",
                       sources)

    def _hot(self) -> str | None:
        return next((name for name in reversed(self.scopes) if name in HOT_SCOPES), None)


def lint_fn(fn: Callable, args: tuple, region: str, *, exact_int: bool,
            allow: tuple[Allow, ...] = ALLOWLIST) -> list[LintFinding]:
    """Run `fn(*args)` under the recorder and return the rules' findings
    (the fixture entry point). `exact_int=True` is the declared
    exact-integer-region mode (any remainder/divide, any float, any sync
    are violations); False is the hot-path mode (integer divides, f64,
    syncs inside an SGD step or the ciphertext sum)."""
    rec = _Recorder(region, exact_int, allow)
    with rec:
        fn(*args)
    return list(rec.findings.values())


# ---------------------------------------------------------------------------
# Whole-tree gates.
# ---------------------------------------------------------------------------

# The JAX package's declared regions that have no counterpart here, and why
# (none: the client-mesh all-reduce is `parallel.collectives.psum_mod`).
UNPORTED_REGIONS: dict[str, str] = {}


def exact_int_regions(device="cpu") -> dict[str, tuple[Callable, tuple]]:
    """Every declared exact-integer region of the port, as the `(fn, args)`
    pairs its modules' `exact_int_probes(device)` export, the JAX region
    names (less `UNPORTED_REGIONS`)."""
    from hefl_tpu_torch import he_inference
    from hefl_tpu_torch.ckks import encoding, ops, packing, quantize
    from hefl_tpu_torch.fl import secure, stream
    from hefl_tpu_torch.hhe import cipher as hhe_cipher
    from hefl_tpu_torch.hhe import transcipher as hhe_transcipher
    from hefl_tpu_torch.parallel import collectives

    device = torch.device(device)
    regions: dict[str, tuple[Callable, tuple]] = {}
    for mod in (quantize, packing, encoding, ops, secure, stream, hhe_cipher, hhe_transcipher,
                he_inference, collectives):
        regions.update(mod.exact_int_probes(device))
    return regions


def lint_exact_regions(allow: tuple[Allow, ...] = ALLOWLIST, device="cpu") -> list[LintFinding]:
    """Lint every declared exact-integer region (no remainder/divide, no
    floats, no host syncs)."""
    findings: list[LintFinding] = []
    for region, (fn, args) in exact_int_regions(device).items():
        findings.extend(lint_fn(fn, args, region, exact_int=True, allow=allow))
    return findings


def range_probes(device="cpu") -> dict[str, tuple[Callable, tuple]]:
    """The nine range probes `analysis.ranges`' certifiers trace, at a
    representative geometry (p = 2**27 - 39), on `device`, keyed
    "ranges:<module>.<probe>"."""
    from hefl_tpu_torch import he_inference
    from hefl_tpu_torch.ckks import ops, quantize
    from hefl_tpu_torch.fl import secure, stream
    from hefl_tpu_torch.hhe import cipher

    p = 2**27 - 39
    probes = {
        "ckks.quantize.packing_sum_probe": quantize.packing_sum_probe(8, 2, 9, 17, 2, device),
        "fl.secure.lazy_sum_chunk_probe": secure.lazy_sum_chunk_probe(32, device),
        "fl.stream.fold_loop_probe": stream.fold_loop_probe(p, device),
        "ckks.ops.keyswitch_gadget_probe": ops.keyswitch_gadget_probe(p, 5, 6, device),
        "ckks.ops.hoisted_gadget_probe": ops.hoisted_gadget_probe(p, 5, 6, device),
        "he_inference.rotation_ladder_range_probe":
            he_inference.rotation_ladder_range_probe(p, 9, 3, device),
        "he_inference.mlp_bsgs_range_probe": he_inference.mlp_bsgs_range_probe(p, 5, 6, device),
        "hhe.cipher.transcipher_sum_probe": cipher.transcipher_sum_probe(8, 2, 9, 17, 2, device),
        "hhe.cipher.keystream_counter_probe": cipher.keystream_counter_probe(device),
    }
    return {f"ranges:{name}": fa for name, fa in probes.items()}


def _graph_ops(gm):
    """Every aten op of a traced graph and of its loop / branch sub-graphs."""
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            sub = gm
            for part in node.target.split("."):
                sub = getattr(sub, part)
            if isinstance(sub, torch.fx.GraphModule):
                yield from _graph_ops(sub)
        elif node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload):
            yield node


def lint_range_probes(allow: tuple[Allow, ...] = ALLOWLIST, device="cpu") -> list[LintFinding]:
    """The forbidden-primitive rule over the range probes' traced graphs:
    a probe's `%` passes only through the allowlist entry pinned to that
    probe (its defining function), so a remainder slipped into any other
    probe fails."""
    from hefl_tpu_torch.analysis.ranges import trace_graph

    findings: list[LintFinding] = []
    for region, (fn, args) in range_probes(device).items():
        code = fn.__code__
        site = (f"{code.co_filename.replace(os.sep, '/')}:"
                f"{fn.__qualname__.split('.<locals>')[0]}")
        for node in _graph_ops(trace_graph(fn, args)):
            prim = _op_name(node.target)
            if prim not in FORBIDDEN:
                continue
            size = int(node.meta["val"].numel())
            if _allowed(allow, region, "forbidden-primitive", prim, size, lambda: [site]):
                continue
            findings.append(LintFinding(
                rule="forbidden-primitive", where=region,
                message=f"`{prim}` in the traced probe ({site.rsplit('/', 1)[-1]})",
            ))
    return findings


def _tiny_round_inputs(device="cpu"):
    """The tiny geometry the gate runs the real round programs at: on the
    CPU the JAX gate's (SmallCNN on `mnist`, 2 clients of 8 images); on a
    card `medical-8`'s model and clients (MedCNN at 256x256x3, 8 clients
    of 8 `medical` images). -> (model, params, xs, ys, num_classes)."""
    from hefl_tpu_torch.data import iid_contiguous, make_dataset, stack_federated
    from hefl_tpu_torch.models import create_model

    device = torch.device(device)
    name, dataset, clients, classes = (("medcnn", "medical", 8, 2) if device.type == "cuda"
                                       else ("smallcnn", "mnist", 2, 10))
    (x, y), _, _ = make_dataset(dataset, seed=0, n_train=8 * clients, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), clients))
    torch.manual_seed(0)
    model = create_model(name, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    return (model, params, torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device),
            classes)


def _tiny_cfg(fusion: str, num_classes: int):
    from hefl_tpu_torch.fl.config import TrainConfig

    return TrainConfig(epochs=1, batch_size=4, num_classes=num_classes, val_fraction=0.25,
                       client_fusion=fusion)


def lint_round_programs(allow: tuple[Allow, ...] = ALLOWLIST, *, secure: bool = True,
                        fusion: str = "vmap", device="cpu") -> list[LintFinding]:
    """Run the real round programs at tiny geometry (`_tiny_round_inputs`)
    under the hot-path rules: no integer remainder/divide, no f64, no host
    sync inside an SGD step or the ciphertext sum."""
    from hefl_tpu_torch.fl.fedavg import fedavg_round

    model, params, xs, ys, classes = _tiny_round_inputs(device)
    cfg = _tiny_cfg(fusion, classes)
    findings = lint_fn(
        lambda: fedavg_round(model, cfg, params, xs, ys, torch.Generator().manual_seed(1)),
        (), f"fl.fedavg.round[{fusion}]", exact_int=False, allow=allow)
    if secure:
        from hefl_tpu_torch.ckks.keys import CkksContext, keygen
        from hefl_tpu_torch.fl.secure import secure_fedavg_round

        ctx = CkksContext.create(n=256)
        _, pk = keygen(ctx, torch.Generator().manual_seed(2), device=device)
        findings += lint_fn(
            lambda: secure_fedavg_round(model, cfg, ctx, pk, params, xs, ys,
                                        torch.Generator().manual_seed(1)),
            (), f"fl.secure.round[{fusion}]", exact_int=False, allow=allow)
    return findings


# ---------------------------------------------------------------------------
# Donation rule.
# ---------------------------------------------------------------------------


def _storages(tree) -> list[int]:
    return [t.untyped_storage().data_ptr() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def check_donation(fn: Callable, args: tuple, where: str, *, donate: tuple = (0,),
                   min_aliased: int = 1) -> list[LintFinding]:
    """Run `fn(*args)` and verify that its result holds the storage of at
    least `min_aliased` tensors of the donated arguments (`donate`:
    argument positions; a tensor, or a dict / list / dataclass-free pytree
    of them): the in-place update the function declares did not silently
    become a copy."""
    donated = [ptr for i in donate for ptr in _storages(args[i])]
    out = _storages(fn(*args))
    aliased = sum(1 for ptr in donated if ptr in out)
    if aliased < min_aliased:
        return [LintFinding(
            rule="broken-donation", where=where,
            message=(f"declared in-place update returned {aliased} of {len(donated)} donated "
                     f"tensor(s) (expected >= {min_aliased}) — the donated input is silently "
                     "copied, not reused"),
        )]
    return []


def check_tree_donations(device="cpu") -> list[LintFinding]:
    """The port's in-place accumulators at tiny geometry: the streaming
    fold's running sum and the fused step's parameter and Adam update."""
    import numpy as np

    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.data.augment import rescale
    from hefl_tpu_torch.fl.fusion import fused_step
    from hefl_tpu_torch.fl.optimizer import AdamState, adam_init
    from hefl_tpu_torch.fl.stream import OnlineAccumulator
    from hefl_tpu_torch.models.folded import fold_clients, stack_params

    device = torch.device(device)
    ctx = CkksContext.create(n=256)
    acc = OnlineAccumulator(ctx.ntt.p)
    up = torch.zeros((2, ctx.num_primes, ctx.n), dtype=torch.int32, device=device)
    acc.fold(0, up, up)

    def fold(running, c0, c1):
        acc.fold(1, c0, c1)
        return acc._c0, acc._c1      # the running sum itself (value() copies it)

    findings = check_donation(fold, ((acc._c0, acc._c1), up + 1, up + 2),
                              "fl.stream.OnlineAccumulator.fold", min_aliased=2)

    model, params, xs, ys, classes = _tiny_round_inputs(device)
    cfg = _tiny_cfg("fused", classes)
    clients = int(xs.shape[0])
    stacked = stack_params(params, clients)
    opt = adam_init(stacked)
    xb = fold_clients(rescale(xs[:, :4]))
    onehot = torch.nn.functional.one_hot(ys[:, :4].to(torch.int64), classes).to(torch.float32)
    lr_scale = np.ones(clients, dtype=np.float32)

    def step(p, mu, nu):
        new_p, new_opt = fused_step(model, cfg, p, AdamState(mu=mu, nu=nu, step=opt.step), xb,
                                    onehot, lr_scale, params)
        return new_p, new_opt.mu, new_opt.nu

    findings += check_donation(step, (stacked, opt.mu, opt.nu), "fl.fusion.fused_step",
                               donate=(0, 1, 2), min_aliased=3 * len(stacked))
    return findings


# ---------------------------------------------------------------------------
# Source-level sweep (the grep the lint replaces, made docstring-proof).
# ---------------------------------------------------------------------------

_SOURCE_FORBIDDEN = {
    ("torch", "remainder"): "torch.remainder",
    ("torch", "fmod"): "torch.fmod",
    ("torch", "floor_divide"): "torch.floor_divide",
}


def _enclosing_functions(tree: ast.AST) -> dict[int, str]:
    """id(node) -> the name of the innermost function holding it."""
    owner: dict[int, str] = {}

    def walk(node, name):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else name
            owner[id(child)] = inner
            walk(child, inner)

    walk(tree, "<module>")
    return owner


def source_sweep(root: str | None = None,
                 allow: tuple[Allow, ...] = ALLOWLIST) -> list[LintFinding]:
    """AST-walk the package for forbidden attribute references. Docstrings
    and comments cannot trip it; a real call site always does, unless an
    allowlist entry names its `file:function`."""
    import hefl_tpu_torch

    root = root or os.path.dirname(hefl_tpu_torch.__file__)
    findings: list[LintFinding] = []
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, os.path.dirname(root))
            with open(path, encoding="utf-8") as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError as e:
                    findings.append(LintFinding(rule="source-forbidden", where=rel,
                                                message=f"unparsable: {e}"))
                    continue
            owner = _enclosing_functions(tree)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)):
                    continue
                key = (node.value.id, node.attr)
                if key not in _SOURCE_FORBIDDEN:
                    continue
                site = f"{path.replace(os.sep, '/')}:{owner.get(id(node), '<module>')}"
                if _allowed(allow, rel, "source-forbidden", node.attr, 1, lambda: [site]):
                    continue
                findings.append(LintFinding(
                    rule="source-forbidden", where=f"{rel}:{node.lineno}",
                    message=(f"`{_SOURCE_FORBIDDEN[key]}` — use the division-free "
                             "ckks.modular Barrett / Montgomery helpers instead"),
                ))
    return findings


__all__ = [
    "LintFinding",
    "Allow",
    "ALLOWLIST",
    "UNPORTED_REGIONS",
    "lint_fn",
    "exact_int_regions",
    "lint_exact_regions",
    "range_probes",
    "lint_range_probes",
    "lint_round_programs",
    "check_donation",
    "check_tree_donations",
    "source_sweep",
]
