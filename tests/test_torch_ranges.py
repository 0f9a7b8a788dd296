"""The port's interval interpreter over traced torch graphs
(`hefl_tpu_torch.analysis.ranges.eval_graph_ranges`), its nine range probes
and its certifiers, held against the JAX package's `eval_jaxpr_ranges` and
certifiers on the same probes and points.

The JAX certifiers run under the `jax_x64` stand-in (tests/torch_jax_x64.py,
which every `test_torch_*` file that needs it imports).
"""

import dataclasses
from pathlib import Path

import jax
import pytest
import torch

from hefl_tpu import he_inference as jhe
from hefl_tpu.analysis import cli as jcli
from hefl_tpu.analysis import ranges as jranges
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks import quantize as jquantize
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.fl import stream as jstream
from hefl_tpu.hhe import cipher as jcipher

from hefl_tpu_torch import he_inference
from hefl_tpu_torch.analysis import cli as gate
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import keys, ops, quantize
from hefl_tpu_torch.fl import secure, stream
from hefl_tpu_torch.hhe import cipher

from torch_jax_x64 import jax_x64  # noqa: F401  (the JAX certifiers' stand-in)

REPO = Path(__file__).resolve().parent.parent
P27 = 2**27 - 39
P31 = 2**31 - 1
I = ranges.Interval
CANON = I(0, P27 - 1)
COUNT = I(0, ranges.LOOP_COUNT_CEILING)
WALL = I(-((1 << 62) - 1), (1 << 62) - 1)


def _jax_result(x64, fn, args, ivs, **kw):
    with x64():
        closed = jax.make_jaxpr(fn)(*args)
    return jranges.eval_jaxpr_ranges(closed, [jranges.Interval(i.lo, i.hi) for i in ivs], **kw)


def _ivs(ivs):
    return [(iv.lo, iv.hi) for iv in ivs]


def _finding(f):
    return f.kind, f.op, (f.interval.lo, f.interval.hi), (f.bound.lo, f.bound.hi)


# (port module, JAX module, probe name, args, input intervals, analysis kwargs)
PROBES = {
    "packing": (quantize, jquantize, "packing_sum_probe", (8, 2, 9, 17, 2),
                [ranges.TOP, I(-32767, 32767)], {"ceiling": WALL}),
    "packing-unsafe": (quantize, jquantize, "packing_sum_probe", (2, 16, 3, 17, 2),
                       [ranges.TOP, I(-32767, 32767)], {"ceiling": WALL}),
    "lazy-sum": (secure, jsecure, "lazy_sum_chunk_probe", (32,), [CANON], {}),
    "fold": (stream, jstream, "fold_loop_probe", (P27,), [COUNT, CANON, CANON], {}),
    "fold-wide": (stream, jstream, "fold_loop_probe", ((1 << 62) + 135,),
                  [COUNT, I(0, (1 << 62) + 134), I(0, (1 << 62) + 134)], {}),
    "keyswitch": (ops, jops, "keyswitch_gadget_probe", (P27, 9, 3), [CANON] * 3,
                  {"ceiling": WALL}),
    "keyswitch-wide": (ops, jops, "keyswitch_gadget_probe", ((1 << 40) + 15, 20, 2),
                       [I(0, (1 << 40) + 14)] * 3, {"ceiling": WALL}),
    "hoisted": (ops, jops, "hoisted_gadget_probe", (P27, 5, 6),
                [COUNT, CANON, CANON, CANON, CANON, COUNT], {"ceiling": WALL}),
    "ladder": (he_inference, jhe, "rotation_ladder_range_probe", (P27, 9, 3),
               [COUNT, CANON, CANON, CANON, CANON, COUNT], {"ceiling": WALL}),
    "ladder-digit-above-prime": (he_inference, jhe, "rotation_ladder_range_probe", (P27, 28, 1),
                                 [COUNT, CANON, CANON, CANON, CANON, COUNT], {"ceiling": WALL}),
    "mlp": (he_inference, jhe, "mlp_bsgs_range_probe", (P27, 5, 6),
            [COUNT, COUNT, CANON, CANON, CANON, CANON, COUNT, CANON], {"ceiling": WALL}),
    "transcipher": (cipher, jcipher, "transcipher_sum_probe", (8, 2, 9, 17, 2),
                    [ranges.TOP, I(0, 1), I(-32767, 32767)],
                    {"ceiling": I(-(2**80 - 1), 2**80 - 1), "check_dtype": False}),
    "keystream-counter": (cipher, jcipher, "keystream_counter_probe", (),
                          [COUNT, I(0, 2**32 - 1), I(2**32 - 1, 2**32 - 1)]
                          + [I(0, 2**31 - 1)] * 4, {}),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_ranges_are_the_jax_interpreters(name, jax_x64):
    mod, jmod, probe, args, ivs, kw = PROBES[name]
    fn, example = getattr(mod, probe)(*args, "cpu")
    got = ranges.eval_graph_ranges(ranges.trace_graph(fn, example), ivs, **kw)
    want = _jax_result(jax_x64, *getattr(jmod, probe)(*args), ivs, **kw)
    assert _ivs(got.out_intervals) == _ivs(want.out_intervals)
    assert [repr(iv) for iv in got.out_intervals] == [repr(iv) for iv in want.out_intervals]
    assert [_finding(f) for f in got.findings] == [_finding(f) for f in want.findings]

    def loop(rep):
        return rep.op, rep.mode, rep.length, rep.widened, rep.narrowed, rep.rounds

    assert [loop(r) for r in got.loops] == [loop(r) for r in want.loops]
    assert got.notes == want.notes == []
    if name != "keystream-counter":
        # Each aten op is counted as the primitives jnp lowers it to, so the
        # positions and messages are the JAX interpreter's. The counter
        # probe runs the port's `add_packed_mod`, whose int32 words widen to
        # int64 (four converts the uint32 JAX words do not need).
        assert [r.eqn_index for r in got.loops] == [r.eqn_index for r in want.loops]
        assert [f.message for f in got.findings] == [f.message for f in want.findings]
    if name.endswith(("-unsafe", "-wide", "-above-prime")):
        assert got.findings or any(iv.hi > CANON.hi for iv in got.out_intervals)


def _strings(cert):
    return cert.summary(), tuple(cert.checks), tuple(str(f) for f in cert.findings)


def _fields(cert):
    return {f.name: getattr(cert, f.name) for f in dataclasses.fields(cert)
            if f.name not in ("findings", "checks")}


def _same_certificate(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in
                                                         dataclasses.fields(want)]
    assert _fields(got) == _fields(want)
    assert _strings(got) == _strings(want)
    assert [_finding(f) for f in got.findings] == [_finding(f) for f in want.findings]


@pytest.fixture(scope="module")
def default_q():
    return gate._default_ring()[0]


@pytest.mark.parametrize("certify", ["certify_packing", "certify_transciphering"])
@pytest.mark.parametrize("clients", [2, 32, 1024])
@pytest.mark.parametrize("bits", jcli.GRID_BITS)
def test_packing_and_transciphering_are_the_jax_certificates(bits, clients, certify, default_q,
                                                             jax_x64):
    k = quantize.max_interleave(default_q, bits, clients, gate.GRID_GUARD)
    assert k == jquantize.max_interleave(default_q, bits, clients, gate.GRID_GUARD)
    for kk in (k, k + 1):
        got = getattr(ranges, certify)(default_q, bits, kk, clients, gate.GRID_GUARD)
        want = getattr(jranges, certify)(default_q, bits, kk, clients, gate.GRID_GUARD)
        _same_certificate(got, want)
        assert got.ok == (kk == k) or certify == "certify_transciphering"
    if certify == "certify_packing":
        # k + 1 is refuted, naming the same op as the JAX certificate.
        assert got.findings and {f.op for f in got.findings} <= {"shift_left", "add", "scan"}


def _gadgets():
    out = []
    for n in (256, 1024):
        ctx = keys.CkksContext.create(n=n)
        out.append((max(int(p) for p in ctx.ntt.p.reshape(-1)), ctx.ksk_digit_bits,
                    ctx.ksk_num_digits))
    # a digit width above the prime; an oversized prime (products past 2**62)
    return out + [(P27, 28, 1), ((1 << 40) + 15, 20, 2), ((1 << 62) + 135, 9, 7)]


@pytest.mark.parametrize("gadget", _gadgets(), ids=["n256", "n1024", "w28", "p41", "p63"])
@pytest.mark.parametrize("certify", ["certify_keyswitch", "certify_inference"])
def test_keyswitch_and_inference_are_the_jax_certificates(certify, gadget, jax_x64):
    got = getattr(ranges, certify)(*gadget)
    want = getattr(jranges, certify)(*gadget)
    _same_certificate(got, want)
    assert got.ok == (gadget[0] < 1 << 31 and (1 << gadget[1]) <= gadget[0])


@pytest.mark.parametrize("prime", [P27, P31])
@pytest.mark.parametrize("certify", ["certify_fold_inductive", "certify_fold_tree"])
def test_folds_are_the_jax_certificates(certify, prime, jax_x64):
    _same_certificate(getattr(ranges, certify)(prime), getattr(jranges, certify)(prime))


def test_packed_fold_leg_is_the_jax_certificate(jax_x64):
    from hefl_tpu_torch.ckks.packing import probe_spec

    q = keys.CkksContext.create(n=256).modulus
    for k in (2, 16):
        spec = probe_spec(bits=8, k=k, clients=8)
        _same_certificate(ranges.certify_fold_inductive(P27, spec, q),
                          jranges.certify_fold_inductive(P27, spec, q))


PSUM = ("psum_mod[", "psum_mod 2-D[")


@pytest.mark.parametrize("prime", [P27, P31])
def test_aggregation_is_the_jax_certificate_but_the_psum_legs(prime, jax_x64):
    # Every leg is the JAX certificate's, the psum legs (2 and 2b) included:
    # string for string at 27-bit primes; at 31 bits the lazy chunk and the
    # lazy all-reduce overflow the JAX package's uint32 carriers but not the
    # port's int64 ones (`fl.secure.lazy_sum_mod`, `parallel.psum_mod`), and
    # the port's checks carry the JAX findings' intervals.
    got, want = ranges.certify_aggregation(prime), jranges.certify_aggregation(prime)
    assert (got.prime_bits, got.chunk) == (want.prime_bits, want.chunk)
    fold = ranges.certify_fold_inductive(prime)
    assert [c for c in got.checks if not c.startswith(("lazy_sum_mod",) + PSUM)] == [
        c for c in want.checks if not c.startswith(("lazy_sum_mod",) + PSUM)] == list(
        fold.checks)
    legs = ("lazy_sum_mod chunk", "psum_mod[32 participants]", "psum_mod 2-D[32 clients x 32 ct]")
    mine = [c for c in got.checks if c.startswith(legs)]
    assert [c.split(" stays in ")[0] for c in mine] == list(legs)
    if prime == P27:
        assert got.ok and want.ok and not want.findings
        assert mine == [c for c in want.checks if c.startswith(legs)]
    else:
        assert got.ok and not want.ok
        for leg, check in zip(legs, mine):
            jf = [f for f in want.findings if f.message.startswith(leg + ": ")]
            assert jf and jf[0].op in ("reduce_sum", "psum")
            assert check == f"{leg} stays in {jf[0].interval}"
            assert jf[0].bound == jranges.Interval(0, 2**32 - 1) and jf[0].interval.hi < 2**63


def test_certificates_are_memoised_and_device_keyed():
    assert ranges.certify_inference(P27, 9, 3) is ranges.certify_inference(P27, 9, 3)
    cpu = ranges.certify_keyswitch(P27, 9, 3, device="cpu")
    assert ranges.certify_keyswitch(P27, 9, 3, device="cpu") is cpu
    assert ranges.certify_keyswitch(P27, 9, 3) == cpu


def test_certified_max_interleave_is_the_jax_search(jax_x64):
    q = keys.CkksContext.create(n=256).modulus
    for clients in (2, 256):
        assert ranges.certified_max_interleave(q, 8, clients, 16) == \
            jranges.certified_max_interleave(q, 8, clients, 16)


# ---- the interpreter on seeded bugs and unsupported ops ------------------------------


def test_a_widened_shift_is_refuted_at_the_shift(monkeypatch):
    from torch._higher_order_ops.scan import scan_op

    q = keys.CkksContext.create(n=4096).modulus
    k = quantize.max_interleave(q, 8, 8, 16)
    assert ranges.certify_packing(q, 8, k, 8, 16).ok

    real = quantize.packing_sum_probe

    def widened(bits, k, fbits, guard, clients, device="cpu"):
        # packing_sum_probe with every field shifted 16 bits further
        _, args = real(bits, k, fbits, guard, clients, device)

        def probe(x, noise):
            u = (quantize.quantize(x, 1.0, bits) + quantize.qmax(bits)).to(torch.int64)

            def fold(fs, ns, tot, u_c, n_c):
                packed_c = torch.zeros((2,), dtype=torch.int64)
                for j in range(k):
                    packed_c = packed_c + (u_c[j] << (guard + j * fbits + 16))
                return [fs + u_c, ns + n_c, tot + packed_c + n_c]

            zm = torch.zeros((2,), dtype=torch.int64)
            return tuple(scan_op(fold, [torch.zeros((k, 2), dtype=torch.int64), zm,
                                        zm.clone()], [u, noise], ()))

        return probe, args

    monkeypatch.setattr(quantize, "packing_sum_probe", widened)
    bad = ranges.certify_packing.__wrapped__(q, 8, k, 8, 16)
    assert not bad.ok and bad.findings[0].op == "shift_left"
    assert bad.findings[0].kind == "ceiling" and "`shift_left` (eqn" in str(bad.findings[0])
    assert "UNSAFE — `shift_left` (eqn" in bad.summary()


def test_a_double_counted_row_in_the_fold_is_refuted(monkeypatch):
    from torch._higher_order_ops.while_loop import while_loop_op

    real = stream.fold_loop_probe

    def double_counted(prime, device="cpu"):
        # fold_loop_probe with the row added again after the reduction
        _, args = real(prime, device)
        p = torch.tensor([[int(prime)]], dtype=torch.int64)

        def cond(remaining, a, row, p):
            return remaining > 0

        def body(remaining, a, row, p):
            return remaining - 1, (row + a) % p + row

        return (lambda count, acc, row: while_loop_op(cond, body, (count, acc),
                                                      (row, p))[1]), args

    monkeypatch.setattr(stream, "fold_loop_probe", double_counted)
    bad = ranges.certify_fold_inductive.__wrapped__(P27)
    assert not bad.ok and [(f.kind, f.op) for f in bad.findings] == [("output-bound", "while")]
    assert str(bad.findings[0]) == (
        f"OnlineAccumulator fold: carried sum reaches [0, {2 * (P27 - 1)}], escaping the "
        f"canonical residue range [0, {P27 - 1}]")


def test_an_unsupported_op_is_unbounded_with_a_note():
    def fn(x):
        return torch.cumprod(x, 0) + 1

    res = ranges.eval_graph_ranges(ranges.trace_graph(fn, (torch.zeros(4, dtype=torch.int64),)),
                                   [I(0, 3)])
    assert res.out_intervals == [ranges.TOP]
    assert res.notes == ["unsupported op `aten.cumprod`: output unbounded"]
    assert [f.op for f in res.findings][:1] == ["aten.cumprod"]


def test_tracing_is_fake_and_survives_an_unsafe_shift():
    fn, args = quantize.packing_sum_probe(2, 40, 3, 17, 2)    # shifts past 63
    gm = ranges.trace_graph(fn, args)
    assert torch.ops.higher_order.scan in {n.target for n in gm.graph.nodes}
    assert all(not isinstance(v, torch._subclasses.FakeTensor)
               for v in gm.state_dict().values())


def test_cond_joins_both_branches(jax_x64):
    def fn(pred, x):
        return torch.cond(pred, lambda v: v * 3, lambda v: v + 100, (x,))

    gm = ranges.trace_graph(fn, (torch.tensor(True), torch.zeros(2, dtype=torch.int64)))
    res = ranges.eval_graph_ranges(gm, [I(0, 1), I(0, 10)])
    assert _ivs(res.out_intervals) == [(0, 110)]


# ---- the loop-overflow rule --------------------------------------------------------------


def test_loop_overflow_fixture_is_the_jax_finding(capsys):
    import json

    path = REPO / "hefl_tpu_torch" / "analysis" / "fixtures" / "violation_loop_overflow.py"
    assert gate.main(["--fixture", str(path), "--json", "--device", "cpu"]) == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = [line["message"] for line in lines if line["type"] == "finding"]
    want = [f.message for f in jcli.run_fixture(
        str(REPO / "tests" / "fixtures" / "lint" / "violation_loop_overflow.py"))]
    assert got == want and got[0].startswith("`add` (eqn ")
    assert all(line["rule"] == "loop-overflow" for line in lines if line["type"] == "finding")
    # kind and op of the interpreter's findings, both packages
    fn, args = _load(path).build("cpu")
    res = ranges.eval_graph_ranges(ranges.trace_graph(fn, args),
                                   [ranges._array_interval(a) for a in args])
    jfn, jargs = _load(REPO / "tests" / "fixtures" / "lint" / "violation_loop_overflow.py").build()
    jres = jranges.eval_jaxpr_ranges(jax.make_jaxpr(jfn)(*jargs),
                                     [jranges._array_interval(a) for a in jargs])
    assert [(f.kind, f.op) for f in res.findings] == [(f.kind, f.op) for f in jres.findings]
    assert res.findings[0].kind == "dtype-overflow" and res.findings[0].op == "add"
    assert [(r.op, r.mode, r.widened) for r in res.loops] == [("scan", "fixpoint", True)]


def _load(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
