"""The port's serving pre-flight (`analysis.check_inference`) and its
certificates `certify_keyswitch` / `certify_inference`, traced range
probes under the interval interpreter.

Each is held against the JAX certifier under the `jax_x64` stand-in
(tests/torch_jax_x64.py): the same fields, summary, checks and
findings, string for string, on the default gadget of every serving ring,
a digit width above the prime and a prime whose products leave the
2**62 wall.
"""

import dataclasses

import pytest

from hefl_tpu.analysis import ranges as jranges

from hefl_tpu_torch.analysis import AnalysisError, check_inference, ranges
from hefl_tpu_torch.ckks.keys import CkksContext
from hefl_tpu_torch.obs import metrics as obs_metrics

from torch_jax_x64 import jax_x64  # noqa: F401  (the JAX certifiers' stand-in)

P27 = 2**27 - 39


def _same(got, want):
    assert got.summary() == want.summary() and got.checks == want.checks
    assert [str(f) for f in got.findings] == [str(f) for f in want.findings]
    assert [(f.kind, f.op) for f in got.findings] == [(f.kind, f.op) for f in want.findings]


def test_certificates_carry_the_jax_fields():
    for cls in ("KeyswitchCertificate", "InferenceCertificate"):
        want = [f.name for f in dataclasses.fields(getattr(jranges, cls))]
        assert [f.name for f in dataclasses.fields(getattr(ranges, cls))] == want


@pytest.mark.parametrize("n,num_primes", [(256, 3), (4096, 3), (8192, 5)])
def test_default_gadgets_certified(n, num_primes, jax_x64):
    ctx = CkksContext.create(n=n, num_primes=num_primes)
    base = obs_metrics.snapshot().get("analysis.violations", 0)
    report = check_inference(ctx)
    assert report["inference"].ok and report["keyswitch"].ok
    assert obs_metrics.snapshot()["analysis.violations"] == base
    p = max(int(v) for v in ctx.ntt.p.reshape(-1))
    gadget = (p, ctx.ksk_digit_bits, ctx.ksk_num_digits)
    _same(report["keyswitch"], jranges.certify_keyswitch(*gadget))
    _same(report["inference"], jranges.certify_inference(*gadget))
    ks, inf = report["keyswitch"].summary(), report["inference"].summary()
    assert ks.startswith(f"keyswitch gadget p<2**27 (w={ctx.ksk_digit_bits} "
                         f"d={ctx.ksk_num_digits}): CERTIFIED — ")
    assert inf.startswith(f"inference ladder p<2**27 gadget(w={ctx.ksk_digit_bits} "
                          f"d={ctx.ksk_num_digits}) depth<=2**48: CERTIFIED — ")
    assert "base-2**w" in ks and "sub_mod precondition" in ks and "2**62 wall" in ks
    assert any("any ladder depth" in c for c in report["inference"].checks)
    assert any("hoisted sweep" in c for c in report["inference"].checks)


def test_digit_width_above_the_prime_refuted_by_name(jax_x64):
    cert = ranges.certify_keyswitch(P27, 31, 1)
    _same(cert, jranges.certify_keyswitch(P27, 31, 1))
    assert not cert.ok
    # The mask caps the digit at p - 1, but centring by 2**30 > p leaves the
    # correction's canonical range.
    assert [(f.kind, f.op, f.message.split(":")[0]) for f in cert.findings] == [
        ("output-bound", "select_n", "accumulated c0 correction"),
        ("output-bound", "select_n", "accumulated c1 correction")]
    assert "UNSAFE" in cert.summary()
    inf = ranges.certify_inference(P27, 28, 1)
    _same(inf, jranges.certify_inference(P27, 28, 1))
    assert not inf.ok
    # Canonical inputs cap the uncentered digits at p - 1; it is the centred
    # key-switch of the ladder and the MLP that leaves [0, p-1].
    assert [f.message.split(":")[0] for f in inf.findings] == [
        "carried c0 residues (any ladder depth)", "carried c1 residues (any ladder depth)",
        "mlp compose"]


def test_oversized_prime_refuted_naming_the_product(jax_x64):
    for certify in ("certify_keyswitch", "certify_inference"):
        cert = getattr(ranges, certify)((1 << 32) + 15, 9, 4)
        _same(cert, getattr(jranges, certify)((1 << 32) + 15, 9, 4))
        assert not cert.ok
        assert any(f.kind == "ceiling" and f.op == "mul" for f in cert.findings)
        assert "`mul` (eqn" in cert.summary()
    assert ranges.certify_inference(P27, 5, 6).ok


def test_check_inference_raises_and_counts_violations(jax_x64):
    ctx = dataclasses.replace(CkksContext.create(n=256), ksk_digit_bits=28)
    p = max(int(v) for v in ctx.ntt.p.reshape(-1))
    want = jranges.certify_inference(p, 28, ctx.ksk_num_digits)
    base = obs_metrics.snapshot().get("analysis.violations", 0)
    with pytest.raises(AnalysisError) as exc:
        check_inference(ctx)
    assert str(exc.value) == f"static analysis rejected this serving ring — {want.summary()}"
    assert "carried c0 residues (any ladder depth): `while` yields" in str(exc.value)
    assert obs_metrics.snapshot()["analysis.violations"] > base
