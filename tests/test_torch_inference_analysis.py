"""The port's serving pre-flight (`analysis.check_inference`) and its
closed-form certificates `certify_keyswitch` / `certify_inference`.

They carry the JAX certificates' fields and summary heads, accept the
default gadgets of every serving ring, and refute a digit width above the
prime and a prime whose products leave the carriers, naming the fact.
"""

import dataclasses

import pytest

from hefl_tpu.analysis import ranges as jranges

from hefl_tpu_torch.analysis import AnalysisError, check_inference, ranges
from hefl_tpu_torch.ckks.keys import CkksContext
from hefl_tpu_torch.obs import metrics as obs_metrics

P27 = 2**27 - 39


def test_certificates_carry_the_jax_fields():
    for cls in ("KeyswitchCertificate", "InferenceCertificate"):
        want = [f.name for f in dataclasses.fields(getattr(jranges, cls))]
        assert [f.name for f in dataclasses.fields(getattr(ranges, cls))] == want


@pytest.mark.parametrize("n,num_primes", [(256, 3), (4096, 3), (8192, 5)])
def test_default_gadgets_certified(n, num_primes):
    ctx = CkksContext.create(n=n, num_primes=num_primes)
    base = obs_metrics.snapshot().get("analysis.violations", 0)
    report = check_inference(ctx)
    assert report["inference"].ok and report["keyswitch"].ok
    assert obs_metrics.snapshot()["analysis.violations"] == base
    ks, inf = report["keyswitch"].summary(), report["inference"].summary()
    assert ks.startswith(f"keyswitch gadget p<2**27 (w={ctx.ksk_digit_bits} "
                         f"d={ctx.ksk_num_digits}): CERTIFIED — ")
    assert inf.startswith(f"inference ladder p<2**27 gadget(w={ctx.ksk_digit_bits} "
                          f"d={ctx.ksk_num_digits}) depth<=2**48: CERTIFIED — ")
    assert "base-2**w" in ks and "sub_mod precondition" in ks and "2**62 wall" in ks
    assert any("any ladder depth" in c for c in report["inference"].checks)
    assert any("hoisted sweep" in c for c in report["inference"].checks)


def test_digit_width_above_the_prime_refuted_by_name():
    cert = ranges.certify_keyswitch(P27, 31, 1)
    assert not cert.ok
    assert any("gadget digits canonical" in f for f in cert.findings)
    assert "UNSAFE" in cert.summary() and "sub_mod precondition" in cert.summary()
    inf = ranges.certify_inference(P27, 28, 1)
    assert not inf.ok
    assert any("hoisted sweep: uncentered gadget digits" in f for f in inf.findings)


def test_oversized_prime_refuted_naming_the_product():
    for cert in (ranges.certify_keyswitch((1 << 32) + 15, 9, 4),
                 ranges.certify_inference((1 << 32) + 15, 9, 4)):
        assert not cert.ok
        assert any("digit x key product (mul)" in f for f in cert.findings)
    assert ranges.certify_inference(P27, 5, 6).ok


def test_check_inference_raises_and_counts_violations():
    ctx = dataclasses.replace(CkksContext.create(n=256), ksk_digit_bits=28)
    base = obs_metrics.snapshot().get("analysis.violations", 0)
    with pytest.raises(AnalysisError, match="serving ring .*gadget digits canonical"):
        check_inference(ctx)
    assert obs_metrics.snapshot()["analysis.violations"] > base
