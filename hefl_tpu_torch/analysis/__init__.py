"""Static analysis of the port's HE/FL pipeline, counterpart of
`hefl_tpu.analysis`:

  * :mod:`hefl_tpu_torch.analysis.ranges` — interval abstract
    interpretation over traced aten graphs (`eval_graph_ranges`, the
    counterpart of `eval_jaxpr_ranges`), with loop fixpoints over
    `while_loop` / `scan`: proves the packed-aggregation headroom, the
    aggregation and streaming-fold no-wrap bounds, the hybrid-HE
    transciphering and the serving programs for ALL inputs, or names the
    overflowing op, with the JAX certificates' fields and messages;
  * :mod:`hefl_tpu_torch.analysis.lint` — forbidden-primitive,
    float-contamination, f64, host-callback (a device-to-host sync),
    donation (an in-place accumulator) and source-sweep rules over the aten
    ops the real code dispatches, with a justified per-rule allowlist;
  * :mod:`hefl_tpu_torch.analysis.coverage` — every convolution or matrix
    product of a round or a serving score attributed to a `hefl.*` phase.

`check_experiment` is the pre-flight the experiment driver and the CLI run
before any training work; `check_inference` is its serving twin. Both
publish the `analysis.violations` counter (0 on a healthy configuration)
and an `analysis_check` event, and raise AnalysisError naming the violated
fact. `python -m hefl_tpu_torch.analysis` runs the whole-tree gate
(`analysis.cli`).
"""

from __future__ import annotations

from hefl_tpu_torch.analysis import coverage, lint, ranges
from hefl_tpu_torch.analysis.lint import ALLOWLIST, Allow, LintFinding
from hefl_tpu_torch.analysis.ranges import (
    AggregationCertificate,
    FoldCertificate,
    InferenceCertificate,
    Interval,
    KeyswitchCertificate,
    LoopReport,
    PackingCertificate,
    RangeFinding,
    TranscipherCertificate,
    certified_max_interleave,
    certify_aggregation,
    certify_fold_inductive,
    certify_fold_tree,
    certify_inference,
    certify_keyswitch,
    certify_packing,
    certify_transciphering,
    eval_graph_ranges,
)


class AnalysisError(ValueError):
    """A static invariant violation in a configuration."""


def _publish(certs: list, violations: int) -> None:
    from hefl_tpu_torch.obs import events as obs_events
    from hefl_tpu_torch.obs import metrics as obs_metrics

    # inc(0) registers the counter: a clean pre-flight leaves
    # analysis.violations = 0 in the artifacts as evidence that it ran.
    obs_metrics.counter("analysis.violations").inc(violations)
    obs_events.emit("analysis_check", violations=violations,
                    certified=[c.summary() for c in certs])


def check_experiment(cfg, ctx=None, say=None) -> dict:
    """Pre-flight of one ExperimentConfig, the counterpart of the JAX
    package's `check_experiment`, before any dataset or device work:

      * the aggregation no-wrap bounds (`certify_aggregation`) at the ring's
        largest prime, for every encrypted, non-centralized run;
      * for a streaming run, the inductive fold invariant
        (`certify_fold_inductive`), whose findings the aggregation
        certificate already carries, so it is left out of the count;
      * the packed headroom (`certify_packing`) when packing is on, and the
        hybrid-HE transciphering (`certify_transciphering`) for an HHE
        upload.

    Publishes `analysis.violations` and an `analysis_check` event, then
    raises AnalysisError naming the failed certificate. `ctx` reuses a built
    CkksContext; without it the primes come from `find_ntt_primes`, a
    deterministic function of the ring. -> {"aggregation", "packing",
    "transciphering", "fold"}: certificates or None."""
    report: dict = {"aggregation": None, "packing": None, "transciphering": None,
                    "fold": None}
    certs = []
    if getattr(cfg, "encrypted", True) and not getattr(cfg, "centralized", False):
        if ctx is not None:
            import numpy as np

            modulus = int(ctx.modulus)
            max_prime = int(np.asarray(ctx.ntt.p).max())
        else:
            from hefl_tpu_torch.ckks.primes import find_ntt_primes

            primes = find_ntt_primes(cfg.he.num_primes, cfg.he.prime_bits, 2 * cfg.he.n)
            modulus = 1
            for p in primes:
                modulus *= p
            max_prime = max(primes)
        agg = certify_aggregation(max_prime)
        report["aggregation"] = agg
        certs.append(agg)
        stream = getattr(cfg, "stream", None)
        if stream is not None:
            fold = certify_fold_inductive(max_prime)
            report["fold"] = fold
            certs.append(fold)
        packing = getattr(cfg, "packing", None)
        if packing is not None and packing.enabled:
            from hefl_tpu_torch.ckks.quantize import max_interleave

            clients = int(cfg.num_clients)
            k = packing.interleave or max_interleave(modulus, packing.bits, clients,
                                                     packing.guard_bits)
            pk_cert = certify_packing(modulus, packing.bits, k, clients, packing.guard_bits)
            report["packing"] = pk_cert
            certs.append(pk_cert)
            if stream is not None and getattr(stream, "upload_kind", "ckks") == "hhe":
                tc_cert = certify_transciphering(modulus, packing.bits, k, clients,
                                                 packing.guard_bits)
                report["transciphering"] = tc_cert
                certs.append(tc_cert)

    violations = sum(len(c.findings) for c in certs if c is not report["fold"])
    _publish(certs, violations)
    if violations:
        bad = next(c for c in certs if not c.ok)
        raise AnalysisError(f"static analysis rejected this configuration — {bad.summary()}")
    if say is not None and certs:
        say(f"analysis: {'; '.join(c.summary() for c in certs)}")
    return report


def check_inference(ctx, say=None) -> dict:
    """Pre-flight of one encrypted-inference serving ring, the counterpart
    of the JAX package's `check_inference`: certifies the serving programs
    (`certify_inference`) and the key-switch gadget (`certify_keyswitch`)
    at the context's largest prime and gadget, publishes the
    `analysis.violations` counter and the `analysis_check` event, and
    raises AnalysisError naming the violated fact.
    -> {"inference": certificate, "keyswitch": certificate}."""
    import numpy as np

    max_prime = int(np.asarray(ctx.ntt.p).max())
    gadget = (int(ctx.ksk_digit_bits), int(ctx.ksk_num_digits))
    certs = [certify_inference(max_prime, *gadget), certify_keyswitch(max_prime, *gadget)]
    violations = sum(len(c.findings) for c in certs)
    _publish(certs, violations)
    if violations:
        bad = next(c for c in certs if not c.ok)
        raise AnalysisError(f"static analysis rejected this serving ring — {bad.summary()}")
    if say is not None:
        say(f"analysis: {'; '.join(c.summary() for c in certs)}")
    return {"inference": certs[0], "keyswitch": certs[1]}


__all__ = [
    "AnalysisError",
    "check_experiment",
    "check_inference",
    "ranges",
    "lint",
    "coverage",
    "Interval",
    "RangeFinding",
    "LoopReport",
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
    "eval_graph_ranges",
    "LintFinding",
    "Allow",
    "ALLOWLIST",
]
