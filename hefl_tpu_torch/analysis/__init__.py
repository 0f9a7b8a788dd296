"""Parameter-level integer certificates (closed form), counterpart of
`hefl_tpu.analysis`'s range certificates, and the serving pre-flight
`check_inference`."""

from __future__ import annotations


class AnalysisError(ValueError):
    """A static invariant violation in a configuration."""


def check_inference(ctx, say=None) -> dict:
    """Pre-flight of one encrypted-inference serving ring, the counterpart
    of the JAX package's `check_inference`: certifies the serving programs
    (`ranges.certify_inference`) and the key-switch gadget
    (`ranges.certify_keyswitch`) at the context's largest prime and gadget,
    publishes the `analysis.violations` counter and the `analysis_check`
    event, and raises AnalysisError naming the violated fact.
    -> {"inference": certificate, "keyswitch": certificate}."""
    import numpy as np

    from hefl_tpu_torch.analysis.ranges import certify_inference, certify_keyswitch
    from hefl_tpu_torch.obs import events as obs_events
    from hefl_tpu_torch.obs import metrics as obs_metrics

    max_prime = int(np.asarray(ctx.ntt.p).max())
    gadget = (int(ctx.ksk_digit_bits), int(ctx.ksk_num_digits))
    certs = [certify_inference(max_prime, *gadget), certify_keyswitch(max_prime, *gadget)]
    violations = sum(len(c.findings) for c in certs)
    # inc(0) registers the counter: a clean pre-flight leaves
    # analysis.violations = 0 in the artifacts as evidence that it ran.
    obs_metrics.counter("analysis.violations").inc(violations)
    obs_events.emit("analysis_check", violations=violations,
                    certified=[c.summary() for c in certs])
    if violations:
        bad = next(c for c in certs if not c.ok)
        raise AnalysisError(f"static analysis rejected this serving ring — {bad.summary()}")
    if say is not None:
        say(f"analysis: {'; '.join(c.summary() for c in certs)}")
    return {"inference": certs[0], "keyswitch": certs[1]}
