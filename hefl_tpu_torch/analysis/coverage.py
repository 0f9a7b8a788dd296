"""Named-scope coverage: every leaf compute op attributed to a phase.

Counterpart of `hefl_tpu.analysis.coverage`, with its names. The port's trace
attribution (`obs.trace`) rests on one structural guarantee: every
convolution and matrix product of a round, and every gather of a serving
score, runs inside a `hefl.*` `record_function` range (`obs.scopes`), so
the profiler's device time joins back to phases. The JAX module checks the
name stacks of a jaxpr and the op_name metadata of compiled HLO; eager
PyTorch has neither, so this one RUNS the real program under
`torch.profiler` and checks the trace: every `aten::convolution`,
`aten::mm`, `aten::addmm`, `aten::bmm` and `aten::linear` event (plus
`aten::index_select`, `aten::gather` and `aten::take` for serving) must
have a `hefl.*` phase range among its CPU ancestors (`obs.scopes.scope_of`
of the ranges open around it: on its own thread, else on another thread of
the process, as the autograd engine's device thread runs the backward
while the caller waits in its range). A refactor that hoists a convolution
out of its range fails here. A kernel launched from inside such an op
resolves to the same ranges through `obs.trace`'s join, so it needs no
check of its own; kernels whose launch the profiler did not record are
exempt, as the JAX module exempts HLO without metadata, and are counted as
`unattributed` (`obs.trace`'s `unlinked`).

The leaf set is where device time lives; copies, random draws and glue are
free or counted as `unattributed` by `obs.trace`, and requiring ranges on
them would annotate infrastructure that has no phase.
"""

from __future__ import annotations

import tempfile

import torch

from hefl_tpu_torch.analysis.lint import LintFinding

# The round programs' leaf compute ops (the profiler's aten names).
LEAF_PRIMS = ("aten::convolution", "aten::mm", "aten::addmm", "aten::bmm", "aten::linear")
# The serving programs' leaf set: encrypted inference has no GEMM/conv
# stream; its device time is the Montgomery pointwise chains and the
# automorphism GATHERS, so the gathers join the set there.
INFERENCE_LEAF_PRIMS = LEAF_PRIMS + ("aten::index_select", "aten::gather", "aten::take")


def _phase_ranges(events: list[dict]):
    """The `hefl.*` phase ranges of a trace (not PhaseTimer's, the host
    spans or the profiler's priming range), as `obs.trace`'s lookup."""
    from hefl_tpu_torch.obs import scopes
    from hefl_tpu_torch.obs.trace import RANGE_CAT, _Ranges

    ranges = []
    for ev in events:
        name = str(ev.get("name") or "")
        if (ev.get("ph") == "X" and ev.get("cat") == RANGE_CAT and scopes.is_phase_scope(name)
                and not name.startswith(scopes.MODULE_PREFIX)
                and name not in scopes.HOST_SPANS and name != scopes.PROFILER_PRIME):
            ts = float(ev.get("ts", 0.0))
            ranges.append((ev.get("pid"), ev.get("tid"), ts, ts + float(ev.get("dur", 0.0)),
                           name))
    return _Ranges(ranges), sorted({r[4] for r in ranges})


def leaf_scope_findings(events: list[dict], where: str, *,
                        leaf_prims: tuple = LEAF_PRIMS) -> tuple[list[LintFinding], dict]:
    """missing-scope findings for one profiler trace's events (a
    `torch.profiler` Chrome trace): leaf host ops with no `hefl.*` range
    around them. -> (findings, {"leaf_ops", "unattributed", "scopes"}):
    the leaf ops checked, the kernels without a recorded launch (0 on a
    CPU trace), and the phase ranges the trace holds."""
    from hefl_tpu_torch.obs import scopes
    from hefl_tpu_torch.obs.trace import CPU_OP_CAT, _attribute

    phase_of, names = _phase_ranges(events)
    findings: list[LintFinding] = []
    leaf_ops = 0
    for ev in events:
        name = str(ev.get("name") or "")
        if ev.get("ph") != "X" or ev.get("cat") != CPU_OP_CAT or name not in leaf_prims:
            continue
        leaf_ops += 1
        tid, ts = ev.get("tid"), float(ev.get("ts", 0.0))
        if scopes.scope_of(phase_of.innermost(ev.get("pid"), tid, ts) or "") is None:
            findings.append(LintFinding(
                rule="missing-scope", where=where,
                message=(f"`{name}` ran with no hefl.* phase range around it (thread {tid}, "
                         f"ts {ts:.1f} us) — its device time would leak into the "
                         "unattributed bucket"),
            ))
    kernels = any(ev.get("ph") == "X" and ev.get("cat") == "kernel" for ev in events)
    stats = {"leaf_ops": leaf_ops, "unattributed": _attribute(events)["unlinked"] if kernels else 0,
             "scopes": names}
    return findings, stats


def check_fn_coverage(fn, args: tuple, where: str, *, leaf_prims: tuple = LEAF_PRIMS,
                      device="cpu", require_scopes: tuple = ()) -> list[LintFinding]:
    """The leaf rule for one function, run once under
    `obs.trace.round_profiler` on `device`; a trace that holds no leaf op
    at all, or lacks one of `require_scopes` (phase ranges that must
    appear), is a finding too."""
    from hefl_tpu_torch.obs.trace import find_trace_file, load_trace_events, round_profiler

    with tempfile.TemporaryDirectory(prefix="hefl_coverage_") as tmp:
        with round_profiler(tmp, device):
            fn(*args)
        events = load_trace_events(find_trace_file(tmp))
    findings, stats = leaf_scope_findings(events, where, leaf_prims=leaf_prims)
    if leaf_prims and stats["leaf_ops"] == 0:
        findings.append(LintFinding(
            rule="missing-scope", where=where,
            message=f"the trace holds no leaf op of {list(leaf_prims)}: nothing was checked"))
    for scope in require_scopes:
        if scope not in stats["scopes"]:
            findings.append(LintFinding(
                rule="missing-scope", where=where,
                message=(f"the trace holds no {scope!r} range — the phase would be "
                         "invisible to trace attribution")))
    return findings


def check_round_coverage(*, fusion: str = "vmap", secure: bool = False,
                         device="cpu") -> list[LintFinding]:
    """The whole-tree gate: the real round at the lint's tiny geometry
    (`lint._tiny_round_inputs`: on a card, medical-8's MedCNN and 8
    clients)."""
    from hefl_tpu_torch.analysis.lint import _tiny_cfg, _tiny_round_inputs

    model, params, xs, ys, classes = _tiny_round_inputs(device)
    cfg = _tiny_cfg(fusion, classes)
    gen = torch.Generator().manual_seed(1)
    if secure:
        from hefl_tpu_torch.ckks.keys import CkksContext, keygen
        from hefl_tpu_torch.fl.secure import secure_fedavg_round

        ctx = CkksContext.create(n=256)
        _, pk = keygen(ctx, torch.Generator().manual_seed(2), device=device)
        return check_fn_coverage(
            lambda: secure_fedavg_round(model, cfg, ctx, pk, params, xs, ys, gen), (),
            f"fl.secure.round[{fusion}]", device=device)
    from hefl_tpu_torch.fl.fedavg import fedavg_round

    return check_fn_coverage(lambda: fedavg_round(model, cfg, params, xs, ys, gen), (),
                             f"fl.fedavg.round[{fusion}]", device=device)


def check_stream_coverage(*, fusion: str = "vmap", device="cpu") -> list[LintFinding]:
    """The streaming engine's upload producer (`fl.secure.client_uploads`:
    train, sanitize and encrypt per client, no sum), the compute the
    durable aggregation server dispatches every round."""
    from hefl_tpu_torch.analysis.lint import _tiny_cfg, _tiny_round_inputs
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.fl.secure import client_uploads

    model, params, xs, ys, classes = _tiny_round_inputs(device)
    cfg = _tiny_cfg(fusion, classes)
    ctx = CkksContext.create(n=256)
    _, pk = keygen(ctx, torch.Generator().manual_seed(2), device=device)
    return check_fn_coverage(
        lambda: client_uploads(model, cfg, ctx, pk, params, xs, ys,
                               torch.Generator().manual_seed(1)),
        (), f"fl.stream.upload[{fusion}]", device=device)


def check_hhe_coverage(device="cpu") -> list[LintFinding]:
    """The hybrid-HE round programs: the HHE upload producer (train,
    sanitize, quantize-pack and stream-encrypt per client) and the server's
    transcipher of one batch (pad provisioning, embed, keystream
    subtract)."""
    from hefl_tpu_torch.analysis.lint import _tiny_cfg, _tiny_round_inputs
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackedSpec
    from hefl_tpu_torch.ckks.quantize import PackingConfig
    from hefl_tpu_torch.fl.secure import client_uploads
    from hefl_tpu_torch.hhe import cipher as hhe_cipher
    from hefl_tpu_torch.hhe import transcipher as hhe_transcipher
    from hefl_tpu_torch.obs import scopes

    model, params, xs, ys, classes = _tiny_round_inputs(device)
    clients = int(xs.shape[0])
    cfg = _tiny_cfg("vmap", classes)
    ctx = CkksContext.create(n=256)
    _, pk = keygen(ctx, torch.Generator().manual_seed(2), device=device)
    spec = PackedSpec.for_params(params, ctx, PackingConfig(bits=8, interleave=2, clip=0.5),
                                 clients)
    hk = hhe_cipher.derive_client_keys(0, clients)
    findings = check_fn_coverage(
        lambda: client_uploads(model, cfg, ctx, pk, params, xs, ys,
                               torch.Generator().manual_seed(1), packing=spec, hhe_keys=hk,
                               round_index=0),
        (), "fl.stream.upload[hhe]", device=device)

    def tc():
        gens = [torch.Generator(device=device).manual_seed(3 + c) for c in range(clients)]
        pad = hhe_transcipher.provision_pads(ctx, pk, hk, 0, spec.n_ct, enc_gens=gens)
        w = torch.zeros((clients, spec.n_ct, ctx.n), dtype=torch.int32, device=device)
        return hhe_transcipher.transcipher_core(ctx, w, w, pad.c0, pad.c1)

    # The transcipher has no GEMM, conv or gather: the presence of its
    # phase ranges is the check.
    findings += check_fn_coverage(tc, (), "hhe.transcipher[batch]", device=device,
                                  leaf_prims=(), require_scopes=(scopes.ENCRYPT,
                                                                 scopes.TRANSCIPHER))
    return findings


def check_inference_coverage(device="cpu") -> list[LintFinding]:
    """The encrypted-inference serving programs at a tiny ring (n = 256):
    the ladder linear scorer, the BSGS linear scorer and the composed
    two-layer BSGS MLP, each scored once under the profiler with the
    serving leaf set (GEMM/conv plus the automorphism gathers). On top of
    the leaf rule each must hold its phase ranges: `hefl.serve_rotate` and
    `hefl.serve_score` (the ladder's key-switches count in serve_rotate),
    and for the BSGS programs also `hefl.serve_keyswitch` and
    `hefl.serve_hoist`, which hold no leaf op of their own."""
    import numpy as np

    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, gen_relin_key, keygen
    from hefl_tpu_torch.obs import scopes

    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    ctx = CkksContext.create(n=256)
    sk, pk = keygen(ctx, gen, device=device)
    rng = np.random.default_rng(0)
    slots = encoding.num_slots(ctx.ntt)
    ladder = hei.LinearScorer(ctx, rng.normal(0, 0.3, (2, slots)), rng.normal(0, 0.2, (2,)),
                              hei.gen_rotation_keys(ctx, sk, 1), device=device)
    ct_x = hei.encrypt_features(ctx, pk, rng.normal(0, 0.5, (slots,)), gen)

    d_bsgs, num_k = 16, 2
    plan = hei.bsgs_plan(slots, d_bsgs, num_k)
    bsgs = hei.BsgsLinearScorer(
        ctx, rng.normal(0, 0.3, (num_k, d_bsgs)), rng.normal(0, 0.2, (num_k,)),
        hei.gen_rotation_keys_for_steps(ctx, sk, 3, plan.rotation_steps_needed), device=device)

    mctx = CkksContext.create(n=256, num_primes=5)
    msk, mpk = keygen(mctx, torch.Generator().manual_seed(7), device=device)
    d_mlp, hidden = 16, 4
    plan1, plan2 = hei.bsgs_mlp_plans(encoding.num_slots(mctx.ntt), d_mlp, hidden, num_k)
    sub_ctx = hei.mlp_sub_context(mctx, 2)
    mlp = hei.BsgsMlpScorer(
        mctx, rng.normal(0, 0.3, (hidden, d_mlp)), rng.normal(0, 0.2, (hidden,)),
        rng.normal(0, 0.3, (num_k, hidden)), rng.normal(0, 0.2, (num_k,)),
        hei.gen_rotation_keys_for_steps(mctx, msk, 5, plan1.rotation_steps_needed),
        gen_relin_key(mctx, msk, torch.Generator().manual_seed(4)),
        hei.gen_rotation_keys_for_steps(sub_ctx, hei.slice_secret_key(msk, sub_ctx.num_primes),
                                        6, plan2.rotation_steps_needed),
        device=device)
    ct_mx = hei.encrypt_features(mctx, mpk, rng.normal(0, 0.5, (d_mlp,)), gen)

    base = (scopes.SERVE_ROTATE, scopes.SERVE_SCORE)
    hoist = base + (scopes.SERVE_KEYSWITCH, scopes.SERVE_HOIST)
    findings: list[LintFinding] = []
    for name, fn, scopes_needed in (
        ("he_inference.serve[linear]", lambda: ladder.score_batched(ct_x), base),
        ("he_inference.serve[bsgs]", lambda: bsgs.score(ct_x), hoist),
        ("he_inference.serve[mlp_bsgs]", lambda: mlp.score(ct_mx), hoist),
    ):
        findings += check_fn_coverage(fn, (), name, leaf_prims=INFERENCE_LEAF_PRIMS,
                                      device=device, require_scopes=scopes_needed)
    return findings


__all__ = [
    "LEAF_PRIMS",
    "INFERENCE_LEAF_PRIMS",
    "leaf_scope_findings",
    "check_fn_coverage",
    "check_round_coverage",
    "check_stream_coverage",
    "check_hhe_coverage",
    "check_inference_coverage",
]
