"""`hefl-lint` for the port: the whole-tree static-analysis gate as one
command, the counterpart of `hefl_tpu.analysis.cli`.

    python -m hefl_tpu_torch.analysis                  # full gate, on CUDA
    python -m hefl_tpu_torch.analysis --device cpu     # on the CPU (plain versions)
    python -m hefl_tpu_torch.analysis --fast           # skip the coverage stages
    python -m hefl_tpu_torch.analysis --json           # JSON lines (schema below)
    python -m hefl_tpu_torch.analysis --fixture F.py   # run ONE rule against a
                                                       # violation fixture (exit 1
                                                       # when it fires, as it must)

Stages of the full gate, in the JAX gate's order, each a failure on
findings:

  1. source sweep — AST scan for `torch.remainder` / `torch.fmod` /
     `torch.floor_divide` references (allowlisted call sites aside)
  2. exact-integer regions — the modules' `exact_int_probes(device)`, run
     under the dispatch recorder: no remainder/divide, no float, no sync
     (the JAX regions, every one with its counterpart: `lint.UNPORTED_REGIONS`
     is empty)
     and the range probes' `%` (`lint.lint_range_probes`, each pinned to
     its probe by the allowlist)
  3. range certification — the interval interpreter over the traced range
     probes, at the default ring's largest prime: `certify_aggregation`
     (the streaming fold inside it), `certify_fold_inductive`,
     `certify_inference`, and `certify_packing` over the supported b x C
     grid at auto-k, each point paired with its `certify_transciphering`
     twin
  4. hot-path lint — the real round programs at tiny geometry (both
     fusion backends, the secure round included): integer divides, f64,
     host syncs inside an SGD step or the ciphertext sum
  5. donation — the in-place accumulators keep their storage
  6. scope coverage — every leaf compute op of a round (both backends,
     secure, the streaming upload producer, the hybrid-HE upload and
     transcipher) and of the serving scorers (ladder, BSGS, BSGS MLP)
     inside a `hefl.*` range, from a `torch.profiler` trace

`--json` emits one JSON object per line, each with a `type`: `certificate`
(the proofs of stage 3), then `finding` (rule / where / message), then one
`summary` (schema version, violation count, per-stage timings) — the JAX
gate's line schema. Stage timings also print on the human path.

Fixture protocol (`hefl_tpu_torch/analysis/fixtures/violation_*.py`): the
module defines `RULE` (forbidden-primitive | float-contamination |
missing-scope | broken-donation | loop-overflow) and `build(device)`
returning `(fn, args)` with its tensors on `device`; a broken-donation
fixture may name its donated argument positions in `DONATE` (default: the
first). A loop-overflow fixture is traced and range-analysed at its
arguments' concrete intervals: the finding cites the carried op. A fixture
runs on the device the tree gate would: CUDA unless `--device` says
otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import time

# The --json line-schema version (bump on breaking changes; the JAX gate's).
JSON_SCHEMA_VERSION = 1

# The supported PackingConfig grid the tree gate certifies (the JAX gate's):
# every quantizer width the config validator admits, across client counts
# up to the million-client service's per-axis fan-in.
GRID_BITS = (2, 4, 8, 16)
GRID_CLIENTS = (2, 8, 32, 256, 1024)
GRID_GUARD = 16

LINT_RULES = ("forbidden-primitive", "float-contamination", "f64", "host-callback")


def _default_ring() -> tuple[int, int, int, int]:
    """(modulus q, largest RNS prime, ksk digit bits, ksk digit count) of
    the default HEConfig ring."""
    import numpy as np

    from hefl_tpu_torch.experiment import HEConfig

    ctx = HEConfig().build()
    return (int(ctx.modulus), int(np.asarray(ctx.ntt.p).max()), int(ctx.ksk_digit_bits),
            int(ctx.ksk_num_digits))


def run_fixture(path: str, device) -> list:
    """Run one violation fixture's declared rule on `device`; -> findings."""
    from hefl_tpu_torch.analysis import coverage, lint

    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rule = mod.RULE
    fn, args = mod.build(device)
    name = f"fixture:{os.path.basename(path)}"
    if rule in LINT_RULES:
        found = lint.lint_fn(fn, tuple(args), name, exact_int=True)
    elif rule == "missing-scope":
        found = coverage.check_fn_coverage(fn, tuple(args), name, device=device)
    elif rule == "broken-donation":
        found = lint.check_donation(fn, tuple(args), name, donate=getattr(mod, "DONATE", (0,)))
    elif rule == "loop-overflow":
        # Trace and range-analyse: a loop-carried integer that escapes its
        # carrier only after enough iterations is invisible to the per-op
        # lint rules; the loop fixpoint finds it and cites the carried op.
        from hefl_tpu_torch.analysis import ranges

        res = ranges.eval_graph_ranges(ranges.trace_graph(fn, tuple(args)),
                                       [ranges._array_interval(a) for a in args])
        found = [lint.LintFinding(rule="loop-overflow", where=name, message=f.message)
                 for f in res.findings]
    else:
        raise SystemExit(f"{path}: unknown fixture RULE {rule!r}")
    # The fixture contract: its seeded violation must fire under ITS rule.
    return [f for f in found if f.rule == rule] or found


@dataclasses.dataclass
class GateReport:
    """What one whole-tree gate run established: the findings (empty on a
    healthy tree), the range certificates stage 3 produced (as the records
    `--json` emits), and per-stage wall-clock."""

    findings: list = dataclasses.field(default_factory=list)
    certificates: list = dataclasses.field(default_factory=list)
    stages: list = dataclasses.field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return sum(s["seconds"] for s in self.stages)


def _cert_record(kind: str, cert) -> dict:
    """One certificate as a `--json` line (type=certificate)."""
    rec = {"type": "certificate", "kind": kind, "ok": bool(cert.ok), "summary": cert.summary()}
    for field in ("modulus_bits", "prime_bits", "bits", "k", "clients", "fbits", "guard",
                  "chunk", "ceiling_bits", "digit_bits", "num_digits", "depth_ceiling_bits",
                  "count_ceiling_bits"):
        if hasattr(cert, field):
            rec[field] = getattr(cert, field)
    return rec


def _certificates(report: GateReport, progress, device="cpu") -> list:
    """Stage 3: the certificates, their probes traced on `device`."""
    from hefl_tpu_torch.analysis import ranges
    from hefl_tpu_torch.ckks.quantize import max_interleave

    got = []
    dev = str(device)

    def record(kind, cert):
        report.certificates.append(_cert_record(kind, cert))
        got.extend(cert.findings)

    q, max_prime, ksk_w, ksk_d = _default_ring()
    record("aggregation", ranges.certify_aggregation(max_prime, device=dev))
    # The fold's findings are already in the aggregation certificate (the
    # same cached proof): only the standalone record is added, so a broken
    # fold counts once.
    report.certificates.append(_cert_record(
        "fold-inductive", ranges.certify_fold_inductive(max_prime, device=dev)))
    record("inference", ranges.certify_inference(max_prime, ksk_w, ksk_d, device=dev))
    points = 0
    for bits in GRID_BITS:
        for clients in GRID_CLIENTS:
            try:
                k = max_interleave(q, bits, clients, GRID_GUARD)
            except ValueError:
                continue  # no headroom at all: correctly unsupported
            record("packing", ranges.certify_packing(q, bits, k, clients, GRID_GUARD,
                                                     device=dev))
            record("transciphering", ranges.certify_transciphering(
                q, bits, k, clients, GRID_GUARD, device=dev))
            points += 1
    progress(f"    packing grid: {points} (b, C) points certified "
             "(+ transciphering twin each)")
    return got


def run_tree_gate(fast: bool = False, progress=print, device="cpu") -> GateReport:
    """The whole-tree gate on `device`; -> GateReport (no findings on a
    healthy tree)."""
    from hefl_tpu_torch.analysis import coverage, lint

    report = GateReport()

    def stage(label, fn):
        t0 = time.perf_counter()
        got = fn()
        seconds = round(time.perf_counter() - t0, 2)
        report.findings.extend(got)
        report.stages.append({"stage": label, "seconds": seconds, "findings": len(got)})
        progress(f"  {label}: {len(got)} finding(s) [{seconds:.1f}s]")

    stage("source sweep", lint.source_sweep)
    stage("exact-int regions", lambda: lint.lint_exact_regions(device=device)
          + lint.lint_range_probes(device=device))
    progress(f"    JAX regions without a counterpart: {json.dumps(lint.UNPORTED_REGIONS)}")
    stage("range certification", lambda: _certificates(report, progress, device))
    stage("hot-path lint [vmap+secure]",
          lambda: lint.lint_round_programs(fusion="vmap", secure=True, device=device))
    stage("hot-path lint [fused]",
          lambda: lint.lint_round_programs(fusion="fused", secure=False, device=device))
    stage("donation", lambda: lint.check_tree_donations(device))
    if not fast:
        stage("scope coverage [vmap]",
              lambda: coverage.check_round_coverage(fusion="vmap", device=device))
        stage("scope coverage [fused]",
              lambda: coverage.check_round_coverage(fusion="fused", device=device))
        stage("scope coverage [secure]",
              lambda: coverage.check_round_coverage(fusion="vmap", secure=True, device=device))
        stage("scope coverage [stream/server]",
              lambda: coverage.check_stream_coverage(fusion="vmap", device=device))
        stage("scope coverage [hhe]", lambda: coverage.check_hhe_coverage(device))
        stage("scope coverage [inference]", lambda: coverage.check_inference_coverage(device))
    return report


def emit_json(report: GateReport) -> list[str]:
    """The `--json` JSON-lines document: certificate lines, finding lines,
    one trailing summary line (the JAX gate's schema)."""
    lines = [json.dumps(rec) for rec in report.certificates]
    lines.extend(json.dumps({"type": "finding", "rule": f.rule, "where": f.where,
                             "message": f.message}) for f in report.findings)
    lines.append(json.dumps({
        "type": "summary",
        "schema": JSON_SCHEMA_VERSION,
        "ok": not report.findings,
        "violations": len(report.findings),
        "certificates": len(report.certificates),
        "stages": report.stages,
        "total_seconds": round(report.total_seconds, 2),
    }))
    return lines


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m hefl_tpu_torch.analysis",
        description="static-analysis gate of the port: dispatch lint, range proofs, "
                    "scope coverage",
    )
    p.add_argument("--fixture", default=None, metavar="FILE.py",
                   help="run one violation fixture's declared rule instead of the tree gate")
    p.add_argument("--fast", action="store_true", help="skip the scope-coverage stages")
    p.add_argument("--json", action="store_true", help="emit findings as JSON lines")
    p.add_argument("--device", default=None,
                   help="device the gate runs its programs on (default: CUDA, which must be "
                        "present; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    # The gate sees the library as the tests do: no event-log side effects,
    # no persisted backend choice.
    os.environ.setdefault("HEFL_EVENTS", "0")
    os.environ.setdefault("HEFL_AUTOSELECT_CACHE", "0")

    from hefl_tpu_torch import resolve_device

    quiet = args.json
    progress = (lambda *_: None) if quiet else print
    device = resolve_device(args.device)
    if args.fixture:
        findings = run_fixture(args.fixture, device)
        report = GateReport(findings=list(findings))
    else:
        progress(f"hefl-lint: whole-tree static-analysis gate of hefl_tpu_torch on {device}")
        report = run_tree_gate(fast=args.fast, progress=progress, device=device)
        findings = report.findings

    if args.json:
        for line in emit_json(report):
            print(line)
    else:
        for f in findings:
            print(f"  FAIL {f}")
        if report.stages:
            timings = " ".join(f"{s['stage']}={s['seconds']:.1f}s" for s in report.stages)
            print(f"hefl-lint stage timings: {timings} (total {report.total_seconds:.1f}s)")
    if findings:
        if not quiet:
            print(f"hefl-lint: {len(findings)} violation(s)")
        return 1
    if not quiet:
        print("hefl-lint: clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
