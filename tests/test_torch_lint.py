"""The port's static gate (`hefl_tpu_torch.analysis`): the aggregation and
inductive-fold certificates, `check_experiment` at the driver's and the
CLI's call sites, the dispatch lint's rules and allowlist, the donation
rule, the violation fixtures and `python -m hefl_tpu_torch.analysis`.

Held against the JAX package: its certifiers under the `jax_x64` stand-in
(tests/torch_jax_x64.py), the copied constants, the declared region
names and the `--json` line schema (the JAX `emit_json` on the same
report).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hefl_tpu.analysis import cli as jcli
from hefl_tpu.analysis import lint as jlint
from hefl_tpu.analysis import ranges as jranges
from hefl_tpu.parallel import collectives as jcoll

from hefl_tpu_torch import analysis, cli, experiment
from hefl_tpu_torch.analysis import cli as gate
from hefl_tpu_torch.analysis import lint, ranges
from hefl_tpu_torch.ckks import keys, modular
from hefl_tpu_torch.fl import secure
from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.fusion import fused_step
from hefl_tpu_torch.fl.optimizer import AdamState, adam_init, adam_update
from hefl_tpu_torch.fl.stream import OnlineAccumulator
from hefl_tpu_torch.obs import events as obs_events
from hefl_tpu_torch.obs import metrics as obs_metrics
from hefl_tpu_torch.presets import PRESETS

from torch_jax_x64 import jax_x64  # noqa: F401  (the JAX certifiers' stand-in)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "hefl_tpu_torch" / "analysis" / "fixtures").glob("violation_*.py"))
P27 = 2**27 - 39
P256 = int(np.asarray(keys.CkksContext.create(n=256).ntt.p).max())


# ---- certificates -------------------------------------------------------------


def test_constants_are_the_jax_ones():
    assert ranges.MAX_PSUM_CLIENTS == jcoll.MAX_PSUM_CLIENTS
    assert ranges.LOOP_COUNT_CEILING == jranges.LOOP_COUNT_CEILING
    assert gate.JSON_SCHEMA_VERSION == jcli.JSON_SCHEMA_VERSION
    assert (gate.GRID_BITS, gate.GRID_CLIENTS, gate.GRID_GUARD) == (
        jcli.GRID_BITS, jcli.GRID_CLIENTS, jcli.GRID_GUARD)


@pytest.mark.parametrize("cls", ["FoldCertificate", "AggregationCertificate"])
def test_certificates_carry_the_jax_fields(cls):
    want = [f.name for f in dataclasses.fields(getattr(jranges, cls))]
    assert [f.name for f in dataclasses.fields(getattr(ranges, cls))] == want


@pytest.mark.parametrize("prime", [P27, P256, 1, (1 << 62) + 135])
def test_fold_inductive_summary_is_the_jax_dataclass_summary(prime, jax_x64):
    cert, want = ranges.certify_fold_inductive(prime), jranges.certify_fold_inductive(prime)
    fields = {f.name: getattr(cert, f.name) for f in dataclasses.fields(cert)}
    assert cert.summary() == jranges.FoldCertificate(**fields).summary() == want.summary()
    assert cert.checks == want.checks
    assert [str(f) for f in cert.findings] == [str(f) for f in want.findings]
    assert cert.count_ceiling_bits == 48 and cert.bits is None
    # p = 1 is a (trivial) canonical range; past 2**62 the int64 fold wraps.
    assert cert.ok == want.ok == (prime < 1 << 62)
    head = f"fold-inductive p<2**{prime.bit_length()} arrivals<=2**48: "
    assert cert.summary().startswith(head + ("CERTIFIED" if cert.ok else "UNSAFE"))


def test_fold_inductive_packed_leg(jax_x64):
    from hefl_tpu_torch.ckks.packing import probe_spec

    q = keys.CkksContext.create(n=256).modulus
    spec = probe_spec(bits=8, k=2, clients=8)
    cert = ranges.certify_fold_inductive(P27, spec, q)
    assert cert.ok and (cert.bits, cert.k, cert.clients) == (8, 2, 8)
    assert " packed(b=8 k=2 C=8): CERTIFIED" in cert.summary()
    assert cert.summary() == jranges.certify_fold_inductive(P27, spec, q).summary()
    wide = dataclasses.replace(spec, k=16)
    bad = ranges.certify_fold_inductive(P27, wide, q)
    assert not bad.ok and any(str(f).startswith("packed fold: ") for f in bad.findings)
    assert bad.summary() == jranges.certify_fold_inductive(P27, wide, q).summary()
    with pytest.raises(ValueError, match="needs the ring modulus"):
        ranges.certify_fold_inductive(P27, spec)


@pytest.mark.parametrize("prime", [P27, P256, (1 << 59) + 55, (1 << 62) + 135])
def test_aggregation_summary_is_the_jax_dataclass_summary(prime, jax_x64):
    cert, want = ranges.certify_aggregation(prime), jranges.certify_aggregation(prime)
    fields = {f.name: getattr(cert, f.name) for f in dataclasses.fields(cert)}
    assert cert.summary() == jranges.AggregationCertificate(**fields).summary()
    assert cert.chunk == want.chunk == 32 and cert.prime_bits == want.prime_bits
    assert cert.summary().startswith(f"aggregation p<2**{prime.bit_length()} chunk=32: ")
    # The port's lazy sum and lazy all-reduce add 32 canonical residues in
    # int64 (the JAX package's in uint32): they fit below 2**58; the fold's
    # legs are the JAX certificate's.
    assert cert.ok == (32 * (prime - 1) < 1 << 63 and prime < 1 << 62)
    fold = ranges.certify_fold_inductive(prime)
    assert set(fold.findings) <= set(cert.findings)
    jfold = [f for f in want.findings if not f.message.startswith(("lazy_sum_mod", "psum_mod"))]
    assert [str(f) for f in fold.findings] == [
        str(f) for f in cert.findings if not f.message.startswith(("lazy_sum_mod", "psum_mod"))]
    assert [str(f) for f in fold.findings] == [str(f) for f in jfold]
    if cert.ok:
        assert set(fold.checks) <= set(cert.checks)
        assert any(c.startswith("psum_mod[32 participants] stays in ") for c in cert.checks)


def test_certificates_are_memoised():
    assert ranges.certify_aggregation(P27) is ranges.certify_aggregation(P27)
    assert ranges.certify_fold_inductive(P27) is ranges.certify_fold_inductive(P27)


@pytest.mark.parametrize("clients", [2, 8, 256])
def test_certified_max_interleave_is_max_interleave(clients):
    from hefl_tpu_torch.ckks import quantize

    q = keys.CkksContext.create(n=256).modulus
    assert ranges.certified_max_interleave(q, 8, clients, 16) == quantize.max_interleave(
        q, 8, clients, 16)


def test_analysis_exports_the_jax_names_in_order():
    # The interpreter reads torch graphs, not jaxprs: it takes the JAX name's place.
    renamed = {"eval_jaxpr_ranges": "eval_graph_ranges"}
    jax_names = __import__("hefl_tpu.analysis", fromlist=["x"]).__all__
    assert analysis.__all__ == [renamed.get(n, n) for n in jax_names]
    for name in analysis.__all__:
        assert hasattr(analysis, name)


# ---- check_experiment ---------------------------------------------------------


@pytest.fixture()
def events(monkeypatch):
    got = []
    monkeypatch.setattr(obs_events, "emit", lambda event, **f: got.append((event, f)))
    return got


def _violations():
    return obs_metrics.snapshot().get("analysis.violations", 0)


@pytest.mark.parametrize("name", ["mnist-plain", "mnist-enc", "medical-8", "hhe-smoke",
                                  "chaos-smoke"])
def test_check_experiment_on_the_presets(name, events):
    cfg = PRESETS[name]
    base = _violations()
    report = analysis.check_experiment(cfg)
    assert _violations() == base and "analysis.violations" in obs_metrics.snapshot()
    assert events[-1][0] == "analysis_check" and events[-1][1]["violations"] == 0
    assert set(report) == {"aggregation", "packing", "transciphering", "fold"}
    if not cfg.encrypted:
        assert all(v is None for v in report.values()) and events[-1][1]["certified"] == []
        return
    assert report["aggregation"].ok
    assert (report["fold"] is not None) == (cfg.stream is not None)
    packed = cfg.packing is not None and cfg.packing.enabled
    assert (report["packing"] is not None) == packed
    hhe = cfg.stream is not None and cfg.stream.upload_kind == "hhe"
    assert (report["transciphering"] is not None) == (packed and hhe)
    assert events[-1][1]["certified"] == [c.summary() for c in (
        report["aggregation"], report["fold"], report["packing"], report["transciphering"])
        if c is not None]


def test_check_experiment_with_a_context_uses_its_primes():
    ctx = keys.CkksContext.create(n=256)
    report = analysis.check_experiment(PRESETS["hhe-smoke"], ctx=ctx)
    assert report["aggregation"].prime_bits == int(np.asarray(ctx.ntt.p).max()).bit_length()
    assert report["packing"].modulus_bits == ctx.modulus.bit_length()


def test_check_experiment_rejects_an_over_headroom_packing(events):
    cfg = dataclasses.replace(PRESETS["medical-8"],
                              packing=PackingConfig(bits=16, interleave=16))
    base = _violations()
    said = []
    with pytest.raises(analysis.AnalysisError, match=r"packing b=16 k=16 C=8 .*UNSAFE"):
        analysis.check_experiment(cfg, say=said.append)
    assert issubclass(analysis.AnalysisError, ValueError)
    assert _violations() > base and events[-1][1]["violations"] > 0 and not said


def test_check_experiment_counts_a_broken_fold_once(monkeypatch, events):
    from hefl_tpu_torch.ckks import primes

    big = [(1 << 62) + 135, (1 << 62) + 147, (1 << 62) + 159]
    monkeypatch.setattr(primes, "find_ntt_primes", lambda *a: big)
    cfg = dataclasses.replace(PRESETS["medical-8"], stream=StreamConfig())
    agg, fold = ranges.certify_aggregation(max(big)), ranges.certify_fold_inductive(max(big))
    assert fold.findings and set(fold.findings) <= set(agg.findings)
    base = _violations()
    with pytest.raises(analysis.AnalysisError, match="aggregation p<2\\*\\*63"):
        analysis.check_experiment(cfg)
    assert _violations() - base == len(agg.findings) == events[-1][1]["violations"]
    assert len(events[-1][1]["certified"]) == 2


def test_run_experiment_refuses_before_keygen(monkeypatch):
    def no_keygen(*a, **k):
        raise AssertionError("keygen ran before the pre-flight")

    monkeypatch.setattr(experiment, "keygen", no_keygen)
    cfg = dataclasses.replace(
        PRESETS["mnist-enc"], rounds=1, n_train=32, n_test=8,
        he=experiment.HEConfig(n=256), packing=PackingConfig(bits=16, interleave=16),
        train=dataclasses.replace(PRESETS["mnist-enc"].train, epochs=1))
    with pytest.raises(analysis.AnalysisError, match="static analysis rejected"):
        experiment.run_experiment(cfg, verbose=False, device="cpu")


def test_run_experiment_metrics_carry_zero_violations():
    cfg = dataclasses.replace(
        PRESETS["medical-8"], rounds=1, n_train=64, n_test=16,
        train=dataclasses.replace(PRESETS["medical-8"].train, epochs=1))
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    assert out["obs"]["metrics"]["analysis.violations"] == 0


def test_cli_preflight_exits_before_any_work(monkeypatch):
    def no_run(*a, **k):
        raise AssertionError("run_experiment ran past a failed pre-flight")

    monkeypatch.setattr(cli, "run_experiment", no_run)
    args = cli.parse_args(["--model", "medcnn", "--dataset", "medical", "--num-clients", "8",
                           "--pack-bits", "16", "--pack-interleave", "16", "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        cli.run(args)
    assert str(exc.value).startswith("hefl-lint: static analysis rejected this configuration")


# ---- the dispatch lint --------------------------------------------------------


def test_region_names_are_the_jax_ones():
    # Every JAX region has its counterpart, the client-mesh psum_mod ones too.
    got = set(lint.exact_int_regions("cpu"))
    assert lint.UNPORTED_REGIONS == {}
    assert got == set(jlint.exact_int_regions())


def test_exact_regions_are_clean():
    assert lint.lint_exact_regions(device="cpu") == []


@pytest.mark.parametrize("fusion,secure_round", [("vmap", True), ("fused", False)])
def test_round_programs_are_clean(fusion, secure_round):
    assert lint.lint_round_programs(fusion=fusion, secure=secure_round, device="cpu") == []


def _rules(fn, *args, exact_int=True, allow=lint.ALLOWLIST):
    return sorted({f.rule for f in lint.lint_fn(fn, args, "test", exact_int=exact_int,
                                                allow=allow)})


def test_forbidden_primitive_by_mode():
    x = torch.arange(8, dtype=torch.int64)
    f = torch.arange(8, dtype=torch.float32)
    for op in (lambda v: v % 7, lambda v: v // 7, lambda v: torch.fmod(v, 7),
               lambda v: torch.div(v, 7, rounding_mode="floor")):
        assert _rules(op, x) == ["forbidden-primitive"]
        assert _rules(op, x, exact_int=False) == ["forbidden-primitive"]
        # float division is training math outside an exact-integer region
        assert _rules(op, f, exact_int=False) == []
    assert _rules(lambda v: v / 7, f, exact_int=False) == []
    assert _rules(lambda v: torch.div(v, 7), x, exact_int=False) == []


def test_float_contamination_and_f64():
    x = torch.arange(8, dtype=torch.int32)
    assert _rules(lambda v: (v.float() * 2).to(torch.int32), x) == ["float-contamination"]
    assert _rules(lambda v: (v.float() * 2).to(torch.int32), x, exact_int=False) == []
    assert _rules(lambda v: v.double().sum(), x, exact_int=False) == ["f64"]
    assert _rules(lambda v: (v << 3) ^ v, x) == []


def test_host_sync_only_inside_the_hot_ranges():
    x = torch.arange(8, dtype=torch.int64)

    def in_range(name):
        def run(v):
            with torch.profiler.record_function(name):
                return int(v.sum().item())
        return run

    assert _rules(in_range("hefl.sgd_core"), x, exact_int=False) == ["host-callback"]
    assert _rules(in_range("hefl.psum_aggregate"), x, exact_int=False) == ["host-callback"]
    assert _rules(in_range("hefl.val"), x, exact_int=False) == []
    # a closed range no longer counts
    assert _rules(lambda v: (in_range("hefl.val")(v), v.sum().item()), x, exact_int=False) == []
    assert _rules(lambda v: v.sum().item(), x) == ["host-callback"]


def test_allowlist_entries_bless_one_call_site():
    p = torch.full((3, 1), P27, dtype=torch.int64)
    x = torch.zeros((4, 3, 8), dtype=torch.int32)
    assert _rules(lambda v: secure.lazy_sum_mod(v, p), x) == []
    assert _rules(lambda v: secure.lazy_sum_mod(v, p), x, allow=()) == ["forbidden-primitive"]
    # the same remainder anywhere else still fails
    assert _rules(lambda v: torch.remainder(v.sum(0).to(torch.int64), p), x) == [
        "forbidden-primitive"]
    # barrett_mu's table divide is blessed at its size only
    small, big = torch.full((3, 1), P27, dtype=torch.int64), torch.full((65,), P27)
    assert _rules(modular.barrett_mu, small) == []
    assert _rules(modular.barrett_mu, big) == ["forbidden-primitive"]
    for entry in lint.ALLOWLIST:
        assert entry.reason and entry.rule in ("forbidden-primitive", "source-forbidden")


def test_range_probe_remainders_pass_only_at_their_probes():
    assert lint.lint_range_probes(device="cpu") == []
    bare = lint.lint_range_probes(allow=(), device="cpu")
    assert sorted({f.where for f in bare}) == [
        "ranges:ckks.ops.hoisted_gadget_probe", "ranges:ckks.ops.keyswitch_gadget_probe",
        "ranges:fl.stream.fold_loop_probe", "ranges:he_inference.mlp_bsgs_range_probe",
        "ranges:he_inference.rotation_ladder_range_probe"]
    assert {f.rule for f in bare} == {"forbidden-primitive"}
    # one probe's entry blesses that probe only
    ladder = tuple(a for a in lint.ALLOWLIST if a.source and "rotation_ladder" in a.source)
    assert len(ladder) == 1
    left = {f.where for f in lint.lint_range_probes(allow=ladder, device="cpu")}
    assert "ranges:he_inference.rotation_ladder_range_probe" not in left and len(left) == 4


def test_source_sweep(tmp_path):
    assert lint.source_sweep() == []
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text(
        '"""torch.remainder in a docstring is fine."""\nimport torch\n\n\n'
        "def f(x, p):\n    # torch.fmod in a comment too\n    return torch.remainder(x, p)\n\n\n"
        "def lazy_sum_mod(x, p):\n    return torch.fmod(x, p)\n")
    found = lint.source_sweep(str(pkg), allow=())
    assert [(f.rule, f.where) for f in found] == [("source-forbidden", "pkg/a.py:7"),
                                                  ("source-forbidden", "pkg/a.py:11")]
    blessed = (lint.Allow(region="*", rule="source-forbidden", primitive="fmod",
                          source="*/a.py:lazy_sum_mod", reason="test"),)
    assert [f.where for f in lint.source_sweep(str(pkg), allow=blessed)] == ["pkg/a.py:7"]


# ---- donation ------------------------------------------------------------------


def test_tree_donations_hold():
    assert lint.check_tree_donations("cpu") == []


def test_online_fold_keeps_its_storage_and_its_sum():
    p = keys.CkksContext.create(n=256).ntt.p
    rng = np.random.default_rng(0)
    ups = [torch.from_numpy((rng.integers(0, 2**31, (2, 3, 256)) % np.asarray(p)).astype(
        np.int32)) for _ in range(5)]
    acc = OnlineAccumulator(p)
    acc.fold(0, ups[0], ups[0])
    ptrs = [t.untyped_storage().data_ptr() for t in (acc._c0, acc._c1)]
    first = acc.value()
    for i, u in enumerate(ups[1:], 1):
        acc.fold(i, u, u)
        assert [t.untyped_storage().data_ptr() for t in (acc._c0, acc._c1)] == ptrs
    # value() hands out a copy: a later fold leaves what was read alone.
    assert torch.equal(first[0], ups[0]) and torch.equal(first[1], ups[0])
    assert first[0].untyped_storage().data_ptr() not in ptrs
    want = secure.lazy_sum_mod(torch.stack(ups), torch.from_numpy(np.asarray(p, np.int64)))
    assert torch.equal(acc.value()[0], want) and torch.equal(acc.value()[1], want)


def test_inplace_adam_is_the_out_of_place_update_bitwise():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 4, 5), generator=gen), "b": torch.randn((3, 5), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    opt = adam_init(params)
    opt = AdamState(mu={k: torch.randn(v.shape, generator=gen) for k, v in params.items()},
                    nu={k: torch.rand(v.shape, generator=gen) for k, v in params.items()},
                    step=3)
    scale = np.array([1.0, 0.5, 0.25], np.float32)
    want, want_opt = adam_update(grads, opt, params, 1e-3, 1e-4, scale, warmup_steps=4)
    p2 = {k: v.clone() for k, v in params.items()}
    o2 = AdamState(mu={k: v.clone() for k, v in opt.mu.items()},
                   nu={k: v.clone() for k, v in opt.nu.items()}, step=opt.step)
    got, got_opt = adam_update(grads, o2, p2, 1e-3, 1e-4, scale, warmup_steps=4, inplace=True)
    for k in params:
        assert got[k] is p2[k] and got_opt.mu[k] is o2.mu[k] and got_opt.nu[k] is o2.nu[k]
        assert torch.equal(got[k], want[k]) and torch.equal(got_opt.mu[k], want_opt.mu[k])
        assert torch.equal(got_opt.nu[k], want_opt.nu[k])


def test_masked_fused_step_is_out_of_place():
    model, params, xs, ys, classes = lint._tiny_round_inputs("cpu")
    from hefl_tpu_torch.data.augment import rescale
    from hefl_tpu_torch.models.folded import fold_clients, stack_params

    cfg = TrainConfig(epochs=1, batch_size=4, num_classes=classes, client_fusion="fused")
    stacked = stack_params(params, 2)
    before = {k: v.clone() for k, v in stacked.items()}
    onehot = torch.nn.functional.one_hot(ys[:, :4].to(torch.int64), classes).float()
    keep = torch.tensor([True, False])
    new, _ = fused_step(model, cfg, stacked, adam_init(stacked), fold_clients(rescale(xs[:, :4])),
                        onehot, np.ones(2, np.float32), params, keep)
    for k in stacked:
        assert torch.equal(stacked[k], before[k])            # nothing written in place
        assert torch.equal(new[k][1], before[k][1])           # the masked client kept its rows
    assert any(not torch.equal(new[k][0], before[k][0]) for k in stacked)


# ---- the gate ----------------------------------------------------------------------


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_fixture_fails_the_gate_under_its_rule(path, capsys):
    rule = {"violation_forbidden_primitive": "forbidden-primitive",
            "violation_float_contamination": "float-contamination",
            "violation_missing_scope": "missing-scope",
            "violation_broken_donation": "broken-donation",
            "violation_loop_overflow": "loop-overflow"}[path.stem]
    assert gate.main(["--fixture", str(path), "--json", "--device", "cpu"]) == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    findings = [line for line in lines if line["type"] == "finding"]
    assert findings and all(f["rule"] == rule for f in findings)
    assert set(findings[0]) == {"type", "rule", "where", "message"}
    assert lines[-1]["type"] == "summary" and lines[-1]["violations"] == len(findings)
    assert not lines[-1]["ok"]


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_fixture_builds_on_the_gate_device(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, args = mod.build(torch.device("meta"))
    assert args and all(a.device.type == "meta" for a in args)


def test_fixture_mode_runs_on_cuda_unless_asked(monkeypatch):
    # Resolved as the tree gate resolves it: no card and no --device raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.main(["--fixture", str(FIXTURES[0]), "--json"])


def test_fixture_rules_cover_the_ported_rules():
    rules = {re.search(r'^RULE = "([^"]+)"', p.read_text(), re.M).group(1) for p in FIXTURES}
    assert rules == {"forbidden-primitive", "float-contamination", "missing-scope",
                     "broken-donation", "loop-overflow"}
    assert len(FIXTURES) == 5


def test_json_lines_are_the_jax_schema():
    certs = [gate._cert_record("aggregation", ranges.certify_aggregation(P27)),
             gate._cert_record("fold-inductive", ranges.certify_fold_inductive(P27))]
    stages = [{"stage": "source sweep", "seconds": 0.5, "findings": 1}]
    port = gate.GateReport(findings=[lint.LintFinding("f64", "w", "m")], certificates=certs,
                           stages=stages)
    ref = jcli.GateReport(findings=[jlint.LintFinding("f64", "w", "m")], certificates=certs,
                          stages=stages)
    assert gate.emit_json(port) == jcli.emit_json(ref)
    lines = [json.loads(line) for line in gate.emit_json(port)]
    assert [line["type"] for line in lines] == ["certificate", "certificate", "finding",
                                                "summary"]
    assert set(lines[-1]) == {"type", "schema", "ok", "violations", "certificates", "stages",
                              "total_seconds"}
    assert set(lines[0]) == {"type", "kind", "ok", "summary", "prime_bits", "chunk"}
    assert set(lines[1]) == {"type", "kind", "ok", "summary", "prime_bits", "bits", "k",
                             "clients", "count_ceiling_bits"}


def test_the_gate_passes_on_the_tree_fast():
    # Its own limit (the subprocess's), well inside the suite's.
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "hefl_tpu_torch.analysis", "--fast",
                           "--device", "cpu", "--json"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    summary = lines[-1]
    assert summary["type"] == "summary" and summary["ok"] and summary["violations"] == 0
    assert [s["stage"] for s in summary["stages"]] == [
        "source sweep", "exact-int regions", "range certification",
        "hot-path lint [vmap+secure]", "hot-path lint [fused]", "donation"]
    kinds = [line["kind"] for line in lines if line["type"] == "certificate"]
    assert kinds[:3] == ["aggregation", "fold-inductive", "inference"]
    assert kinds.count("packing") == kinds.count("transciphering") > 0
