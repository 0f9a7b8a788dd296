"""The port's trend table and regression gate (`hefl_tpu_torch.obs.trend`)
held against `hefl_tpu.obs.trend`.

Given the JAX package's SPECS and the repo's committed BENCH_*.json (and the
seeded regression fixture), the port renders the same markdown as the JAX
module; its own SPECS read the port's BENCH_TORCH_* artifacts only, so the
repo root (no such file yet) exits 2; a seeded regression exits 1.
"""

import dataclasses
import json
import os
from pathlib import Path

from hefl_tpu.obs import trend as jtrend

from hefl_tpu_torch.obs import trend

REPO = Path(__file__).resolve().parent.parent
FIXTURE = str(REPO / "tests" / "fixtures" / "BENCH_r99_seeded_regression.json")


def _jax_specs():
    return [trend.TrendSpec(*dataclasses.astuple(s)) for s in jtrend.SPECS]


def test_renders_the_jax_table_from_the_same_specs_and_files():
    for extra in ([], [FIXTURE]):
        want = jtrend.render_markdown(jtrend.evaluate(str(REPO), extra=extra))
        intro = want.splitlines()[2]
        rows = trend.evaluate(str(REPO), specs=_jax_specs(), extra=extra)
        assert trend.render_markdown(rows, intro=intro) == want
        assert [r.regressed for r in rows] == [
            r.regressed for r in jtrend.evaluate(str(REPO), extra=extra)]


def test_specs_read_the_ports_artifacts_only():
    assert all(g.startswith("BENCH_TORCH") for s in trend.SPECS for g in s.pattern.split("|"))
    assert {s.pattern for s in trend.SPECS} == {
        "BENCH_TORCH.json|BENCH_TORCH_r*.json", "BENCH_TORCH_LOAD*.json",
        "BENCH_TORCH_INFER*.json", "BENCH_TORCH_DCN*.json"}
    wall = next(s for s in trend.SPECS if s.metric == "pipeline.wallclock_s")
    jwall = next(s for s in jtrend.SPECS if s.metric == "pipeline.wallclock_s")
    assert (wall.path, wall.direction, wall.tolerance) == ("value", "down", jwall.tolerance)
    # The repo's committed BENCH_TORCH.json (a card's run) is the pipeline
    # series' baseline point: the gate is clean.
    rows = trend.evaluate(str(REPO))
    assert [p[0] for p in next(r for r in rows if r.metric == wall.metric).points] == [
        "BENCH_TORCH.json"]
    assert trend._main(["--root", str(REPO), "--quiet"]) == 0


def _load_artifact(path, folds_per_s):
    doc = {"bench_load": {"runs": {"commit_grouped": {"folds_per_s": folds_per_s}},
                          "group_commit": {"fsync_ratio": 0.02}}}
    Path(path).write_text(json.dumps(doc))
    return str(path)


def test_gate_clean_then_seeded_regression(tmp_path):
    d = tmp_path / "hist"
    d.mkdir()
    _load_artifact(d / "BENCH_TORCH_LOAD_r01.json", 1000.0)
    assert trend._main(["--root", str(d), "--quiet"]) == 0        # single points: baselines
    _load_artifact(d / "BENCH_TORCH_LOAD_r02.json", 800.0)         # -20 %, inside 30 %
    out = tmp_path / "TREND.md"
    assert trend._main(["--root", str(d), "--out", str(out), "--quiet"]) == 0
    md = out.read_text()
    assert "load.folds_per_s" in md and "No regressions" in md
    bad = _load_artifact(tmp_path / "BENCH_TORCH_LOAD_r03.json", 500.0)
    assert trend._main(["--root", str(d), "--quiet", "--extra", bad]) == 1
    rows = trend.evaluate(str(d), extra=[bad])
    row = next(r for r in rows if r.metric == "load.folds_per_s")
    assert row.regressed and row.best == 1000.0 and row.latest == 500.0
    assert [p[0] for p in row.points][-1] == os.path.basename(bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert trend._main(["--root", str(empty), "--quiet"]) == 2


def test_pipeline_series_reads_the_bench_files_only(tmp_path):
    for name, value in (("BENCH_TORCH.json", 100.0), ("BENCH_TORCH_r02.json", 110.0),
                        ("BENCH_TORCH_LOAD.json", 1.0), ("BENCH_TORCH_NTT.json", 1.0),
                        ("BENCH_TORCH_INFER.json", 1.0), ("BENCH_TORCH_DCN.json", 1.0)):
        (tmp_path / name).write_text(json.dumps({"value": value}))
    rows = trend.evaluate(str(tmp_path))
    wall = next(r for r in rows if r.metric == "pipeline.wallclock_s")
    assert wall.points == [("BENCH_TORCH.json", 100.0), ("BENCH_TORCH_r02.json", 110.0)]
    assert not wall.regressed                                  # +10 %, inside 25 %
    bad = tmp_path / "late" / "BENCH_TORCH_r03.json"
    bad.parent.mkdir()
    bad.write_text(json.dumps({"value": 130.0}))
    assert trend._main(["--root", str(tmp_path), "--quiet", "--extra", str(bad)]) == 1
