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
    assert all(s.pattern.startswith("BENCH_TORCH_") for s in trend.SPECS)
    assert {s.pattern for s in trend.SPECS} == {
        "BENCH_TORCH_LOAD*.json", "BENCH_TORCH_INFER*.json", "BENCH_TORCH_DCN*.json"}
    # The repo holds no BENCH_TORCH_* artifact yet: nothing is gated.
    assert trend._main(["--root", str(REPO), "--quiet"]) == 2


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
