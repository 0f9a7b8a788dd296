"""BENCHMARK.json keeps the contract's shape, and the harness finds a
cell's configuration, traffic, limits and per-layer readers by name, so a
new cell and a new metric come in as files and entries alone."""

import json
import os
import re
import shutil
import types

import pytest

from benchmark import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return manifest.load(ROOT)


def test_names_units_and_keys(man):
    assert manifest.check_names(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert {manifest.quantity(m["name"]) for m in man["end_to_end"]} == {"round_s", "setup_s"}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(man["paths"][0] + "/")
        assert TEXT_RE.match(c["source"]) and TEXT_RE.match(c["why"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT_RE.match(w["why"]) and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
        for w in m.get("workloads", [x["name"] for x in man["workloads"]]):
            cell = manifest.Cell(ROOT, man, w)
            assert m["moves"] in [e["name"] for e in cell.end_to_end()]
            assert os.path.isfile(cell.reader_path(m["name"]))
    assert len(json.dumps(man)) < 64 * 1024


def test_run_seconds_fits_a_full_check(man):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "é", "", "x" * 65])
def test_bad_names_are_found(man, bad):
    m = json.loads(json.dumps(man))
    m["per_layer"][0]["name"] = bad
    assert manifest.check_names(m)


def test_every_cell_finds_its_files(man):
    for w in man["workloads"]:
        cell = manifest.Cell(ROOT, man, w["name"])
        assert cell.cfg["name"] == w["config"] and cell.limits is not None
        assert set(cell.limits["compared"]) == {"grad1_median_gap", "update1_gap",
                                                "agg_gap", "eval_gap"}
        assert all(m["name"] for m in cell.per_layer())


def test_a_new_cell_and_metric_from_files_alone(tmp_path, man):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new manifest entries; no file
    of the copy is edited, and the harness finds all four by name."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/resnet20-cifar10.json").read_text())
    cfg.update(name="resnet8-cifar10", stage_sizes=[1, 1, 1])
    (root / "benchmark/configs/resnet8-cifar10.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/fedavg4.json").write_text(json.dumps(
        {"clients": 4, "images_per_client": 100, "test_images": 100}))
    (root / "benchmark/limits/resnet8-cifar10.fedavg4.json").write_text(json.dumps(
        {"compared": {"update1_gap": {"limit": 0.5}}}))
    (root / "benchmark/metrics/launches_per_step.py").write_text(
        "def read(view):\n    return view.trace.kernels(('hefl.sgd_core',)) / 10\n")
    m = json.loads(json.dumps(man))
    m["configs"].append({"name": "resnet8-cifar10", "source": "https://arxiv.org/abs/1512.03385",
                         "file": "benchmark/configs/resnet8-cifar10.json",
                         "reduced": ["stage_sizes"], "why": "a shallower ResNet"})
    m["workloads"].append({"name": "resnet8-cifar10.fedavg4", "config": "resnet8-cifar10",
                           "traffic": "fedavg4", "chips": 1, "why": "four clients"})
    m["per_layer"].append({"name": "launches_per_step", "unit": "kernels", "better": "lower",
                           "source": "device_trace", "layer": "client training",
                           "moves": "round_s", "workloads": ["resnet8-cifar10.fedavg4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    cell = manifest.Cell(str(root), manifest.load(str(root)), "resnet8-cifar10.fedavg4")
    assert cell.cfg["stage_sizes"] == [1, 1, 1] and cell.traffic["clients"] == 4
    assert cell.limits == {"compared": {"update1_gap": {"limit": 0.5}}}
    assert "launches_per_step" in [x["name"] for x in cell.per_layer()]
    other = manifest.Cell(str(root), manifest.load(str(root)), man["workloads"][0]["name"])
    assert "launches_per_step" not in [x["name"] for x in other.per_layer()]
    trace = types.SimpleNamespace(kernels=lambda phases: 120)
    assert cell.reader("launches_per_step")(types.SimpleNamespace(trace=trace)) == 12.0


def test_every_cell_reports_one_pace_of_round_s(man):
    """Each cell reports setup_s and one round_s metric, the one its
    per-layer metrics move; a split metric reads its quantity's reader."""
    for w in man["workloads"]:
        cell = manifest.Cell(ROOT, man, w["name"])
        names = [m["name"] for m in cell.end_to_end()]
        assert "setup_s" in names
        rounds = [n for n in names if manifest.quantity(n) == "round_s"]
        assert len(rounds) == 1
        assert {m["moves"] for m in cell.per_layer()} == set(rounds)
        for m in cell.per_layer():
            assert os.path.basename(cell.reader_path(m["name"])) == (
                manifest.quantity(m["name"]) + ".py")
