"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness finds, under `benchmark/` of the checkout:

  * the configuration: the `file` of its `configs` entry;
  * the traffic mix: `traffic/<traffic>.json`;
  * the cell's correctness limits: `limits/<workload name>.json`;
  * each per-layer metric's reader: `metrics/<metric name>.py`, a module
    with `read(view) -> float | None`; for a name with a suffix after a
    dot (the same quantity split by the end-to-end metric it moves, as
    `device_idle.host_paced`), `metrics/<the part before the dot>.py`
    where the whole name has no file of its own.

The part of a metric's name before its first dot (`quantity`) says what
it measures: `round_s.host_paced` is `round_s`, in the cells it lists.

So a later change adds a cell or a metric by adding files and entries,
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot."""
    return name.split(".", 1)[0]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_names(man: dict) -> list[str]:
    """Every name, config, traffic, reduced key and unit the contract
    restricts, that breaks its rule."""
    bad = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man.get(sec, []):
            if not NAME_RE.match(e["name"]):
                bad.append(f"{sec}: name {e['name']!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                bad.append(f"{sec}: unit {e['unit']!r}")
    for w in man.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                bad.append(f"workloads: {key} {w[key]!r}")
    for c in man.get("configs", []):
        bad += [f"configs: reduced {k!r}" for k in c.get("reduced", []) if not NAME_RE.match(k)]
    return bad


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, root: str, man: dict, workload: str):
        hits = [w for w in man["workloads"] if w["name"] == workload]
        if not hits:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"({[w['name'] for w in man['workloads']]})")
        self.root, self.man, self.entry = root, man, hits[0]
        self.name = workload
        cfg_entry = next(c for c in man["configs"] if c["name"] == self.entry["config"])
        self.cfg = _json(os.path.join(root, cfg_entry["file"]))
        self.traffic = _json(os.path.join(root, "benchmark", "traffic",
                                          self.entry["traffic"] + ".json"))
        lim = os.path.join(root, "benchmark", "limits", workload + ".json")
        self.limits = _json(lim) if os.path.exists(lim) else None
        self.chips = int(self.entry["chips"])

    def _reports(self, metric: dict) -> bool:
        w = metric.get("workloads")
        return w is None or self.name in w

    def end_to_end(self) -> list[dict]:
        return [m for m in self.man["end_to_end"] if self._reports(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.man["per_layer"] if self._reports(m)]

    def reader_path(self, metric: str) -> str:
        top = os.path.join(self.root, "benchmark", "metrics")
        own = os.path.join(top, metric + ".py")
        return own if os.path.exists(own) else os.path.join(top, quantity(metric) + ".py")

    def reader(self, metric: str):
        path = self.reader_path(metric)
        spec = importlib.util.spec_from_file_location(f"_bench_metric_{len(metric)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
