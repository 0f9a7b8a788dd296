"""A run of the harness on the CPU at a tiny size, end to end.

    python3 benchmark/rehearse.py [--workload medcnn-medical.fedavg32] [--seed 7]

Copies the manifest and the cell's files into a scratch root under
`$TMPDIR`, shrinks the configuration (narrow layers, a ring of N = 256,
two epochs of batch 4) and the traffic (3 clients of 10 images; two a
rank on a cell of several chips, whose ranks are processes joined by
gloo), and runs `harness.run` on the CPU, where the system's kernels run
their plain versions. Prints the one-line JSON a chip run prints. The numbers are CPU
numbers: they say that the path runs, never how fast the card is.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Tiny shapes of each model: MedCNN's six VALID stages need 190 pixels.
TINY = {
    "medcnn": {"input_shape": [190, 190, 3], "features": [8, 8, 8, 8, 8, 8], "dense": [16, 16]},
    "resnet20": {"input_shape": [16, 16, 3], "widths": [8, 8, 16]},
}
TINY_TRAFFIC = {"clients": 3, "images_per_client": 10, "test_images": 8}
# On a cell of several chips: two clients a rank.
TINY_CLIENTS_A_RANK = 2
# Limits of the tiny cells, set from CPU readings of the tiny shapes on
# seeds 1-3 (the system's grad1_median_gap 0.0035-0.035, update1_gap
# 0.16-0.38, agg_gap 0; half the batch: grad1_median_gap 0.066-1.08; half
# the clients: update1_gap 0.78-2.4, agg_gap 4.5e-3 to 5.1e-3; unchanged:
# update1_gap 1.0; the uploads' mean in bfloat16: agg_gap 2.3e-3 to
# 3.7e-3). They say that the path and the check run, not what the card's
# cells allow.
TINY_LIMITS = {"compared": {"grad1_median_gap": {"limit": 0.05},
                            "update1_gap": {"limit": 0.6}, "agg_gap": {"limit": 1e-3},
                            "eval_gap": {"limit": 1.5}}}


def tiny_root(workload: str, dest: str | None = None, limits: dict | None = None,
              entry: dict | None = None, reports: tuple = ()) -> str:
    """A scratch root holding the manifest and tiny versions of the
    cell's configuration, traffic and limits -> its path. `entry`, a
    `workloads` entry, adds a cell the manifest does not hold to the
    scratch root's manifest, which lists it among the cells of each
    end-to-end metric named in `reports`."""
    from benchmark.manifest import Cell, load
    from benchmark.reference.models import param_spec

    man = load(ROOT)
    if entry is not None:
        man["workloads"].append(entry)
        for m in man["end_to_end"]:
            if m["name"] in reports:
                m["workloads"].append(entry["name"])
    cell = Cell(ROOT, man, workload)
    dest = dest or tempfile.mkdtemp(prefix="bench_rehearsal_")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dest, "benchmark"),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cfg = dict(cell.cfg, **TINY[cell.cfg["model"]])
    cfg["recipe"] = dict(cfg["recipe"], epochs=2, batch_size=4, es_patience=2)
    cfg["ckks"] = dict(cfg["ckks"], n=256)
    cfg["params"] = sum(int(__import__("math").prod(s)) for _, s, _, _ in param_spec(cfg))
    conf = next(c for c in man["configs"] if c["name"] == cell.entry["config"])
    with open(os.path.join(dest, conf["file"]), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dest, "benchmark", "traffic", cell.entry["traffic"] + ".json"),
              "w") as f:
        tiny = dict(TINY_TRAFFIC)
        if cell.chips > 1:
            tiny["clients"] = TINY_CLIENTS_A_RANK * cell.chips
        json.dump(dict(cell.traffic, **tiny), f)
    with open(os.path.join(dest, "benchmark", "limits", workload + ".json"), "w") as f:
        json.dump(limits or TINY_LIMITS, f)
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="medcnn-medical.fedavg32")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    torch.set_num_threads(min(4, torch.get_num_threads()))
    root = tiny_root(args.workload)
    try:
        out = harness.run(root, args.workload, args.seed, args.seconds, False, "cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
