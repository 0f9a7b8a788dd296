"""Readings that the correctness limits are set from, on the card(s).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control 3] [--faults 3]
    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --adam-faults

In one process (one a chip on a cell of several chips), for each seed:
the system's checked rounds against the plain reference (the lower
readings); on the first `--control` seeds the control, the reference in
float8 in the system's place; on the first `--faults` seeds the planted
faults (`harness.calibration`). With `--adam-faults`, only the readings
of faults planted in the reference's Adam, against the sound reference
(`harness.adam_fault_readings`; one chip). Prints one JSON line per
reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=0, help="seeds that read the control")
    ap.add_argument("--faults", type=int, default=0, help="seeds that read the faults")
    ap.add_argument("--adam-faults", action="store_true",
                    help="only the faults planted in the reference's Adam")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.manifest import Cell, load

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    chips = Cell(ROOT, load(ROOT), args.workload).chips
    kw = {"control": args.control, "faults": args.faults}
    if args.adam_faults:
        rows = harness.adam_fault_readings(ROOT, args.workload, seeds, args.device)
    elif chips == 1:
        rows = harness.calibration(ROOT, args.workload, seeds, args.device, **kw)
    else:
        rows = harness.on_ranks(harness.calibration, chips, ROOT, args.workload, seeds,
                                args.device, **kw)
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
