"""The benchmark's command: one run of one cell on the card(s).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: correct, attempted (rounds in the window), failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 breakdown, and last `checks`, each number
that decided `correct` beside its limit; the same numbers are the last
lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices, or if a forbidden module (JAX, or the JAX package the
system was ported from) was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the CUDA driver stay inside the checkout, at fixed paths; the
# system builds its kernel library under its own package directory.
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".bench_cache", "nv"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "torch_ext"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.manifest import Cell, check_names, load

    man = load(ROOT)
    bad = check_names(man)
    if bad:
        print(f"BENCHMARK.json breaks the naming rules: {bad}", file=sys.stderr)
        return 2
    cell = Cell(ROOT, man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
