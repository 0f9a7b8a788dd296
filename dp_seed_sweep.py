"""Seed sweep of the DP sigma 0.1 convergence row (`mnist-enc-dplow-10r`) on
either package, so its final accuracy is read as a spread over seeds, not one
draw.

    python dp_seed_sweep.py --side torch              # the port, on the card
    python dp_seed_sweep.py --side jax --seeds 0 1 2  # the JAX package, on the CPU

Each side runs its own results driver's config (`hefl_tpu_torch.results` or
the root `results.py`) with only the seed replaced, through that package's
`run_experiment`, and merges one record per seed into dp_seed_sweep.json
under its side: {"torch": {"0": {...}}, "jax": {...}}. A record holds the
final accuracy, the per-round curve, the DP epsilon, the wall-clock and the
device (with a card's power limit).

The JAX side imports only `hefl_tpu`; the torch side only `hefl_tpu_torch`.
JAX 0.9 removed `jax.experimental.enable_x64`, which the JAX package's
pre-flight certifiers call; the JAX side installs the same stand-in the
parity tests use (x64 enabled, jit disabled while the certifiers trace) and
edits nothing of the package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

CONFIG = "mnist-enc-dplow-10r"
OUT = "dp_seed_sweep.json"


def _jax_config():
    import jax

    jax.config.update("jax_platforms", "cpu")

    @contextlib.contextmanager
    def enable_x64():
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            with jax.disable_jit():
                yield
        finally:
            jax.config.update("jax_enable_x64", old)

    jax.experimental.enable_x64 = enable_x64
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import results

    from hefl_tpu.experiment import run_experiment

    def device(_cfg):
        return {"platform": "cpu", "kind": jax.devices()[0].device_kind, "count": 1,
                "power_limit": None}

    return results.convergence_configs()[CONFIG][1], run_experiment, device, {}


def _torch_config(device):
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.experiment import run_experiment
    from hefl_tpu_torch.results import convergence_configs

    device = resolve_device(device)
    return (convergence_configs()[CONFIG][1], run_experiment,
            lambda _cfg: device_record(device), {"device": device})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("torch", "jax"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default=None, help="torch side only (default: CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if args.side == "jax":
        base, run_experiment, device, kw = _jax_config()
    else:
        base, run_experiment, device, kw = _torch_config(args.device)
    for seed in args.seeds:
        cfg = dataclasses.replace(base, seed=seed)
        t0 = time.perf_counter()
        out = run_experiment(cfg, verbose=False, **kw)
        hist = out["history"]
        rec = {
            "config": CONFIG, "seed": seed, "accuracy": round(hist[-1]["accuracy"], 4),
            "accuracy_by_round": [round(h["accuracy"], 4) for h in hist],
            "dp_epsilon_final": round(hist[-1].get("dp_epsilon", float("nan")), 3),
            "wallclock_s": round(time.perf_counter() - t0, 2), "device": device(cfg),
        }
        print(json.dumps(rec), flush=True)
        try:
            with open(args.out) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = {}
        doc.setdefault(args.side, {})[str(seed)] = rec
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
