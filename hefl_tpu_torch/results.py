"""Measure every BASELINE.json config on the port; write RESULTS_TORCH.md and
RESULTS_TORCH.json.

Counterpart of the repository's root `results.py` (which writes RESULTS.md
and RESULTS.json for the JAX package; those files stay the JAX package's).
Each preset (`hefl_tpu_torch.presets`) runs end to end through
`experiment.run_experiment` on one device, and each record holds:

  * cold_round_s  — round 0 wall-clock (the kernels' build and the first
                    calls included)
  * warm_round_s  — min post-cold round wall-clock
  * rounds_per_sec_per_chip — 1 / warm_round_s
  * accuracy / precision / recall / f1 after the final round
  * device (`hefl_tpu_torch.device_record`) and power_limit: the card's
    name and its power limit, beside every time in the tables

Usage:
  python -m hefl_tpu_torch.results [preset ...]   presets (default: all five)
  python -m hefl_tpu_torch.results --convergence [name ...]
                                                  multi-round curves (the
                                                  nine configs of
                                                  `convergence_configs`)
  python -m hefl_tpu_torch.results --render       re-render RESULTS_TORCH.md
                                                  from the artifacts on
                                                  disk, measuring nothing
  --device cpu|cuda                               (default: CUDA, which must
                                                  be present)

RESULTS_TORCH.md also folds in the port's own artifacts when present:
`BENCH_TORCH.json` / `BENCH_TORCH_r*.json` (`python -m hefl_tpu_torch.bench`),
`flagship_acc_torch_*.json` (`python -m hefl_tpu_torch.flagship_acc`) and
`BENCH_TORCH_NTT.json` (`python -m hefl_tpu_torch.bench_ntt`). It reads no
artifact of the JAX package's runs, which measured a TPU or a CPU.

RESULTS_TORCH.json: {"presets": [...], "convergence": [...]}, merged across
invocations, so presets and convergence can be measured in separate runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

RESULTS_JSON = "RESULTS_TORCH.json"
RESULTS_MD = "RESULTS_TORCH.md"

PRESET_LABELS = {
    "mnist-plain": "1. 2-client plaintext FedAvg, SmallCNN, MNIST",
    "mnist-enc": "2. 2-client encrypted FedAvg, SmallCNN, MNIST",
    "medical-8": "3. 8-client encrypted FedAvg, MedCNN, medical IID",
    "medical-skew": "4. 8-client label-skew + FedProx, MedCNN, medical",
    "cifar-resnet16": "5. 16-client encrypted FedAvg, ResNet-20, CIFAR-10",
}


def _measure(name: str, label: str, cfg, device=None) -> dict:
    """Run one config through `run_experiment` on `device` -> its record
    (the JAX script's keys, plus power_limit)."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.experiment import run_experiment

    device = resolve_device(device)
    print(f"=== {name}: {label}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = run_experiment(cfg, verbose=True, device=device)
    wall = time.perf_counter() - t0
    hist = out["history"]
    final = hist[-1]
    # Min over post-cold rounds = steady state.
    warm = min(h["phases"]["total"] for h in hist[1:]) if len(hist) > 1 else None
    dev = device_record(device)
    return {
        "preset": name,
        "label": label,
        "device": dev,
        "power_limit": dev["power_limit"],
        "model": cfg.model,
        "dataset": cfg.dataset,
        "num_clients": cfg.num_clients,
        "encrypted": cfg.encrypted,
        "partition": cfg.partition,
        "prox_mu": cfg.train.prox_mu,
        "rounds": cfg.rounds,
        "seed": cfg.seed,
        "wallclock_s": round(wall, 2),
        "cold_round_s": round(hist[0]["phases"]["total"], 2),
        "warm_round_s": warm and round(warm, 2),   # steady = min warm round
        "rounds_per_sec_per_chip": warm and round(1.0 / warm, 4),
        "accuracy": round(final["accuracy"], 4),
        "precision": round(final["precision"], 4),
        "recall": round(final["recall"], 4),
        "f1": round(final["f1"], 4),
        **({"dp_epsilon_final": round(final["dp_epsilon"], 3)} if "dp_epsilon" in final
           else {}),
        "accuracy_by_round": [round(h["accuracy"], 4) for h in hist],
        "encode_overflow_total": sum(sum(h.get("encode_overflow", [])) for h in hist),
    }


def run_preset(name: str, rounds: int | None = None, epochs: int | None = None,
               device=None) -> dict:
    """Measure one preset at its full recipe; `rounds` / `epochs` cut its
    depth (a hook for the tests and chip_smoke.py, not a CLI flag)."""
    from hefl_tpu_torch.presets import PRESETS

    cfg = PRESETS[name]
    if rounds is not None:
        cfg = dataclasses.replace(cfg, rounds=rounds)
    if epochs is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=epochs))
    return _measure(name, PRESET_LABELS.get(name, name), cfg, device)


def convergence_configs() -> dict:
    """Long-horizon configs (the JAX script's nine): where accuracy has
    headroom, show the curve."""
    from hefl_tpu_torch.experiment import ExperimentConfig, HEConfig
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.dp import DpConfig
    from hefl_tpu_torch.presets import PRESETS

    # One base for every reduced-recipe MNIST variant: the seed and DP
    # variants stay "same experiment, different knob" by construction.
    mnist_base = ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=4, rounds=10,
        encrypted=True, n_train=1024, n_test=256,
        train=TrainConfig(epochs=3, batch_size=16, num_classes=10),
        he=HEConfig(), seed=0,
    )
    # The JAX script's DP operating point: 32 samples a client at lr 0.01
    # put per-client delta norms near the clip C = 1.5.
    cohort_base = ExperimentConfig(
        model="logreg", dataset="mnist", num_clients=256, rounds=10,
        encrypted=True, n_train=8192, n_test=256,
        train=TrainConfig(epochs=10, batch_size=8, num_classes=10, lr=0.01, augment=False),
        he=HEConfig(), seed=0,
    )
    return {
        "medical-flagship-8r": (
            "flagship 2-client encrypted medical, 8 rounds",
            ExperimentConfig(
                model="medcnn", dataset="medical", num_clients=2, rounds=8,
                encrypted=True, train=TrainConfig(warmup_steps=44), he=HEConfig(), seed=0,
            ),
        ),
        "cifar-resnet16-10r": (
            "16-client encrypted ResNet-20 CIFAR-10, 10 rounds",
            dataclasses.replace(PRESETS["cifar-resnet16"], rounds=10),
        ),
        "mnist-enc-10r": (
            "4-client encrypted SmallCNN MNIST (reduced recipe: 3 epochs, batch 16, 1024 "
            "samples), 10 rounds",
            mnist_base,
        ),
        "mnist-enc-dp-10r": (
            "4-client encrypted SmallCNN MNIST + DP (C=1, sigma=1; same reduced recipe), "
            "10 rounds",
            dataclasses.replace(mnist_base, dp=DpConfig()),
        ),
        "mnist-enc-10r-s1": (
            "4-client encrypted SmallCNN MNIST (reduced recipe), 10 rounds, seed 1",
            dataclasses.replace(mnist_base, seed=1),
        ),
        "mnist-enc-10r-s2": (
            "4-client encrypted SmallCNN MNIST (reduced recipe), 10 rounds, seed 2",
            dataclasses.replace(mnist_base, seed=2),
        ),
        "mnist-enc-dplow-10r": (
            "4-client encrypted SmallCNN MNIST + DP (C=1, sigma=0.1; same reduced recipe), "
            "10 rounds",
            dataclasses.replace(mnist_base, dp=DpConfig(noise_multiplier=0.1)),
        ),
        "mnist-enc-dp-cohort-10r": (
            "256-client encrypted LogReg MNIST + DP (C=1.5, sigma=2 -> eps 8.8; 32 "
            "samples/client, 10 epochs, batch 8, lr 0.01), 10 rounds",
            dataclasses.replace(cohort_base, dp=DpConfig(clip_norm=1.5, noise_multiplier=2.0)),
        ),
        "mnist-enc-cohort-10r": (
            "256-client encrypted LogReg MNIST, no DP (same recipe): the utility bar for the "
            "DP row",
            cohort_base,
        ),
    }


def run_convergence(names: list[str] | None = None, device=None) -> list[dict]:
    # Names are validated before any device work: a typo reports the
    # available configs, not a missing card.
    configs = convergence_configs()
    unknown = [n for n in (names or []) if n not in configs]
    if unknown:
        raise SystemExit(f"unknown convergence config(s) {unknown}; "
                         f"available: {sorted(configs)}")
    from hefl_tpu_torch import resolve_device

    device = resolve_device(device)
    records = []
    for name, (label, cfg) in configs.items():
        if names and name not in names:
            continue
        try:
            records.append(_measure(name, label, cfg, device))
        except Exception as e:  # one failed config must not cost the sweep
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            records.append({"preset": name, "error": str(e)})
    return records


# ---------------------------------------------------------------------------
# The port's artifacts.
# ---------------------------------------------------------------------------


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def load_bench_runs() -> list[dict]:
    """The headline bench's records (`BENCH_TORCH.json`, and
    `BENCH_TORCH_r*.json` of earlier runs), smoke runs and corrupt files
    left out."""
    rows = []
    for pth in ["BENCH_TORCH.json"] + sorted(glob.glob("BENCH_TORCH_r*.json")):
        rec = _load_json(pth) if os.path.exists(pth) else None
        if isinstance(rec, dict) and not rec.get("smoke"):
            rec["_seed_file"] = pth
            rows.append(rec)
    return rows


def load_flagship_runs() -> list[dict]:
    """The flagship accuracy records (`flagship_acc_torch_<seed>.json`), smoke
    runs and corrupt files left out."""
    rows = []
    for pth in sorted(glob.glob("flagship_acc_torch_*.json")):
        rec = _load_json(pth)
        if isinstance(rec, dict) and not rec.get("smoke"):
            rec["_seed_file"] = pth
            rows.append(rec)
    return rows


def load_ntt_bench() -> dict | None:
    """The kernel benchmark (`BENCH_TORCH_NTT.json`), when it was measured on
    a card."""
    rec = _load_json("BENCH_TORCH_NTT.json") if os.path.exists("BENCH_TORCH_NTT.json") else None
    if not isinstance(rec, dict) or (rec.get("device") or {}).get("platform") != "gpu":
        return None
    return rec


def _merge_records(old_list: list[dict], new_list: list[dict]) -> list[dict]:
    """Merge measurement records by preset name: re-measured rows replace
    same-name rows, others are kept, and a failed re-measure never clobbers
    a previously good row."""
    old = {r.get("preset"): r for r in old_list}
    for r in new_list:
        prev = old.get(r.get("preset"))
        if "error" in r and prev is not None and "error" not in prev:
            print(f"{r['preset']}: keeping previous good record", file=sys.stderr)
            continue
        old[r.get("preset")] = r
    return list(old.values())


def load_results() -> dict:
    if not os.path.exists(RESULTS_JSON):
        return {"presets": [], "convergence": []}
    data = _load_json(RESULTS_JSON)
    if data is None:
        return {"presets": [], "convergence": []}
    if isinstance(data, list):   # a bare preset list
        return {"presets": data, "convergence": []}
    data.setdefault("presets", [])
    data.setdefault("convergence", [])
    return data


def _device_cell(rec: dict) -> str:
    """A record's device as a table cell: the card's name and its power
    limit."""
    dev = rec.get("device")
    if isinstance(dev, dict):
        limit = dev.get("power_limit") or rec.get("power_limit")
        return f"{dev.get('kind', '?')} ({limit})" if limit else str(dev.get("kind", "?"))
    limit = rec.get("power_limit")
    return f"{dev} ({limit})" if dev and limit else str(dev or "?")


def write_markdown(data: dict) -> str:
    records = [r for r in data.get("presets", []) if "error" not in r]
    conv = [r for r in data.get("convergence", []) if "error" not in r]
    benches = load_bench_runs()
    flagship = load_flagship_runs()
    # The device string comes from the measured records, never from the
    # machine rendering them.
    devices = {_device_cell(r) for r in records + conv + benches + flagship if r.get("device")}
    dev = ", ".join(sorted(devices)) if devices else "(no measured records)"
    lines = [
        "# RESULTS_TORCH — BASELINE.json configs, measured on the port (hefl_tpu_torch)",
        "",
        f"Device: 1x {dev} (the card's name and its power limit as nvidia-smi gives them; "
        "every time below was measured there). RESULTS.md and RESULTS.json are the JAX "
        "package's.",
        "",
        "Reference's only measured config (2-client medical, CPU): 6583.6 s total, acc 0.8425 "
        "(BASELINE.md). Rows use the reference's local-training recipe — 10 local epochs, "
        "batch 32, Adam(1e-3, decay 1e-4), EarlyStopping/ReduceLROnPlateau — except rows whose "
        "label states its own reduced recipe. The data are the repository's synthetic "
        "generators (hefl_tpu_torch/data/synthetic.py), not the paper's chest X-rays; "
        "encode_overflow counts CKKS encoder saturation events (must be 0).",
    ]
    if records:
        lines += [
            "",
            "| config | device | clients | HE | rounds | cold round (s) | steady round (s) | "
            "rounds/sec/chip | accuracy | F1 | encode overflow |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in records:
            enc = "CKKS" if r["encrypted"] else "plain"
            if r["prox_mu"]:
                enc += f" + FedProx({r['prox_mu']})"
            lines.append(
                f"| {r['label']} | {_device_cell(r)} "
                f"| {r['num_clients']} | {enc} | {r['rounds']} "
                f"| {r['cold_round_s']} | {r['warm_round_s']} "
                f"| {r['rounds_per_sec_per_chip']} | {r['accuracy']} "
                f"| {r['f1']} | {r.get('encode_overflow_total', 'n/a')} |"
            )
        lines += [
            "",
            "Accuracy by round: "
            + "; ".join(f"{r['preset']}: {r['accuracy_by_round']}" for r in records),
        ]
    if benches:
        lines += [
            "",
            "## Flagship headline bench (`python -m hefl_tpu_torch.bench`)",
            "",
            "The root bench's experiment (MedCNN, 2 clients x 10 local epochs on 1600 "
            "`medical` images, N=4096 L=3) over its rounds: round 0 cold, the min of the "
            "rest steady.",
            "",
            "| run | device | cold round (s) | steady round (s) | rounds/sec/chip | "
            "accuracy by round | enc-vs-plain max diff | encode overflow |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for s in benches:
            diff = s.get("enc_plain_max_abs_diff")
            lines.append(
                f"| {s['_seed_file']} | {_device_cell(s)} | {s.get('value')} | "
                f"{s.get('steady_round_s')} | {s.get('rounds_per_sec_per_chip')} | "
                f"{s.get('accuracy_by_round')} | "
                f"{f'{diff:.2e}' if diff is not None else 'skipped'} | "
                f"{s.get('encode_overflow_count', 'n/a')} |"
            )
    if flagship:
        lines += [
            "",
            "## Flagship accuracy — the reference's headline measurement",
            "",
            "`python -m hefl_tpu_torch.flagship_acc`: 2 clients x 10 local epochs, ONE "
            "encrypted FedAvg round on the synthetic medical task — the experiment behind the "
            "reference's 0.8425 (`Encrypted FL Main-Rel.ipynb:331`), on other data.",
            "",
            "| run | device | epochs run/planned | accuracy | precision | recall | F1 | "
            "vs reference | wall-clock (s) |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for s in flagship:
            planned = s.get("local_epochs")
            lines.append(
                f"| {s['_seed_file']} | {_device_cell(s)} | "
                f"{s.get('epochs_run', planned)}/{planned} | {s.get('accuracy')} | "
                f"{s.get('precision')} | {s.get('recall')} | {s.get('f1')} | "
                f"{s.get('acc_vs_reference')} | {s.get('wallclock_s_total')} |"
            )
    if conv:
        lines += [
            "",
            "## Convergence — multi-round accuracy curves",
            "",
            "The reference stops after ONE communication round (SURVEY.md §2.11); the round "
            "loop must show accuracy climbing across rounds where the task has headroom. The "
            "256-client LogReg pair is the DP operating point (eps < 10) beside its DP-free "
            "twin, which isolates the utility cost (per-coordinate noise sigma*C/K against a "
            "signal ~C/sqrt(d), fl/dp.py); the 4-client CNN DP rows are the contrast: the "
            "same mechanism, a cohort too small for a 225k-parameter model.",
            "",
            "| config | device | rounds | accuracy by round | final acc | F1 | dp epsilon "
            "| steady round (s) |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for r in conv:
            lines.append(
                f"| {r['label']} | {_device_cell(r)} | {r['rounds']} "
                f"| {r['accuracy_by_round']} "
                f"| {r['accuracy']} | {r['f1']} "
                f"| {r.get('dp_epsilon_final', '—')} "
                f"| {r['warm_round_s']} |"
            )
    nb = load_ntt_bench()
    if nb and nb.get("kernels"):
        lines += [
            "",
            "## Kernels — the hand-written CUDA kernels against their plain PyTorch versions",
            "",
            f"Device: {_device_cell(nb)}; parity: {nb.get('parity')}. "
            f"`python -m hefl_tpu_torch.bench_ntt`; {nb.get('timing_method')}.",
            "",
            "| kernel | replaces | shape | device ms | plain ms | bound ms (by) |",
            "|---|---|---|---|---|---|",
        ]
        for k in nb["kernels"]:
            lines.append(
                f"| {k.get('name')} | {k.get('replaces')} | {k.get('shape')} | "
                f"{k.get('ms')} | {k.get('plain_ms')} | "
                f"{k.get('bound_ms')} ({k.get('bound_by')}) |"
            )
    lines += [
        "",
        f"Raw records: `{RESULTS_JSON}`. Regenerate: `python -m hefl_tpu_torch.results` + "
        "`python -m hefl_tpu_torch.results --convergence` (on the card) + the bench, "
        "flagship_acc and bench_ntt writers.",
    ]
    return "\n".join(lines) + "\n"


def _write_md(data: dict) -> None:
    with open(RESULTS_MD + ".tmp", "w") as f:
        f.write(write_markdown(data))
    os.replace(RESULTS_MD + ".tmp", RESULTS_MD)


def _write_evidence(data: dict, md_fatal: bool = True) -> None:
    """Atomic RESULTS_TORCH.json + RESULTS_TORCH.md dump: a kill mid-write
    must not truncate the merged evidence. `md_fatal=False` (the
    measurement loop's mode) demotes a markdown-render failure to a warning:
    the JSON is the evidence, and a render bug must not abort a sweep."""
    with open(RESULTS_JSON + ".tmp", "w") as f:
        json.dump(data, f, indent=2)
    os.replace(RESULTS_JSON + ".tmp", RESULTS_JSON)
    try:
        _write_md(data)
    except Exception:
        if md_fatal:
            raise
        import traceback

        print(f"WARNING: {RESULTS_MD} render failed ({RESULTS_JSON} saved):", file=sys.stderr)
        traceback.print_exc()


def _merge_presets(data: dict, records: list[dict]) -> None:
    merged = {r.get("preset"): r for r in _merge_records(data.get("presets", []), records)}
    order = list(PRESET_LABELS) + [k for k in merged if k not in PRESET_LABELS]
    data["presets"] = [merged[k] for k in order if k in merged]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m hefl_tpu_torch.results",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help="presets (or, with --convergence, configs)")
    p.add_argument("--convergence", action="store_true", help="the multi-round curves")
    p.add_argument("--render", action="store_true",
                   help=f"re-render {RESULTS_MD} from the artifacts on disk, measuring nothing")
    p.add_argument("--device", default=None, help="default: CUDA, which must be present")
    args = p.parse_args(argv)

    data = load_results()
    if args.render:
        pass  # re-render from on-disk artifacts; no measurement, no device
    elif args.convergence:
        data["convergence"] = _merge_records(data.get("convergence", []),
                                             run_convergence(args.names or None, args.device))
    else:
        from hefl_tpu_torch import resolve_device
        from hefl_tpu_torch.presets import BASELINE_PRESET_NAMES, PRESETS

        unknown = [n for n in args.names if n not in PRESETS]
        if unknown:
            raise SystemExit(f"unknown preset(s) {unknown}; available: {sorted(PRESETS)}")
        device = resolve_device(args.device)
        for name in args.names or list(BASELINE_PRESET_NAMES):
            try:
                rec = run_preset(name, device=device)
            except Exception as e:  # one failed preset must not cost the sweep
                print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
                rec = {"preset": name, "error": str(e)}
            # Persist after every preset, so a cut sweep keeps what finished.
            _merge_presets(data, [rec])
            _write_evidence(data, md_fatal=False)

    # Render-only regenerates the markdown alone; the preset path already
    # persisted inside its loop.
    if args.render:
        _write_md(data)
    elif args.convergence:
        _write_evidence(data)
    ok = [r for r in data["presets"] + data["convergence"] if "error" not in r]
    print(json.dumps({"measured": len(ok)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
