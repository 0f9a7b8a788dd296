"""Train-step MFU probe: is the MedCNN training step compute- or latency-bound?

Counterpart of the repository's root `mfu_probe.py`, on the port. It times
ONE training step of the MedCNN at 256x256x3, `fl.client.train_step`
(rescale, the augment warp, the `fl.loss` gradient, `fl.optimizer.
adam_update`), across the batch ladder 8, 16, 32, 64, 128, 256, and reports
each point's step time, images/s, FLOPs and MFU. The FLOPs are
`utils.roofline.model_flops` (torch.utils.flop_counter's conv and matmul
count of one forward) x 3 for the forward and backward, as the round
records' `train_mfu` counts them; MFU is against the card's dense bf16
peak (`utils.roofline`).

The diagnostic: the reference trains at batch 32. If the step time is
about flat from batch 8 to 64 while images/s grows with the batch, the
step is latency-bound at small batch (launches and host work, not the
card's arithmetic) and its MFU at batch 32 is a property of the problem
size; if images/s is flat, the step is compute-bound.

    python -m hefl_tpu_torch.mfu_probe [--smoke] [--device cpu]

Each point runs 2 warm-up steps, then 30 timed steps ending in
`torch.cuda.synchronize()`. `--smoke` is a CPU shakeout: batches 2 and 4
of a narrow MedCNN (4-8 channels), 1 timed step. It prints the markdown
table and writes `mfu_probe_torch.json` in the working directory (the
root record's keys, `flops` in place of `xla_flops`, `flops_counter`, and
the card's name and power limit). Runs on CUDA unless `--device` says
otherwise, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

LADDER = (8, 16, 32, 64, 128, 256)
SMOKE_LADDER = (2, 4)
WARMUP = 2
REPS = 30
HW = 256                      # 6 conv+pool stages need the full input
SMOKE_WIDTH = dict(features=(4, 4, 4, 8, 8, 8), dense=(16, 8))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(device=None, smoke: bool = False) -> dict:
    """The ladder on `device` (CUDA unless given) -> the record."""
    import torch.nn.functional as F

    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.data.augment import draw_affine_params
    from hefl_tpu_torch.experiment import augment_backend_record
    from hefl_tpu_torch.fl.client import train_step
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.optimizer import adam_init
    from hefl_tpu_torch.models.cnn import MedCNN
    from hefl_tpu_torch.utils import roofline

    device = resolve_device(device)
    dev = device_record(device)
    peak, placeholder = roofline.peak_flops(device)
    if placeholder:
        log(f"WARNING: CPU-placeholder peak for {dev['kind']!r}: absolute MFU values are "
            "meaningless, only the batch-scaling shape is")
    log(f"device: {dev['kind']} ({dev['power_limit']}), peak bf16 "
        f"{(peak or 0) / 1e12:.0f} TFLOP/s")
    cfg = TrainConfig()
    model = MedCNN(input_shape=(HW, HW, 3), **(SMOKE_WIDTH if smoke else {}))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    reps = 1 if smoke else REPS

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    for bs in SMOKE_LADDER if smoke else LADDER:
        x_u8 = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, (bs, HW, HW, 3), np.uint8)).to(device)
        y = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (bs,))).to(device)
        onehot = F.one_hot(y, cfg.num_classes).to(torch.float32)
        aug = draw_affine_params(torch.Generator(device=device).manual_seed(2), bs,
                                 cfg.aug_shear, cfg.aug_zoom, cfg.aug_flip)
        flops = 3.0 * roofline.model_flops(model, (bs, HW, HW, 3))
        p, o = params, adam_init(params)
        for _ in range(WARMUP):
            p, o = train_step(model, cfg, p, o, np.float32(1.0), x_u8, onehot, aug, params)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            p, o = train_step(model, cfg, p, o, np.float32(1.0), x_u8, onehot, aug, params)
        sync()
        dt = (time.perf_counter() - t0) / reps
        rows.append({"batch": bs, "step_ms": round(dt * 1e3, 3),
                     "images_per_s": round(bs / dt, 1), "flops": flops,
                     "mfu": round(roofline.mfu(flops, dt, device) or 0.0, 4)})
        log(f"  batch {bs}: {dt * 1e3:.3f} ms")
    lat, big = rows[0]["step_ms"], rows[-1]["step_ms"]
    span = rows[-1]["batch"] // rows[0]["batch"]
    verdict = (f"latency-bound at small batch (step time grows {big / lat:.1f}x over a "
               f"{span}x batch ladder)" if big / lat < span / 2
               else "compute-bound (step time tracks batch size)")
    return {"device": dev["kind"], "power_limit": dev["power_limit"], "smoke": smoke,
            "peak_flops": peak, "peak_is_placeholder": placeholder,
            "flops_counter": "torch.utils.flop_counter",
            "augment_backend": augment_backend_record(), "warmup_steps": WARMUP,
            "timed_steps": reps, "rows": rows, "verdict": verdict}


def markdown(rec: dict) -> str:
    lines = ["| batch | step (ms) | images/s | GFLOP/step | MFU |", "|---|---|---|---|---|"]
    lines += [f"| {r['batch']} | {r['step_ms']:.3f} | {r['images_per_s']:.0f} "
              f"| {r['flops'] / 1e9:.1f} | {r['mfu']:.4f} |" for r in rec["rows"]]
    lines.append(f"\nverdict: {rec['verdict']} ({rec['device']}, {rec['power_limit']})")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="MedCNN train-step MFU over a batch ladder.")
    ap.add_argument("--smoke", action="store_true", help="batches 2, 4 of a narrow MedCNN")
    ap.add_argument("--device", default=None, help="where the run runs (default: cuda)")
    args = ap.parse_args(argv)
    rec = run(args.device, args.smoke)
    print(markdown(rec))
    with open("mfu_probe_torch.json", "w") as f:
        json.dump(rec, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
