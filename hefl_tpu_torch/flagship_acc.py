"""Chunk-resumable flagship accuracy run.

Counterpart of the repository's root `flagship_acc.py`, on the port. The
reference's one quality number is test accuracy 0.8425 after ONE federated
round of 2 clients x 10 local epochs on the medical task
(`Encrypted FL Main-Rel.ipynb`:331,333; model FLPyfhelin.py:118-146). This
driver advances client training one epoch an iteration and checkpoints
every client's training state (`fl.client.ClientState`: params, Adam
moments, the LR-plateau, early-stopping and best-weights carries) after
each epoch (`utils.checkpoint.save_pytree`). A killed process resumes at
the next epoch boundary with the same semantics: the streams of every
epoch are drawn up front and sliced (`fl.client.split_epoch_streams`), so
the chunked run consumes exactly what one unchunked round consumes.

The setup is `bench.py`'s round 0 (`flagship.flagship_setup`: MedCNN,
1600 `medical` images, 2 clients, 10 epochs, N = 4096; the keygen stream
and the round generator `flagship_round_gen(seed, 0)`, split into the
clients' training and encryption generators as `fl.secure.client_uploads`
splits it), trained per client (the "vmap" backend) under
`experiment.deterministic_algorithms()`, so that a resumed run is bitwise
the unchunked one on the card too. After the last epoch the clients'
shipped weights (`client_shipped_params`) go through the real encrypted
aggregation (encrypt, K3; the sum mod p; the owner's decrypt, K4) before
the evaluation: the accuracy is the encrypted pipeline's.

The data is the synthetic `medical` set, not the paper's chest X-rays: the
accuracy is the port's on it, and `acc_vs_reference` compares it with the
paper's number only as a bar.

    python -m hefl_tpu_torch.flagship_acc [--seed 0] [--smoke] [--finish-now]
        [--device cpu]

`--finish-now` stops at the checkpoint and runs the encrypted tail on the
best-so-far weights (a partial record, `finish_reason: budget_cutoff`; the
checkpoint is kept). `run(..., chunk_epochs=K)` trains at most K epochs in
this process and returns with the checkpoint kept and no record, as a
killed run would leave it; `run(..., epochs=E)` cuts the recipe's local
epochs (both for the tests' and chip_smoke's short runs). Files (in the
working directory): `flagship_state_torch_{seed}.npz` (deleted when the
run completes or every client early-stopped) and
`flagship_acc_torch_{seed}.json` (the root record's fields plus the card's
name and power limit and the decrypted model's sha256); `--smoke` tags
them `smoke_{seed}` (SmallCNN, MNIST 64 / 32 images, N = 512). Runs on
CUDA unless `--device` says otherwise, and raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

NUM_CLIENTS = 2
NOTE = ("synthetic `medical` data (the repository's generator), not the paper's chest "
        "X-rays: the accuracy is the port's on it; acc_vs_reference is against the paper's "
        "0.8425 only as a bar")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def params_sha256(params: dict) -> str:
    """Digest of a parameter dict: the checkpoints' content sha256 over
    (name, dtype, shape, bytes) in name order."""
    from hefl_tpu_torch.utils.checkpoint import content_sha256

    return content_sha256({k: v.detach().cpu().numpy() for k, v in params.items()})


def run(seed: int = 0, smoke: bool = False, finish_now: bool = False, epochs: int | None = None,
        chunk_epochs: int = 0, device=None) -> tuple[dict | None, dict | None]:
    """Run or resume the flagship round of `seed` -> (record, decrypted
    params), or (None, None) when `chunk_epochs` ended this process before
    the last epoch."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.experiment import deterministic_algorithms

    device = resolve_device(device)
    with deterministic_algorithms():
        return _run(seed, smoke, finish_now, epochs, chunk_epochs, device, device_record(device))


def _run(seed, smoke, finish_now, epochs, chunk_epochs, device, dev):
    from hefl_tpu_torch.ckks import encoding
    from hefl_tpu_torch.ckks.backend import resolve_he_backend
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.packing import PackSpec, pack_params
    from hefl_tpu_torch.data import iid_contiguous, stack_federated
    from hefl_tpu_torch.fl.client import (
        client_shipped_params,
        epoch_index_streams,
        init_client_state,
        local_train_epochs,
        split_epoch_streams,
    )
    from hefl_tpu_torch.fl.fedavg import client_generators, evaluate
    from hefl_tpu_torch.fl.secure import aggregate_encrypted, decrypt_average, encrypt_stack
    from hefl_tpu_torch.flagship import (
        BASELINE_ACC,
        flagship_keygen_gen,
        flagship_round_gen,
        flagship_setup,
    )
    from hefl_tpu_torch.utils.checkpoint import load_pytree, npz_path, save_pytree

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    setup = flagship_setup(seed, smoke=smoke, device=device)
    model, params, cfg, ctx = setup["module"], setup["params"], setup["cfg"], setup["ctx"]
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=int(epochs))
    cfg = dataclasses.replace(cfg, client_fusion="vmap")
    (x, y), (xt, yt) = setup["train"], setup["test"]
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), NUM_CLIENTS))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    backend = resolve_he_backend(ctx, device)
    sk, pk = keygen(ctx, flagship_keygen_gen(), device=device)
    pack = PackSpec.for_params(params, ctx.n)
    # The round generator split as the secure round splits it: training
    # generators, then encryption generators; every epoch's streams drawn
    # now, so chunking changes nothing the run computes.
    round_gen = flagship_round_gen(seed, 0)
    train_gens = client_generators(round_gen, NUM_CLIENTS, device)
    enc_gens = client_generators(round_gen, NUM_CLIENTS, device)
    streams = [split_epoch_streams(epoch_index_streams(cfg, g, int(xs.shape[1])), cfg.epochs)
               for g in train_gens]

    tag = f"smoke_{seed}" if smoke else str(seed)
    state_path = f"flagship_state_torch_{tag}"
    out_path = f"flagship_acc_torch_{tag}.json"
    template = [init_client_state(params) for _ in range(NUM_CLIENTS)]
    epochs_done, val_curve, spent_s, devices = 0, [], 0.0, [dev["kind"]]
    if os.path.exists(npz_path(state_path)):
        states, meta = load_pytree(state_path, template)
        want = {"seed": seed, "local_epochs": cfg.epochs, "device_type": device.type}
        if {k: meta.get(k) for k in want} != want:
            raise RuntimeError(
                f"checkpoint {npz_path(state_path)} was written for "
                f"{ {k: meta.get(k) for k in want} }, not {want} (a CUDA run's streams are "
                "not a CPU run's); remove it to restart")
        epochs_done, val_curve = int(meta["epochs_done"]), meta["val_curve"]
        spent_s = float(meta["spent_s"])
        devices = meta["devices"] + ([dev["kind"]] if dev["kind"] not in meta["devices"] else [])
        log(f"resumed at epoch {epochs_done}/{cfg.epochs} ({spent_s:.3f} s spent so far)")
    else:
        states = template
    if finish_now and epochs_done == 0:
        raise SystemExit(f"--finish-now but no epoch checkpoint exists for seed {seed}; "
                         "refusing to evaluate untrained weights")
    trained = 0
    for e in range(epochs_done, cfg.epochs):
        if finish_now:
            log(f"--finish-now: stopping at epoch {e} of {cfg.epochs}; running the encrypted "
                "tail on the best-so-far weights")
            break
        if all(s.stopped for s in states):
            log(f"every client early-stopped before epoch {e + 1}; on to the encrypted tail")
            break
        if chunk_epochs and trained == chunk_epochs:
            log(f"chunk_epochs={chunk_epochs}: stopping after epoch {e}; the checkpoint "
                "resumes the run")
            return None, None
        sync()
        t0 = time.perf_counter()
        rows = []
        for c in range(NUM_CLIENTS):
            states[c], met = local_train_epochs(model, cfg, params, xs_d[c], ys_d[c], states[c],
                                                streams[c][e:e + 1])
            rows.append(met[0].tolist())
        sync()
        dt = time.perf_counter() - t0
        spent_s += dt
        trained += 1
        val_curve.append(rows)
        save_pytree(state_path, states, meta={
            "seed": seed, "local_epochs": cfg.epochs, "device_type": device.type,
            "devices": devices, "epochs_done": e + 1, "val_curve": val_curve,
            "spent_s": spent_s})
        m = np.asarray(rows)
        log(f"epoch {e + 1}/{cfg.epochs}: {dt:.3f} s | val_loss {m[:, 0].round(4).tolist()} "
            f"val_acc {m[:, 1].round(4).tolist()} | stopped {m[:, 3].astype(bool).tolist()}")

    # The encrypted tail: what each client uploads, encrypted (K3), summed
    # mod p, the owner's decrypt (K4), then the test metrics.
    sync()
    t0 = time.perf_counter()
    shipped = [client_shipped_params(s) for s in states]
    overflow = sum(int(encoding.encode_overflow_count(pack_params(p, ctx.n), ctx.scale))
                   for p in shipped)
    if overflow:
        log(f"WARNING: {overflow} weights clipped at the encoder envelope")
    ct_sum = aggregate_encrypted(ctx, encrypt_stack(ctx, pk, shipped, enc_gens))
    new_params = decrypt_average(ctx, sk, ct_sum, NUM_CLIENTS, pack)
    sync()
    he_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = evaluate(model, new_params, torch.from_numpy(xt).to(device), yt)
    sync()
    eval_s = time.perf_counter() - t0
    spent_s += he_s + eval_s
    finish_reason = ("completed" if len(val_curve) >= cfg.epochs
                     else "early_stopped" if all(s.stopped for s in states)
                     else "budget_cutoff")
    record = {
        "task": "flagship_accuracy",
        **({"smoke": True} if smoke else {}),
        "model": "smallcnn" if smoke else "medcnn",
        "dataset": "mnist" if smoke else "medical",
        "num_clients": NUM_CLIENTS,
        "rounds": 1,
        "local_epochs": cfg.epochs,
        "epochs_run": len(val_curve),
        "finish_reason": finish_reason,
        **({"partial": True} if finish_reason == "budget_cutoff" else {}),
        "seed": seed,
        "device": ", ".join(devices),
        "power_limit": dev["power_limit"],
        "he_backend": backend,
        "client_fusion": cfg.client_fusion,
        "deterministic_algorithms": True,
        "encrypted": True,
        "accuracy": round(float(results["accuracy"]), 4),
        "precision": round(float(results["precision"]), 4),
        "recall": round(float(results["recall"]), 4),
        "f1": round(float(results["f1"]), 4),
        "acc_vs_reference": round(float(results["accuracy"]) - BASELINE_ACC, 4),
        "val_curve": val_curve,
        "encode_overflow_count": overflow,
        "params_sha256": params_sha256(new_params),
        "he_tail_s": he_s,
        "evaluate_s": eval_s,
        "wallclock_s_total": spent_s,
        "note": NOTE,
    }
    with open(out_path + ".tmp", "w") as f:
        json.dump(record, f, indent=2)
    os.replace(out_path + ".tmp", out_path)
    if finish_reason != "budget_cutoff":
        # A budget-cut run keeps its checkpoint so a later run resumes it.
        try:
            os.remove(npz_path(state_path))
        except OSError:
            pass
    return record, new_params


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Chunk-resumable flagship accuracy run.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="SmallCNN, MNIST, N=512")
    ap.add_argument("--finish-now", action="store_true",
                    help="stop at the checkpoint and evaluate the best-so-far weights")
    ap.add_argument("--device", default=None, help="where the run runs (default: cuda)")
    args = ap.parse_args(argv)
    record, _ = run(args.seed, args.smoke, args.finish_now, device=args.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
