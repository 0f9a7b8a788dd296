"""HE-path fidelity at the flagship shape, over several seeds.

Counterpart of the repository's root `fidelity_check.py`, on the port. For
each seed it builds a MedCNN-sized parameter dict (222,722 weights, 55
ciphertexts a client at N = 4096, L = 3) of trained magnitude (normal with
std 0.45, clipped to |w| <= 0.75, full mantissas), encrypts it per client
(`fl.secure.encrypt_params`, one K3 launch a client), sums the two
ciphertexts mod p (`aggregate_encrypted`), decrypts the average
(`decrypt_average`, K4) through the float decode and the exact CRT decode,
and compares both with the plaintext mean. Encoder saturation
(`encode_overflow`) must be 0.

It measures the whole cryptographic path's error at the flagship's shapes
without training (the trained model's accuracy is `flagship_acc`'s
question). Reference counterpart: the notebook's plaintext-vs-encrypted
spot check (`Encrypted FL Main-Rel.ipynb` cell 6, FLPyfhelin.py:382-389).

    python -m hefl_tpu_torch.fidelity_check [--device cpu] [--seeds 0 1 2]
        [--out fidelity_check_torch.json]

prints the markdown table and writes the record: the root script's fields
(`device`, `n_ct`, `n`, `num_primes`, `num_clients`, `rows`,
`worst_max_abs_diff`, `bound`, `pass`) plus the card's power limit. Runs on
CUDA unless `--device` says otherwise, and raises without a card. Exit 0
when every seed holds the bound with no saturation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

NUM_CLIENTS = 2
BOUND = 1e-5                 # the root script's bound on the float decode
SEEDS = (0, 1, 2)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def client_weights(params: dict, rng: np.random.Generator, device) -> dict:
    """One client's weights of trained magnitude: normal(0, 0.15) x 3 in
    float32, clipped to [-0.75, 0.75] (the root script's draw)."""
    return {k: torch.from_numpy(
                np.clip(rng.normal(0.0, 0.15, tuple(v.shape)).astype(np.float32) * 3.0,
                        -0.75, 0.75)).to(device)
            for k, v in params.items()}


def seed_row(seed: int, device, ctx) -> dict:
    """One seed: encrypt two clients' weights, sum, decrypt (float and
    exact decode) -> {seed, max_abs_diff, max_abs_diff_exact_decode,
    encode_overflow, seconds}."""
    from hefl_tpu_torch.ckks.encoding import encode_overflow_count
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.ops import Ciphertext
    from hefl_tpu_torch.ckks.packing import PackSpec, pack_params
    from hefl_tpu_torch.fl.secure import aggregate_encrypted, decrypt_average, encrypt_params
    from hefl_tpu_torch.models import count_params, create_model

    model = create_model("medcnn", gen=torch.Generator().manual_seed(seed + 123), device=device)
    if count_params(model) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(model)} parameters, not 222,722")
    proto = {k: v.detach() for k, v in model.named_parameters()}
    spec = PackSpec.for_params(proto, ctx.n)
    if spec.n_ct != 55:
        raise AssertionError(f"{spec.n_ct} ciphertexts, not 55")
    sk, pk = keygen(ctx, torch.Generator().manual_seed(1000 + seed), device=device)
    rng = np.random.default_rng(seed)
    trees = [client_weights(proto, rng, device) for _ in range(NUM_CLIENTS)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cts = [encrypt_params(ctx, pk, t, torch.Generator(device=device).manual_seed(
        2000 + seed * 10 + c)) for c, t in enumerate(trees)]
    stacked = Ciphertext(c0=torch.stack([c.c0 for c in cts]),
                         c1=torch.stack([c.c1 for c in cts]), scale=cts[0].scale)
    ct_sum = aggregate_encrypted(ctx, stacked)
    avg = decrypt_average(ctx, sk, ct_sum, NUM_CLIENTS, spec)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    avg_exact = decrypt_average(ctx, sk, ct_sum, NUM_CLIENTS, spec, exact=True)
    expect = {k: sum(t[k] for t in trees) / NUM_CLIENTS for k in proto}
    overflow = sum(int(encode_overflow_count(pack_params(t, ctx.n), ctx.scale)) for t in trees)
    def max_abs_diff(got):
        return max(float((got[k] - expect[k]).abs().max()) for k in expect)

    return {"seed": seed, "max_abs_diff": max_abs_diff(avg),
            "max_abs_diff_exact_decode": max_abs_diff(avg_exact),
            "encode_overflow": overflow, "seconds": seconds}


def run(device=None, seeds=SEEDS) -> dict:
    """The fidelity record over `seeds` on `device` (CUDA unless given)."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.ckks.backend import resolve_he_backend
    from hefl_tpu_torch.ckks.keys import CkksContext

    device = resolve_device(device)
    ctx = CkksContext.create()               # the flagship's N = 4096, L = 3
    backend = resolve_he_backend(ctx, device)
    rec = device_record(device)
    log(f"fidelity_check on {rec['kind']} ({rec['power_limit']}), HE backend {backend}")
    rows = []
    for seed in seeds:
        row = seed_row(int(seed), device, ctx)
        rows.append(row)
        log(f"seed {seed}: max|enc_avg - plain_avg| = {row['max_abs_diff']:.2e} (exact decode "
            f"{row['max_abs_diff_exact_decode']:.2e}), overflow {row['encode_overflow']}, "
            f"encrypt+sum+decrypt {row['seconds']:.4f} s")
    worst = max(r["max_abs_diff"] for r in rows)
    ok = worst <= BOUND and all(r["encode_overflow"] == 0 for r in rows)
    return {"device": rec["kind"], "power_limit": rec["power_limit"], "he_backend": backend,
            "n_ct": 55, "n": ctx.n, "num_primes": ctx.num_primes, "num_clients": NUM_CLIENTS,
            "rows": rows, "worst_max_abs_diff": worst, "bound": BOUND, "pass": ok}


def markdown(rec: dict) -> str:
    lines = ["| seed | enc-vs-plain max diff | exact-decode diff | overflow |",
             "|---|---|---|---|"]
    lines += [f"| {r['seed']} | {r['max_abs_diff']:.2e} | {r['max_abs_diff_exact_decode']:.2e} "
              f"| {r['encode_overflow']} |" for r in rec["rows"]]
    lines.append(f"\nworst-case {rec['worst_max_abs_diff']:.2e} over {len(rec['rows'])} seeds at "
                 f"flagship shapes (55 cts, N=4096, 2 clients) on {rec['device']} "
                 f"({rec['power_limit']}) — bound {rec['bound']:g}: "
                 f"{'PASS' if rec['pass'] else 'FAIL'}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="HE-path fidelity at the flagship shape.")
    ap.add_argument("--device", default=None, help="where the run runs (default: cuda)")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--out", default="fidelity_check_torch.json")
    args = ap.parse_args(argv)
    rec = run(args.device, args.seeds)
    print(markdown(rec))
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
