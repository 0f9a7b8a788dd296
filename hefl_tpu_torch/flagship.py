"""Single source for the flagship experiment setup and its generator streams.

Counterpart of `hefl_tpu.flagship`. The flagship configuration is the
reference's headline experiment — 2 clients x 10 local epochs, one
encrypted FedAvg round, the 222,722-parameter MedCNN on the medical task
(1600 train / 400 test images at 256x256x3), N = 4096, L = 3 primes of 27
bits, scale 2**30: 55 ciphertexts a client — plus a 2-epoch linear lr
warm-up (`TrainConfig(warmup_steps=44)`). `bench.py` times it from here.

jax.random streams cannot be reproduced in torch, so the key streams are
the port's own generators: one keygen stream shared by every seed (the
reference generates one keypair for the experiment) and one round stream
per (seed, round).
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's headline numbers (BASELINE.md): the bars every flagship
# artifact compares itself against.
BASELINE_TOTAL_S = 6583.6   # total pipeline wall-clock
BASELINE_ACC = 0.8425       # test accuracy (weighted)


def flagship_setup(seed: int, smoke: bool = False, device=None) -> dict:
    """-> dict(module, params, cfg, ctx, train=(x, y), test=(xt, yt)), the
    model on `device` (CUDA unless given), the data as host arrays.

    `smoke=True` is the tiny-shape variant of the same code path (SmallCNN,
    MNIST 64 / 32 images, N = 512). `seed` varies the model's
    initialization and, through `flagship_round_gen`, every training,
    augmentation and encryption stream."""
    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.data import make_dataset
    from hefl_tpu_torch.fl import TrainConfig
    from hefl_tpu_torch.models import count_params, create_model

    gen = torch.Generator().manual_seed(seed + 123)
    if smoke:
        train, test, _ = make_dataset("mnist", seed=0, n_train=64, n_test=32)
        module = create_model("smallcnn", gen=gen, device=device)
        cfg = TrainConfig(epochs=1, batch_size=8, num_classes=10, val_fraction=0.25)
        ctx = CkksContext.create(n=512)
    else:
        train, test, _ = make_dataset("medical", seed=0)
        module = create_model("medcnn", gen=gen, device=device)
        if count_params(module) != 222_722:
            raise AssertionError(f"MedCNN has {count_params(module)} parameters, not 222,722")
        # Reference defaults (10 epochs, batch 32, augment, early stopping
        # and plateau) plus a 2-epoch linear lr warm-up.
        cfg = TrainConfig(warmup_steps=44)
        ctx = CkksContext.create()  # N=4096 -> 55 ciphertexts for 222,722 params
    return {
        "module": module,
        "params": {k: v.detach() for k, v in module.named_parameters()},
        "cfg": cfg,
        "ctx": ctx,
        "train": train,
        "test": test,
    }


def flagship_keygen_gen(device=None) -> torch.Generator:
    """The HE keygen stream (shared across seeds: the reference generates
    ONE keypair for the experiment), on `device` (the CPU by default; the
    bench's standalone encrypt draws its samples on the card)."""
    return torch.Generator(device=device or "cpu").manual_seed(99)


def flagship_round_gen(seed: int, round_index: int) -> torch.Generator:
    """The generator `bench.py` hands `secure_fedavg_round` for round
    `round_index` of seed `seed`: seeded by numpy's SeedSequence of
    (seed + 5, round_index), a 32-bit word (the CPU generator keeps 32 bits
    of its seed)."""
    word = np.random.SeedSequence([seed + 5, round_index]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(word))
