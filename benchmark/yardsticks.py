"""The work a round needs, counted from the configuration's shapes, and
the card's peaks.

These count what the computation requires whatever implements it: a
conv or dense layer's multiply-adds from its shapes, and the bytes the HE
upload, fold and decrypt must move at least (each message and key read
once, each ciphertext written once). Nothing of the system under test is
read, so a later change to the system cannot move the yardstick.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, dense, at the 700 W power limit).
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def _same_out(size: int, stride: int) -> int:
    return math.ceil(size / stride)


def forward_flops(cfg: dict) -> int:
    """Multiply-adds x 2 of the conv and dense layers, one image forward."""
    h, w, c = cfg["input_shape"]
    k = cfg["num_classes"]
    total = 0
    if cfg["model"] == "medcnn":
        for f in cfg["features"]:
            oh, ow = h - 2, w - 2
            total += 2 * oh * ow * f * c * 9
            h, w, c = oh // 2, ow // 2, f
        width = h * w * c
        for d in list(cfg["dense"]) + [k]:
            total += 2 * width * d
            width = d
        return total
    if cfg["model"] == "resnet20":
        w0 = cfg["widths"][0]
        total += 2 * h * w * w0 * c * 9
        cin = w0
        for stage, (blocks, width) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                oh, ow = _same_out(h, stride), _same_out(w, stride)
                total += 2 * oh * ow * width * cin * 9          # Conv_0
                total += 2 * oh * ow * width * width * 9        # Conv_1
                if stride != 1 or cin != width:
                    total += 2 * oh * ow * width * cin          # the 1x1 projection
                h, w, cin = oh, ow, width
        return total + 2 * cin * k
    raise ValueError(f"unknown model {cfg['model']!r}")


def trained_images(recipe: dict, traffic: dict) -> int:
    """Images a round trains on: clients x epochs x steps x batch."""
    m = traffic["images_per_client"]
    n_val = max(int(m * recipe["val_fraction"]), 1)
    bs = min(recipe["batch_size"], m - n_val)
    steps = max((m - n_val) // bs, 1)
    return traffic["clients"] * recipe["epochs"] * steps * bs


def train_flops(cfg: dict, recipe: dict, traffic: dict) -> int:
    """A round's training FLOPs: forward x 3 (forward, and the backward's
    two products) over the images it trains on."""
    return 3 * forward_flops(cfg) * trained_images(recipe, traffic)


def n_ct(params: int, n: int) -> int:
    return -(-params // n)


def he_bytes(ckks: dict, params: int, clients: int) -> int:
    """Least bytes of a round's HE work: each client's encode residues read
    and its ciphertexts written, the public key read; the sum reads every
    ciphertext and writes one; the decrypt reads it and the secret key and
    writes the decoded float32 coefficients."""
    poly = ckks["num_primes"] * ckks["n"] * 4
    k = n_ct(params, ckks["n"])
    encrypt = clients * k * poly + 2 * poly + clients * k * 2 * poly
    fold = clients * k * 2 * poly + k * 2 * poly
    decrypt = k * 2 * poly + poly + k * ckks["n"] * 4
    return encrypt + fold + decrypt
