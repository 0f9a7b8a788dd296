"""The FLOP count against PyTorch's FlopCounterMode on the plain reference,
and the HE byte count against ciphertext shapes worked by hand."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, yardsticks
from benchmark.reference.models import forward, param_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["medcnn-medical", "resnet20-cifar10"])
def test_forward_flops_match_flop_counter(name):
    cfg = _cfg(name)
    p = inputs.initial_weights(param_spec(cfg), 0, "cpu")
    x = torch.rand((1, *cfg["input_shape"]))
    with FlopCounterMode(display=False) as fc:
        forward(cfg, p, x)
    assert yardsticks.forward_flops(cfg) == fc.get_total_flops()


def test_counts_at_the_cells():
    med, res = _cfg("medcnn-medical"), _cfg("resnet20-cifar10")
    assert 0.50e9 < yardsticks.forward_flops(med) < 0.52e9
    assert 0.080e9 < yardsticks.forward_flops(res) < 0.084e9
    # fedavg32: 32 clients x 10 epochs x 5 steps x 32 images
    assert yardsticks.trained_images(med["recipe"], {"clients": 32, "images_per_client": 200}) \
        == 51200
    assert yardsticks.trained_images(res["recipe"], {"clients": 16, "images_per_client": 500}) \
        == 16 * 10 * 14 * 32


def test_he_bytes_by_hand():
    ck = {"n": 4096, "num_primes": 3}
    assert yardsticks.n_ct(222722, 4096) == 55 and yardsticks.n_ct(272474, 4096) == 67
    poly = 3 * 4096 * 4                       # one [L, N] int32 polynomial: 49,152 B
    ct = 2 * poly                             # a ciphertext (c0, c1)
    c, k = 32, 55
    encrypt = c * k * poly + 2 * poly + c * k * ct
    fold = c * k * ct + k * ct
    decrypt = k * ct + poly + k * 4096 * 4
    assert yardsticks.he_bytes(ck, 222722, 32) == encrypt + fold + decrypt
    assert 440e6 < yardsticks.he_bytes(ck, 222722, 32) < 450e6
