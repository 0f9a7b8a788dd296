"""The inputs: the same seed gives bitwise the same inputs, another seed
other ones; seeds past 32 bits work."""

import json
import os

import pytest
import torch

from benchmark import inputs
from benchmark.reference.models import param_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,shape", [("medcnn-medical", [64, 64, 3]),
                                        ("resnet20-cifar10", [32, 32, 3])])
@pytest.mark.parametrize("seed", [3, 2**31 + 12345, 2**40 + 7])
def test_same_seed_same_inputs(name, shape, seed):
    cfg = dict(_cfg(name), input_shape=shape)
    traffic = {"clients": 2, "images_per_client": 6, "test_images": 4}
    a = inputs.federated(cfg, traffic, seed, "cpu")
    b = inputs.federated(cfg, traffic, seed, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = inputs.federated(cfg, traffic, seed + 1, "cpu")
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.uint8 and tuple(a[0].shape) == (2, 6, *shape)
    assert 40 < float(a[0].float().mean()) < 215          # not saturated


@pytest.mark.parametrize("name", ["medcnn-medical", "resnet20-cifar10"])
def test_weights_and_streams_deterministic(name):
    cfg = _cfg(name)
    spec = param_spec(cfg)
    w1, w2 = (inputs.initial_weights(spec, 2**33 + 1, "cpu") for _ in range(2))
    w3 = inputs.initial_weights(spec, 2**33 + 2, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert any(not torch.equal(w1[k], w3[k]) for k in w1)
    assert sum(v.numel() for v in w1.values()) == cfg["params"]
    for k, shape, init, fan_in in spec:
        if init == "lecun":
            std = float(w1[k].std())
            assert 0.5 / fan_in ** 0.5 < std < 1.6 / fan_in ** 0.5, k
            assert float(w1[k].abs().max()) <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6, k
    traffic = {"clients": 3, "images_per_client": 20}
    p1, a1 = inputs.round_streams(cfg["recipe"], traffic, 9, 2, "cpu")
    p2, a2 = inputs.round_streams(cfg["recipe"], traffic, 9, 2, "cpu")
    p3, _ = inputs.round_streams(cfg["recipe"], traffic, 9, 3, "cpu")
    assert torch.equal(p1, p2) and all(torch.equal(x, y) for x, y in zip(a1, a2))
    assert not torch.equal(p1, p3)
    n_tr = 20 - 2
    assert tuple(p1.shape) == (3, 10 * (n_tr // 18), 18)
    # each epoch's rows are distinct images of the client's training part
    assert all(len(set(p1[c, e].tolist())) == 18 for c in range(3) for e in range(10))
