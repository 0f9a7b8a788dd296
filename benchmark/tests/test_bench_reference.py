"""The plain reference computes what the system computes: the same
forward pass (to the system's bfloat16 rounding) and the same augment
warp, on the same weights and draws."""

import json
import os

import pytest
import torch

from benchmark import inputs
from benchmark.reference import train as ref_train
from benchmark.reference.models import QUANT, forward, param_spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name, **kw):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return dict(json.load(f), **kw)


def _system_model(cfg):
    from hefl_tpu_torch.models import MedCNN, ResNet20

    shape = tuple(cfg["input_shape"])
    if cfg["model"] == "medcnn":
        return MedCNN(cfg["num_classes"], cfg["features"], cfg["dense"], shape)
    return ResNet20(cfg["num_classes"], cfg["stage_sizes"], cfg["widths"], shape)


@pytest.mark.parametrize("name,kw", [
    ("medcnn-medical", {"input_shape": [190, 190, 3]}),
    ("resnet20-cifar10", {}),
])
def test_forward_matches_the_system(name, kw):
    from torch.func import functional_call

    cfg = _cfg(name, **kw)
    model = _system_model(cfg)
    spec = param_spec(cfg)
    assert [(k, tuple(v.shape)) for k, v in model.named_parameters()] == \
        [(k, s) for k, s, _, _ in spec]
    p = inputs.initial_weights(spec, 4, "cpu")
    if cfg["model"] == "resnet20":     # non-trivial GroupNorm affines and biases
        g = torch.Generator().manual_seed(1)
        p = {k: v + 0.1 * torch.randn(v.shape, generator=g) if "GroupNorm" in k else v
             for k, v in p.items()}
    x = torch.rand((6, *cfg["input_shape"]), generator=torch.Generator().manual_seed(2))
    want = functional_call(model, p, (x,))
    got32 = forward(cfg, p, x)
    got16 = forward(cfg, p, x, QUANT["bf16"])
    scale = float(want.abs().max())
    assert float((got32 - want).abs().max()) < 0.05 * scale
    # bf16 operands bring the reference to within the system's output roundings
    assert float((got16 - want).abs().max()) < float((got32 - want).abs().max()) + 0.02 * scale
    assert torch.equal(got32.argmax(-1), want.argmax(-1)) or scale < 1e-3


def test_augment_matches_the_system():
    from hefl_tpu_torch.data.augment import apply_affine

    g = torch.Generator().manual_seed(3)
    x = torch.rand((5, 40, 48, 3), generator=g)
    s = (torch.rand(5, generator=g) * 2 - 1) * 0.2
    zx = 1 + (torch.rand(5, generator=g) * 2 - 1) * 0.2
    zy = 1 + (torch.rand(5, generator=g) * 2 - 1) * 0.2
    f = torch.tensor([1.0, -1.0, 1.0, -1.0, -1.0])
    want = apply_affine(x, s, zx, zy, f, backend="gather")
    got = ref_train.augment(x, s, zx, zy, f)
    assert float((got - want).abs().max()) < 2e-5


def test_quantized_controls_round_their_operands():
    x = torch.linspace(-3, 3, 1001)
    q8 = QUANT["fp8"](x)
    q16 = QUANT["bf16"](x)
    rel8 = float(((q8 - x).abs() / x.abs().clamp(min=0.05)).max())
    rel16 = float(((q16 - x).abs() / x.abs().clamp(min=0.05)).max())
    assert 0.01 < rel8 < 0.07 and 1e-4 < rel16 < 5e-3
