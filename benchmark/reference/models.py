"""Plain float32 forward passes of the benchmark's configurations.

Written from the published descriptions and the configuration files alone:
no kernel, cache or batching of the system under test, and nothing of it
imported. Parameters are a dict keyed by the names in `param_spec`, so the
benchmark can hand one set of weights to both sides:

  * MedCNN (the reference repository's `FLPyfhelin.py` CNN): six
    [conv 3x3 VALID -> ReLU -> max-pool 2x2] stages, flatten in NHWC order,
    dense 128 -> ReLU -> dense 64 -> ReLU -> dense classes.
  * ResNet-20 (He et al. 2016, arXiv:1512.03385 section 4.2): a 3x3 conv,
    three stages of three basic blocks at widths 16/32/64, stride 2 at the
    first block of stages 2 and 3 with a projection shortcut (1x1 conv),
    global mean pool, dense head. Departures, as the configuration file
    notes: GroupNorm(8) (eps 1e-6) in place of BatchNorm, convs without
    bias, "SAME" padding as XLA pads it (the smaller half low, so a 3x3
    stride-2 conv on an even size pads (0, 1)), projection shortcuts with
    a GroupNorm of their own.

Input images are NHWC float in [0, 1]; logits float32. `quant` rounds the
operands and the output of every conv and dense layer, and the gradients
that flow back through them, as a program computing in that precision
would (the control's lower precision); None computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GN_EPS = 1e-6


def param_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str, int]]:
    """[(name, shape, init, fan_in)] of the configuration, in the order the
    parameters are packed. init: "lecun" (truncated-normal kernel),
    "zeros" or "ones"."""
    h, w, c = cfg["input_shape"]
    out = []
    if cfg["model"] == "medcnn":
        for i, f in enumerate(cfg["features"]):
            out += [(f"Conv_{i}.weight", (f, c, 3, 3), "lecun", c * 9),
                    (f"Conv_{i}.bias", (f,), "zeros", 0)]
            h, w, c = (h - 2) // 2, (w - 2) // 2, f
        width = h * w * c
        for j, d in enumerate(list(cfg["dense"]) + [cfg["num_classes"]]):
            out += [(f"Dense_{j}.weight", (d, width), "lecun", width),
                    (f"Dense_{j}.bias", (d,), "zeros", 0)]
            width = d
        return out
    if cfg["model"] == "resnet20":
        groups_ = lambda name, f: [(f"{name}.weight", (f,), "ones", 0),  # noqa: E731
                                   (f"{name}.bias", (f,), "zeros", 0)]
        w0 = cfg["widths"][0]
        out += [("Conv_0.weight", (w0, c, 3, 3), "lecun", c * 9)] + groups_("GroupNorm_0", w0)
        cin, i = w0, 0
        for stage, (blocks, width) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                p = f"BasicBlock_{i}."
                out += [(p + "Conv_0.weight", (width, cin, 3, 3), "lecun", cin * 9)]
                out += groups_(p + "GroupNorm_0", width)
                out += [(p + "Conv_1.weight", (width, width, 3, 3), "lecun", width * 9)]
                out += groups_(p + "GroupNorm_1", width)
                if stride != 1 or cin != width:
                    out += [(p + "Conv_2.weight", (width, cin, 1, 1), "lecun", cin)]
                    out += groups_(p + "GroupNorm_2", width)
                cin, i = width, i + 1
        out += [("Dense_0.weight", (cfg["num_classes"], cin), "lecun", cin),
                ("Dense_0.bias", (cfg["num_classes"],), "zeros", 0)]
        return out
    raise ValueError(f"unknown model {cfg['model']!r}")


def resnet_blocks(cfg: dict) -> list[tuple[int, bool]]:
    """[(stride, projects)] of each basic block."""
    out, cin = [], cfg["widths"][0]
    for stage, (blocks, width) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out.append((stride, stride != 1 or cin != width))
            cin = width
    return out


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, wt, b=None, stride=1, same=False, quant=None):
    if quant is not None:
        x, wt = quant(x), quant(wt)
    if same:
        kh, kw = wt.shape[-2:]
        ph, pw = _same_pad(x.shape[-2], kh, stride), _same_pad(x.shape[-1], kw, stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    out = F.conv2d(x, wt, b, stride=stride)
    return out if quant is None else quant(out)


def _dense(x, wt, b, quant=None):
    if quant is not None:
        x, wt = quant(x), quant(wt)
    out = F.linear(x, wt, b)
    return out if quant is None else quant(out)


def _gn(x, p, name):
    return F.group_norm(x, 8, p[name + ".weight"], p[name + ".bias"], eps=GN_EPS)


def forward(cfg: dict, p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """x float [B, H, W, C] in [0, 1] -> float32 logits [B, classes]."""
    x = x.permute(0, 3, 1, 2)
    if cfg["model"] == "medcnn":
        for i in range(len(cfg["features"])):
            x = _conv(x, p[f"Conv_{i}.weight"], p[f"Conv_{i}.bias"], quant=quant)
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        n = len(cfg["dense"])
        for j in range(n + 1):
            x = _dense(x, p[f"Dense_{j}.weight"], p[f"Dense_{j}.bias"], quant)
            if j < n:
                x = F.relu(x)
        return x
    x = F.relu(_gn(_conv(x, p["Conv_0.weight"], same=True, quant=quant), p, "GroupNorm_0"))
    for i, (stride, projects) in enumerate(resnet_blocks(cfg)):
        q = f"BasicBlock_{i}."
        y = _conv(x, p[q + "Conv_0.weight"], stride=stride, same=True, quant=quant)
        y = F.relu(_gn(y, p, q + "GroupNorm_0"))
        y = _gn(_conv(y, p[q + "Conv_1.weight"], same=True, quant=quant), p, q + "GroupNorm_1")
        r = x
        if projects:
            r = _gn(_conv(x, p[q + "Conv_2.weight"], stride=stride, same=True, quant=quant),
                    p, q + "GroupNorm_2")
        x = F.relu(y + r)
    return _dense(x.mean(dim=(2, 3)), p["Dense_0.weight"], p["Dense_0.bias"], quant)


class _Round(torch.autograd.Function):
    """Rounds its input to a narrower float on the way forward and the
    gradient on the way back, each with a per-tensor scale (amax to the
    format's largest value, as fp8 training scales its tensors)."""

    generate_vmap_rule = True
    fwd: tuple = (torch.float8_e4m3fn, 448.0)
    bwd: tuple = (torch.float8_e5m2, 57344.0)

    @staticmethod
    def _round(x, fmt):
        dtype, top = fmt
        if dtype == torch.bfloat16:
            return x.to(torch.bfloat16).to(torch.float32)
        s = top / x.abs().amax().clamp(min=1e-30)
        return (x * s).to(dtype).to(torch.float32) / s

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class Fp8Round(_Round):
    """e4m3 forward, e5m2 backward: the float8 training recipe."""

    @staticmethod
    def forward(x):
        return _Round._round(x, Fp8Round.fwd)

    @staticmethod
    def backward(ctx, g):
        return _Round._round(g, Fp8Round.bwd)


class Bf16Round(_Round):
    """bfloat16 both ways: the configuration's own precision."""

    @staticmethod
    def forward(x):
        return _Round._round(x, (torch.bfloat16, None))

    @staticmethod
    def backward(ctx, g):
        return _Round._round(g, (torch.bfloat16, None))


QUANT = {"fp8": Fp8Round.apply, "bf16": Bf16Round.apply}
