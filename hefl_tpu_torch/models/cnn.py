"""The reference CNNs as PyTorch modules, numerically shaped like the flax ones.

Counterpart of `hefl_tpu.models.cnn`. `MedCNN` is six [Conv 3x3 VALID ->
ReLU -> MaxPool 2x2] stages with filters (32, 32, 32, 64, 64, 128), then
Flatten -> Dense 128 ReLU -> Dense 64 ReLU -> Dense num_classes: 222,722
parameters at 256x256x3. `SmallCNN` is the 2-conv MNIST variant, `LogReg`
one Dense layer over the flattened image.

What is kept from the flax modules so weights carry across unchanged:
  * the input is NHWC float, as in the JAX package; it is permuted to NCHW
    for the convolutions;
  * the flatten is in NHWC order (`permute(0, 2, 3, 1).flatten(1)`), so
    `Dense_0`'s rows line up with the JAX package's without a permutation;
  * compute in bfloat16 with float32 parameters and float32 logits
    (flax `dtype=bfloat16, param_dtype=float32`): inputs, kernels and biases
    are cast to bf16, and the bias is added to the bf16 conv/matmul output;
  * parameters are named `Conv_i` / `Dense_i` like the flax scopes and
    initialized as flax does: LeCun-normal (truncated) kernels, zero biases.

`folded_apply` is the client-folded forward of the fused trainer
(`fl.fusion`, `models.folded`): the same network over a round's C clients
at once, with per-client weights.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hefl_tpu_torch.models.folded import (
    conv_bf16,
    flatten_clients,
    folded_conv,
    folded_dense,
    to_channels,
)

# flax's lecun_normal is variance_scaling(1, fan_in, "truncated_normal"): a
# normal truncated to [-2, 2] rescaled by this constant to unit variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class MedCNN(nn.Module):
    """The reference medical-image CNN (222,722 params at 256x256x3)."""

    def __init__(
        self,
        num_classes: int = 2,
        features: Sequence[int] = (32, 32, 32, 64, 64, 128),
        dense: Sequence[int] = (128, 64),
        input_shape: tuple[int, int, int] = (256, 256, 3),
    ):
        super().__init__()
        self.num_classes = num_classes
        self.features = tuple(features)
        self.dense = tuple(dense)
        h, w, c = input_shape
        for i, f in enumerate(self.features):
            setattr(self, f"Conv_{i}", nn.Conv2d(c, f, 3))
            h, w, c = (h - 2) // 2, (w - 2) // 2, f
        width = h * w * c
        for j, d in enumerate(self.dense):
            setattr(self, f"Dense_{j}", nn.Linear(width, d))
            width = d
        setattr(self, f"Dense_{len(self.dense)}", nn.Linear(width, num_classes))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        """flax initialization: LeCun-normal kernels, zero biases."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: float [B, H, W, C] -> float32 logits [B, num_classes]."""
        bf = torch.bfloat16
        x = x.permute(0, 3, 1, 2).to(bf)
        for i in range(len(self.features)):
            conv = getattr(self, f"Conv_{i}")
            x = F.max_pool2d(F.relu(conv_bf16(x, conv.weight, conv.bias)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        for j in range(len(self.dense) + 1):
            lin = getattr(self, f"Dense_{j}")
            x = F.linear(x, lin.weight.to(bf)) + lin.bias.to(bf)
            if j < len(self.dense):
                x = F.relu(x)
        return x.to(torch.float32)

    def folded_apply(self, stacked: dict, x: torch.Tensor, num_clients: int) -> torch.Tensor:
        """The client-folded forward (`TrainConfig.client_fusion="fused"`):
        the architecture and compute dtypes of `forward` over a round's C
        clients at once, each with its own weights.

        x: float [C*B, H, W, ch], client c owning rows [c*B, (c+1)*B);
        `stacked`: this model's parameter dict with a leading client axis on
        every tensor (`models.folded.stack_params`). Every conv is one
        grouped conv over the clients folded into channels, every dense one
        batched GEMM. -> float32 logits [C*B, num_classes]."""
        c = num_clients
        x = to_channels(x, c).to(torch.bfloat16)
        for i in range(len(self.features)):
            x = folded_conv(x, stacked[f"Conv_{i}.weight"], stacked[f"Conv_{i}.bias"])
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = flatten_clients(x, c)
        for j in range(len(self.dense) + 1):
            x = folded_dense(x, stacked[f"Dense_{j}.weight"], stacked[f"Dense_{j}.bias"])
            if j < len(self.dense):
                x = F.relu(x)
        return x.to(torch.float32).reshape(-1, self.num_classes)


class SmallCNN(MedCNN):
    """2-conv CNN for the MNIST configs (28x28x1, 10 classes)."""

    def __init__(
        self,
        num_classes: int = 10,
        features: Sequence[int] = (32, 64),
        dense: Sequence[int] = (128,),
        input_shape: tuple[int, int, int] = (28, 28, 1),
    ):
        super().__init__(num_classes, features, dense, input_shape)


class LogReg(MedCNN):
    """Multinomial logistic regression (flatten -> one Dense), the flax
    `LogReg`: a MedCNN without convolutions or hidden layers, so the
    flatten stays in NHWC order and the Dense computes in bfloat16."""

    def __init__(
        self,
        num_classes: int = 10,
        input_shape: tuple[int, int, int] = (28, 28, 1),
    ):
        super().__init__(num_classes, (), (), input_shape)


def count_params(model_or_params) -> int:
    """Total scalar parameter count (222,722 for MedCNN at 256x256x3)."""
    if isinstance(model_or_params, nn.Module):
        return sum(p.numel() for p in model_or_params.parameters())
    return sum(t.numel() for t in model_or_params.values())
