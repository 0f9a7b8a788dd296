"""ResNet-20 (CIFAR-10 variant) for the 16-client configuration.

Counterpart of `hefl_tpu.models.resnet`: the He et al. CIFAR depth-20
network, three stages of `stage_sizes` basic blocks with widths `widths`
((3, 3, 3) and (16, 32, 64): 272,474 parameters at 32x32x3, 67 ciphertexts
at N = 4096), stride-2 downsampling at the first block of every later
stage, global mean pool, linear head. Normalization is GroupNorm(8), not
BatchNorm, so every learnable is a plain weight that the encrypted
aggregation covers.

Kept from the flax modules so weights carry across unchanged (as
`models.cnn` does): NHWC input; 3x3 convs without bias in bf16 with "SAME"
padding as XLA pads it (`models.folded.same_padding`); GroupNorm in f32
with flax's eps and fast variance; a projection shortcut (1x1 conv +
GroupNorm) where the shape changes; the Dense head in bf16 and float32
logits; parameters named after the flax scopes (`Conv_0`, `GroupNorm_0`,
`BasicBlock_0..8` each with `Conv_0..2` / `GroupNorm_0..2`, `Dense_0`; a
GroupNorm's affine is `weight`/`bias` here, `scale`/`bias` there) and
initialized as flax does (LeCun-normal kernels, GroupNorm scale 1 and bias
0, zero Dense bias).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hefl_tpu_torch.models.cnn import _lecun_normal_
from hefl_tpu_torch.models.folded import (
    conv_bf16,
    folded_conv,
    folded_dense,
    folded_group_norm,
    group_norm,
    to_channels,
)

GROUPS = 8


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs with GroupNorm and a residual: a projection shortcut
    (`Conv_2`, `GroupNorm_2`) when the block changes width or stride."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = _conv(cin, features, 3)
        self.GroupNorm_0 = nn.GroupNorm(GROUPS, features)
        self.Conv_1 = _conv(features, features, 3)
        self.GroupNorm_1 = nn.GroupNorm(GROUPS, features)
        if stride != 1 or cin != features:
            self.Conv_2 = _conv(cin, features, 1)
            self.GroupNorm_2 = nn.GroupNorm(GROUPS, features)

    @property
    def projects(self) -> bool:
        return hasattr(self, "Conv_2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (bf16 or f32) -> f32."""
        def gn(mod, h):
            return group_norm(h, mod.weight, mod.bias, GROUPS)

        y = conv_bf16(x, self.Conv_0.weight, stride=self.stride, padding="SAME")
        y = F.relu(gn(self.GroupNorm_0, y))
        y = gn(self.GroupNorm_1, conv_bf16(y, self.Conv_1.weight, padding="SAME"))
        residual = x
        if self.projects:
            residual = gn(self.GroupNorm_2, conv_bf16(x, self.Conv_2.weight, stride=self.stride,
                                                      padding="SAME"))
        return F.relu(y + residual)


class ResNet20(nn.Module):
    """ResNet-20 with GroupNorm(8): 272,474 parameters at the defaults."""

    def __init__(
        self,
        num_classes: int = 10,
        stage_sizes: Sequence[int] = (3, 3, 3),
        widths: Sequence[int] = (16, 32, 64),
        input_shape: tuple[int, int, int] = (32, 32, 3),
    ):
        super().__init__()
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)
        self.widths = tuple(widths)
        cin = input_shape[2]
        self.Conv_0 = _conv(cin, widths[0], 3)
        self.GroupNorm_0 = nn.GroupNorm(GROUPS, widths[0])
        cin, i = widths[0], 0
        for stage, (blocks, width) in enumerate(zip(self.stage_sizes, self.widths)):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, f"BasicBlock_{i}", BasicBlock(cin, width, stride))
                cin, i = width, i + 1
        self.num_blocks = i
        self.Dense_0 = nn.Linear(cin, num_classes)

    def blocks(self):
        return [getattr(self, f"BasicBlock_{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        """flax initialization: LeCun-normal kernels, GroupNorm scale 1 and
        bias 0, zero Dense bias."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.GroupNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: float [B, H, W, C] -> float32 logits [B, num_classes]."""
        x = conv_bf16(x.permute(0, 3, 1, 2), self.Conv_0.weight, padding="SAME")
        x = F.relu(group_norm(x, self.GroupNorm_0.weight, self.GroupNorm_0.bias, GROUPS))
        for block in self.blocks():
            x = block(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x.to(torch.bfloat16), self.Dense_0.weight.to(torch.bfloat16))
        return (x + self.Dense_0.bias.to(torch.bfloat16)).to(torch.float32)

    def folded_apply(self, stacked: dict, x: torch.Tensor, num_clients: int) -> torch.Tensor:
        """The client-folded forward (see `MedCNN.folded_apply`): the same
        depth-20 network over C clients folded into channels, every conv one
        grouped conv, every GroupNorm one normalisation over C*8 groups
        with per-client affines. x: [C*B, H, W, ch]; `stacked`: this model's
        parameter dict with a leading client axis. -> float32 [C*B, classes].
        """
        c = num_clients

        def gn(name, h):
            return folded_group_norm(h, stacked[f"{name}.weight"], stacked[f"{name}.bias"],
                                     num_groups=GROUPS)

        def conv(name, h, stride=1):
            return folded_conv(h, stacked[f"{name}.weight"], None, stride=stride, padding="SAME")

        x = F.relu(gn("GroupNorm_0", conv("Conv_0", to_channels(x, c))))
        for i, block in enumerate(self.blocks()):
            p = f"BasicBlock_{i}."
            y = F.relu(gn(p + "GroupNorm_0", conv(p + "Conv_0", x, block.stride)))
            y = gn(p + "GroupNorm_1", conv(p + "Conv_1", y))
            residual = x
            if block.projects:
                residual = gn(p + "GroupNorm_2", conv(p + "Conv_2", x, block.stride))
            x = F.relu(y + residual)
        b = x.shape[0]
        x = x.mean(dim=(2, 3)).reshape(b, c, -1).transpose(0, 1)          # [C, B, width]
        x = folded_dense(x, stacked["Dense_0.weight"], stacked["Dense_0.bias"])
        return x.to(torch.float32).reshape(-1, self.num_classes)
