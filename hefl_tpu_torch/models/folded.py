"""Client-folded layer primitives: per-client weights, one op per layer.

Counterpart of `hefl_tpu.models.folded`. The fused training backend
(`TrainConfig.client_fusion="fused"`, `fl.fusion`) trains a round's C
clients through ONE forward and backward per step instead of one per
client. The layer math lives here.

The JAX package computes a per-client convolution as kh*kw client-batched
GEMMs with a custom VJP, a design for the TPU's matrix unit and XLA's slow
grouped-convolution transposes. Neither applies on the card: cuDNN runs a
grouped convolution and its transposes directly. So the port folds the
clients into the CHANNELS: inside the folded forward an activation is
[B, C*ch, H, W] (client c owns channels [c*ch, (c+1)*ch)), every conv is
one `F.conv2d(..., groups=C)` with the stacked filters [C*f, ch, kh, kw],
and every GroupNorm one normalisation over C*G groups, whose statistics
are per (sample, client, group): the per-sample statistics of each client's
own forward. Numerics are the JAX package's: bf16 operands, f32
accumulation, one rounding to bf16, the bias added in bf16; GroupNorm in
f32 with flax's eps and fast variance.

Every primitive is block-structured: client c's outputs depend only on
client c's inputs and weights, so the fused and per-client forwards agree
to float tolerance (`tests/test_torch_fusion.py`).

Layout contract:
  * `fold_clients` / `unfold_clients`: [C, B, ...] <-> [C*B, ...], client c
    owning the contiguous rows [c*B, (c+1)*B) (the JAX package's contract
    at a folded model's boundary, `folded_apply`'s input and output);
  * `to_channels`: the batch-folded NHWC images [C*B, H, W, ch] -> the
    channel-folded NCHW activations [B, C*ch, H, W] the primitives below
    take;
  * stacked params: the model's parameter dict with a leading client axis on
    every tensor (`stack_params`), in the port's layouts (conv OIHW, dense
    (out, in)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GN_EPS = 1e-6      # flax.linen.GroupNorm's epsilon (torch's default is 1e-5)


def fold_clients(x: torch.Tensor) -> torch.Tensor:
    """[C, B, ...] -> [C*B, ...] (client-major, contiguous per client)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_clients(x: torch.Tensor, num_clients: int) -> torch.Tensor:
    """[C*B, ...] -> [C, B, ...]."""
    return x.reshape((num_clients, x.shape[0] // num_clients) + tuple(x.shape[1:]))


def stack_params(params: dict, num_clients: int) -> dict:
    """One parameter dict -> the stacked per-client layout (every tensor
    gains a leading client axis): the fused trainer's round entry, where
    every client starts from the round's global weights."""
    return {k: v.detach().unsqueeze(0).repeat((num_clients,) + (1,) * v.dim())
            for k, v in params.items()}


def to_channels(x: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Batch-folded NHWC images [C*B, H, W, ch] -> channel-folded
    [B, C*ch, H, W], in the channels-last memory format (an NCHW view of
    NHWC memory, as a per-client forward's `x.permute(0, 3, 1, 2)` is), so
    cuDNN runs its NHWC kernels without converting layouts."""
    cb, h, w, ch = x.shape
    x = x.reshape(num_clients, cb // num_clients, h, w, ch).permute(1, 2, 3, 0, 4)
    return x.reshape(cb // num_clients, h, w, num_clients * ch).permute(0, 3, 1, 2)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis as (low, high): the total
    max((ceil(size/stride) - 1)*stride + kernel - size, 0), the smaller half
    low. At stride 2 on an even size a 3x3 kernel pads (0, 1), not
    PyTorch's symmetric (1, 1), which would shift the downsampling grid."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_bf16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
              stride: int = 1, padding: str = "VALID", groups: int = 1) -> torch.Tensor:
    """flax.linen.Conv(dtype=bf16, param_dtype=f32) on NCHW input: bf16
    operands, one rounding of the f32-accumulated sum to bf16, then the bias
    added in bf16. `padding` "VALID" or "SAME" (`same_padding`)."""
    x = x.to(torch.bfloat16)
    kh, kw = weight.shape[-2:]
    if padding == "SAME":
        ph = same_padding(x.shape[-2], kh, stride)
        pw = same_padding(x.shape[-1], kw, stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unsupported padding {padding!r}")
    out = F.conv2d(x, weight.to(torch.bfloat16), stride=stride, groups=groups)
    if bias is not None:
        out = out + bias.to(torch.bfloat16).reshape(-1, 1, 1)
    return out


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """flax.linen.GroupNorm(num_groups, dtype=f32) on NCHW input of any
    float dtype, computed in f32: statistics per (sample, group) over the
    group's channels and the spatial axes, the fast variance
    E[x^2] - E[x]^2 floored at 0, eps GN_EPS; the per-channel affine
    scale/bias [channels]. -> f32, channels-last like its input."""
    n, ch, h, w = x.shape
    # In NHWC order, a view of channels-last memory: [N, H, W, G, ch/G].
    xf = x.to(torch.float32).permute(0, 2, 3, 1).reshape(n, h, w, num_groups, ch // num_groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = xf.square().mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    xn = ((xf - mean) * torch.rsqrt(var + GN_EPS)).reshape(n, h, w, ch)
    out = xn * scale.to(torch.float32) + bias.to(torch.float32)
    return out.permute(0, 3, 1, 2)


def folded_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *,
                stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """Per-client 2-D convolution as ONE grouped convolution.

    x: channel-folded [B, C*ch, H, W]; weight: stacked per-client filters
    [C, f, ch, kh, kw]; bias: [C, f] or None. -> [B, C*f, H', W'] bf16, the
    numerics of `conv_bf16` for each client."""
    c = weight.shape[0]
    w = weight.reshape((c * weight.shape[1],) + tuple(weight.shape[2:]))
    return conv_bf16(x, w, None if bias is None else bias.reshape(-1), stride=stride,
                     padding=padding, groups=c)


def folded_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """Per-client dense layer as ONE batched GEMM in bf16.

    x: [C, B, d_in]; weight: [C, d_out, d_in] (the port's (out, in) layout,
    stacked); bias: [C, d_out] or None. -> [C, B, d_out] bf16 (flax Dense
    compute-dtype semantics)."""
    out = torch.bmm(x.to(torch.bfloat16), weight.to(torch.bfloat16).transpose(1, 2))
    if bias is not None:
        out = out + bias.to(torch.bfloat16)[:, None, :]
    return out


def folded_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                      num_groups: int) -> torch.Tensor:
    """flax GroupNorm on the channel-folded layout with per-client affines.

    x: [B, C*f, H, W] (any float dtype); scale/bias: [C, f]. One
    normalisation over C*num_groups groups: the statistics of client c's
    groups come from its own channels only, per sample, as in its own
    forward. -> f32."""
    c = scale.shape[0]
    return group_norm(x, scale.reshape(-1), bias.reshape(-1), c * num_groups)


def flatten_clients(x: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Channel-folded [B, C*ch, H, W] -> [C, B, H*W*ch]: each client's
    feature map flattened in NHWC order, as its own forward flattens it, so
    `Dense_0`'s rows line up."""
    b, cch, h, w = x.shape
    x = x.reshape(b, num_clients, cch // num_clients, h, w).permute(1, 0, 3, 4, 2)
    return x.reshape(num_clients, b, h * w * (cch // num_clients))
