"""Image augmentation on the device: the `ImageDataGenerator` analog.

Counterpart of `hefl_tpu.data.augment` with the `gather` backend only: the
reference's rescale=1/255, shear_range=0.2, zoom_range=0.2 and
horizontal_flip=True as one per-image affine, sampled bilinearly in two
separable gather passes (vertical zoom, then shear + horizontal zoom/flip in
one x-gather). The inverse map is the JAX package's:
src_y = (y-cy)/zy + cy and src_x = f/zx*(x-cx) + cx + tan(s)/zx*(y-cy).

Randomness follows Keras: shear ~ U(-s, s) radians, zoom ~ U(1-z, 1+z) per
axis, flip with probability 1/2, drawn from a `torch.Generator`.
"""

from __future__ import annotations

import torch

from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs.scopes import scoped


def rescale(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (the reference's rescale=1/255)."""
    return images.to(torch.float32) / 255.0


def draw_affine_params(
    gen: torch.Generator, b: int, shear: float, zoom: float, flip: bool
):
    """One Keras-style random affine per image -> (s, zx, zy, f), each
    float32[b] on the generator's device: shear angle, per-axis zoom and
    flip sign."""
    dev = gen.device

    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo

    s = uniform(-shear, shear)
    zx = uniform(1.0 - zoom, 1.0 + zoom)
    zy = uniform(1.0 - zoom, 1.0 + zoom)
    f = torch.sign(torch.rand(b, generator=gen, device=dev) - 0.5) if flip else torch.ones(b, device=dev)
    return s, zx, zy, f


def _gather_axis(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    return torch.gather(x, axis, idx.expand(shape))


@scoped(scopes.AUGMENT)
def apply_affine(images, s, zx, zy, f) -> torch.Tensor:
    """Apply per-image affine params (shapes [b]) to a float batch
    [b, H, W, C]; the JAX package's `_affine_gather` (augment.py:172)."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = images.device
    yv = torch.arange(h, dtype=torch.float32, device=dev)
    xv = torch.arange(w, dtype=torch.float32, device=dev)
    # vertical zoom: gather rows at src_y = (y-cy)/zy + cy
    src_y = torch.clamp((yv[None, :] - cy) / zy[:, None] + cy, 0, h - 1)
    i0 = torch.floor(src_y).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=h - 1)
    fy = (src_y - i0.to(torch.float32))[:, :, None, None]
    r0 = _gather_axis(images, i0[:, :, None, None], 1)
    r1 = _gather_axis(images, i1[:, :, None, None], 1)
    t1 = r0 * (1.0 - fy) + r1 * fy
    # shear + horizontal zoom/flip fused into one x-gather
    delta = (torch.tan(s) / zx)[:, None] * (yv[None, :] - cy)          # [b, h]
    hx = (f / zx)[:, None] * (xv[None, :] - cx) + cx                  # [b, w]
    src_x = torch.clamp(hx[:, None, :] + delta[:, :, None], 0, w - 1)  # [b, h, w]
    j0 = torch.floor(src_x).to(torch.int64)
    j1 = torch.clamp(j0 + 1, max=w - 1)
    fx = (src_x - j0.to(torch.float32))[..., None]
    g0 = _gather_axis(t1, j0[..., None], 2)
    g1 = _gather_axis(t1, j1[..., None], 2)
    return g0 * (1.0 - fx) + g1 * fx
