"""Image augmentation on the device: the `ImageDataGenerator` analog.

Counterpart of `hefl_tpu.data.augment`: the reference's rescale=1/255,
shear_range=0.2, zoom_range=0.2 and horizontal_flip=True as one per-image
affine whose inverse map is the JAX package's,
src_y = (y-cy)/zy + cy and src_x = f/zx*(x-cx) + cx + tan(s)/zx*(y-cy).

Row-shift backends (`HEFL_AUG_SHIFT` / `TrainConfig.aug_backend`), the JAX
package's three:

  * ``gather`` -- the whole affine sampled bilinearly in two separable
                  gather passes (vertical zoom, then shear + horizontal
                  zoom/flip in one x-gather): Keras' kernel, convex, no
                  clamp pass.
  * ``fft``    -- three stages: vertical zoom as a batched matmul with a
                  one-hot bilinear matrix per image, the shear as a
                  bandlimited (sinc) row shift through `torch.fft.rfft` /
                  `irfft` (bin f rotated by e^{2 pi i f delta / W}), and
                  horizontal zoom + flip as a second one-hot matmul.
  * ``dft``    -- the same three stages with the shift as constant cos/sin
                  DFT matrices (matmuls, O(W*F) a row).
  * ``auto``   -- (default) the full augment timed per backend on the live
                  device at `_PROBE_SHAPE`; the winner is cached for the
                  process per device name and persisted by
                  `utils.autoselect` under "augment_shift".

The spectral shift rings at sharp edges (Gibbs), so the sheared rows are
clamped back to each image's own range; the row is edge-padded by `_PAD`
against the transform's circular wrap. Every matmul runs in float32 (the
port never enables TF32).

Randomness follows Keras: shear ~ U(-s, s) radians, zoom ~ U(1-z, 1+z) per
axis, flip with probability 1/2, drawn from a `torch.Generator`.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs.scopes import scoped
from hefl_tpu_torch.utils.autoselect import device_name as _device_name
from hefl_tpu_torch.utils.autoselect import load_winner, store_winner
from hefl_tpu_torch.utils.autoselect import time_backend as _time_backend

# Edge padding for the spectral shift: above the worst-case shear
# displacement tan(0.2)/0.8 * 127.5 = 32.3 px at the Keras ranges on
# 256x256, else the circular wrap leaks the opposite edge into corner rows.
_PAD = 40

SHIFT_BACKENDS = ("gather", "fft", "dft")

# The requested backend: a name pins one, "auto" (default) times the three
# at first use. Read once at import, as the JAX module reads it;
# TrainConfig.aug_backend / random_augment(backend=...) override it.
_ENV_BACKEND = os.environ.get("HEFL_AUG_SHIFT", "auto")

# Process-global selection state: the auto winner per device name, the
# timings behind the last auto choice, whether it came from the persisted
# file, and the last resolution (per-call pins included), which
# `backend_report()` describes.
_AUTO_CHOICE: dict[str, str] = {}
_AUTO_TIMINGS_MS: dict[str, float] | None = None
_AUTO_PERSISTED: bool = False
_LAST_RESOLVED: str | None = None

# The auto probe's batch: a quarter of the flagship training batch.
_PROBE_SHAPE = (8, 256, 256, 3)


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


def _lin_weights(src: torch.Tensor, n: int) -> torch.Tensor:
    """Sample positions [..., M] -> bilinear one-hot matrix [..., M, n]."""
    f = torch.clamp(torch.floor(src), 0, n - 1)
    frac = src - f
    i0 = f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    eye = torch.arange(n, device=src.device)
    w0 = (1 - frac)[..., None] * (eye == i0[..., None])
    w1 = frac[..., None] * (eye == i1[..., None])
    return (w0 + w1).to(torch.float32)


@functools.lru_cache(maxsize=8)
def _dft_mats(wp: int):
    """Real-DFT analysis (cos, sin) and synthesis (cos, sin) matrices
    [wp//2+1, wp] for length wp, built in float64 on the host and stored
    as float32."""
    f = np.arange(wp // 2 + 1)
    m = np.arange(wp)
    ang = 2 * np.pi * np.outer(f, m) / wp
    wgt = np.full(wp // 2 + 1, 2.0)
    wgt[0] = 1.0
    if wp % 2 == 0:
        wgt[-1] = 1.0
    return (
        np.cos(ang).astype(np.float32),
        np.sin(ang).astype(np.float32),
        (np.cos(ang) * wgt[:, None] / wp).astype(np.float32),
        (np.sin(ang) * wgt[:, None] / wp).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _dft_tensors(wp: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """`_dft_mats(wp)` on `device`, copied there once."""
    return tuple(torch.from_numpy(m).to(device) for m in _dft_mats(wp))


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """x[b, y, n, c] edge-padded by `_PAD` on both sides of axis 2."""
    w = x.shape[2]
    idx = torch.clamp(torch.arange(-_PAD, w + _PAD, device=x.device), 0, w - 1)
    return x.index_select(2, idx)


def _phase(delta: torch.Tensor, wp: int) -> torch.Tensor:
    """The rotation angle of bin f for a shift by delta[b, y] -> [b, y, F]."""
    f = torch.arange(wp // 2 + 1, dtype=torch.float32, device=delta.device)
    return 2 * math.pi * f[None, None, :] * delta[:, :, None] / wp


def _shift_rows_dft(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x[b, y, n, c] -> x sampled at n + delta[b, y] along axis 2 (sinc
    interpolation, edge-padded against circular wrap). Matmul-DFT form."""
    w = x.shape[2]
    wp = w + 2 * _PAD
    cm, sm, icm, ism = _dft_tensors(wp, x.device)
    xp = _edge_pad(x)
    xc = torch.einsum("fm,bymc->byfc", cm, xp)
    xs = torch.einsum("fm,bymc->byfc", sm, xp)
    phi = _phase(delta, wp)
    cphi, sphi = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    yc = xc * cphi + xs * sphi
    ys = -xc * sphi + xs * cphi
    out = torch.einsum("fn,byfc->bync", icm, yc) + torch.einsum("fn,byfc->bync", ism, ys)
    return out[:, :, _PAD:_PAD + w, :]


def _shift_rows_fft(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The same bandlimited shift through the real FFT: with
    X_f = sum_m x_m e^{-2 pi i f m / wp}, sampling at m + delta multiplies
    bin f by e^{+2 pi i f delta / wp}, `_shift_rows_dft`'s cos/sin rotation
    at O(W log W) a row."""
    w = x.shape[2]
    wp = w + 2 * _PAD
    spec = torch.fft.rfft(_edge_pad(x), dim=2)                  # complex64 [b, y, f, c]
    phi = _phase(delta, wp)
    rot = torch.complex(torch.cos(phi), torch.sin(phi))[..., None]
    out = torch.fft.irfft(spec * rot, n=wp, dim=2)
    return out[:, :, _PAD:_PAD + w, :].to(torch.float32)


def _shift_rows_gather(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x[b, y, n, c] -> x sampled at n + delta[b, y] along axis 2, bilinear
    with the sample position clamped to the row (edge padding)."""
    w = x.shape[2]
    src = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :] + delta[:, :, None]
    src = torch.clamp(src, 0.0, float(w - 1))
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=w - 1)
    frac = (src - i0.to(torch.float32))[..., None]
    g0 = _gather_axis(x, i0[..., None], 2)
    g1 = _gather_axis(x, i1[..., None], 2)
    return g0 * (1.0 - frac) + g1 * frac


_SHIFT_FNS = {
    "gather": _shift_rows_gather,
    "fft": _shift_rows_fft,
    "dft": _shift_rows_dft,
}


def _affine_gather(images, s, zx, zy, f) -> torch.Tensor:
    """The whole affine as two separable bilinear gather passes; the JAX
    package's `_affine_gather` (augment.py:172)."""
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


@scoped(scopes.AUGMENT)
def apply_affine(images, s, zx, zy, f, backend: str = "gather") -> torch.Tensor:
    """Apply per-image affine params (shapes [b], from `draw_affine_params`)
    to a float batch [b, H, W, C] with the row-shift `backend`. Per-image
    math only, so a caller may fold clients into the batch."""
    if backend == "gather":
        return _affine_gather(images, s, zx, zy, f)
    b, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = images.device
    yv = torch.arange(h, dtype=torch.float32, device=dev)
    xv = torch.arange(w, dtype=torch.float32, device=dev)
    # 1) vertical zoom: src_y = (y-cy)/zy + cy, a one-hot bilinear matmul
    src_y = torch.clamp((yv[None, :] - cy) / zy[:, None] + cy, 0, h - 1)
    t1 = torch.bmm(_lin_weights(src_y, h), images.reshape(b, h, w * c)).reshape(b, h, w, c)
    # 2) shear: x-shift by delta(y) = tan(s)/zx * (y-cy), clamped back to
    # the image's own range (the sinc kernel overshoots at edges)
    delta = (torch.tan(s) / zx)[:, None] * (yv[None, :] - cy)
    lo = t1.amin(dim=(1, 2), keepdim=True)
    hi = t1.amax(dim=(1, 2), keepdim=True)
    t2 = torch.clamp(_SHIFT_FNS[backend](t1, delta), lo, hi)
    # 3) horizontal zoom + flip: src_x = f/zx*(x-cx) + cx
    src_x = torch.clamp((f / zx)[:, None] * (xv[None, :] - cx) + cx, 0, w - 1)
    return torch.einsum("bxu,byuc->byxc", _lin_weights(src_x, w), t2)


def _random_augment(gen, images, shear, zoom, flip, backend) -> torch.Tensor:
    with torch.profiler.record_function(scopes.AUGMENT):
        aff = draw_affine_params(gen, images.shape[0], shear, zoom, flip)
    return apply_affine(images, *(a.to(images.device) for a in aff), backend=backend)


def random_augment(
    gen: torch.Generator,
    images: torch.Tensor,
    shear: float = 0.2,
    zoom: float = 0.2,
    flip: bool = True,
    backend: str | None = None,
) -> torch.Tensor:
    """Batch [B, H, W, C] float images -> augmented batch, one random
    (shear, zoom, horizontal-flip) affine per image drawn from `gen`.
    `backend` pins the row-shift backend for this call (e.g.
    `TrainConfig.aug_backend`); None defers to HEFL_AUG_SHIFT / auto on the
    images' device."""
    bk = resolve_shift_backend(backend, images.device)
    return _random_augment(gen, images, shear, zoom, flip, bk)


def _autoselect_backend(device: torch.device) -> str:
    """One-shot choice on `device`: the winner persisted for its device
    name, else the full augment (draws and warp) of each backend timed at
    `_PROBE_SHAPE` and the fastest persisted; cached for the process per
    device name. A probe that fails raises: nothing settles on gather
    quietly."""
    global _AUTO_TIMINGS_MS, _AUTO_PERSISTED
    name = _device_name(device)
    if name in _AUTO_CHOICE:
        return _AUTO_CHOICE[name]
    hit = load_winner("augment_shift", name, allowed=SHIFT_BACKENDS)
    if hit is not None:
        _AUTO_CHOICE[name] = hit["winner"]
        _AUTO_TIMINGS_MS = hit.get("timings_ms")
        _AUTO_PERSISTED = True
        return hit["winner"]
    x = torch.from_numpy(np.random.default_rng(0).random(_PROBE_SHAPE, np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    timings = {
        bk: _time_backend(lambda bk=bk: _random_augment(gen, x, 0.2, 0.2, True, bk), device)
        for bk in SHIFT_BACKENDS
    }
    _AUTO_TIMINGS_MS = {k: round(v * 1e3, 3) for k, v in timings.items()}
    _AUTO_PERSISTED = False
    _AUTO_CHOICE[name] = min(timings, key=timings.get)
    store_winner("augment_shift", name, _AUTO_CHOICE[name], _AUTO_TIMINGS_MS)
    return _AUTO_CHOICE[name]


def resolve_shift_backend(override: str | None = None, device=None) -> str:
    """The backend an augment call runs on `device` (where "auto" times the
    three; the CPU by default).

    Priority: an explicit `override` (config / call site) > HEFL_AUG_SHIFT
    > "auto"."""
    global _LAST_RESOLVED
    backend = override or _ENV_BACKEND or "auto"
    if backend == "auto":
        backend = _autoselect_backend(torch.device(device or "cpu"))
    elif backend not in SHIFT_BACKENDS:
        raise ValueError(
            f"augment shift backend {backend!r}: expected one of "
            f"{SHIFT_BACKENDS + ('auto',)}"
        )
    _LAST_RESOLVED = backend
    return backend


def backend_report() -> dict:
    """What the augment layer runs, with the JAX record's keys: `backend`
    is the last resolved choice (per-call pins included; None before any
    resolution), `auto_timings_ms` the timings behind an auto choice and
    `auto_persisted` whether that choice came from the persisted file."""
    env = _ENV_BACKEND or "auto"
    return {
        "requested": env,
        "backend": _LAST_RESOLVED or (env if env in SHIFT_BACKENDS else None),
        "auto_timings_ms": _AUTO_TIMINGS_MS,
        "auto_persisted": _AUTO_PERSISTED,
    }
