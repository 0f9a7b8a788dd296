"""The benchmark's inputs, made on the device from `--seed`.

Everything here is handed alike to the system under test and to the plain
reference: the clients' images and labels, the test set, the initial
global weights and every round's shuffles and affine draws. Each comes
from its own `torch.Generator` on the device, seeded from (seed, stream
name, index) through numpy's SeedSequence, so the same seed gives the same
inputs bit for bit and no stream depends on another's length.

The images are a torch rewrite of the class-signal generator the system's
tests use (`data/synthetic.py`), frozen here: a class-oriented sinusoidal
texture under a radial envelope, a fixed per-class template of three
Gaussian blobs, a blurred low-frequency background and pixel noise, per
channel at a slight gain. Learnable, not trivially so. Parameters come
from the configuration's `data` group.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_STREAMS = {"train": 1, "test": 2, "weights": 3, "round": 4, "keys": 5, "template": 6}


def seed_word(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of one run."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), _STREAMS[stream], int(index)])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, index: int = 0, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_word(seed, stream, index))


def _uniform(g, shape, lo, hi):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _templates(data: dict, h: int, w: int, k: int, device) -> torch.Tensor:
    """[k, h, w]: three signed Gaussian blobs a class, fixed by the class
    index alone (train and test share them)."""
    yy = (torch.arange(h, device=device, dtype=torch.float32) / h - 0.5)[:, None]
    xx = (torch.arange(w, device=device, dtype=torch.float32) / w - 0.5)[None, :]
    out = []
    for c in range(k):
        g = generator(0, "template", c, device)
        cyx = _uniform(g, (3, 2), -0.3, 0.3)
        s = _uniform(g, (3,), 0.02, 0.08)
        sign = torch.where(torch.rand(3, generator=g, device=device) < 0.5, -1.0, 1.0)
        t = sum(sign[i] * torch.exp(-((yy - cyx[i, 0]) ** 2 + (xx - cyx[i, 1]) ** 2) / s[i])
                for i in range(3))
        out.append(t / (t.abs().max() + 1e-9))
    return torch.stack(out)


def _blur5(a: torch.Tensor) -> torch.Tensor:
    """5x5 box blur with edge padding, a: [n, h, w]."""
    a = F.pad(a[:, None], (2, 2, 2, 2), mode="replicate")
    return F.avg_pool2d(a, 5, stride=1)[:, 0]


def images(data: dict, shape, num_classes: int, n: int, seed: int, stream: str,
           device, chunk: int = 512, index: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (uint8 [n, H, W, C], int64 [n]) on `device` from stream
    (`stream`, `index`), classes balanced and in random order."""
    h, w, ch = shape
    g = generator(seed, stream, index, device)
    labels = (torch.arange(n, device=device) % num_classes)[
        torch.argsort(torch.rand(n, generator=g, device=device))]
    tmpl = _templates(data, h, w, num_classes, device)
    yy = (torch.arange(h, device=device, dtype=torch.float32) / h - 0.5)[None, :, None]
    xx = (torch.arange(w, device=device, dtype=torch.float32) / w - 0.5)[None, None, :]
    env = torch.exp(-(xx ** 2 + yy ** 2) / 0.18)
    out = torch.empty((n, h, w, ch), dtype=torch.uint8, device=device)
    for lo in range(0, n, chunk):
        lab = labels[lo: lo + chunk]
        k = int(lab.shape[0])
        labf = lab.to(torch.float32)
        theta = labf * (math.pi / num_classes) + torch.randn(
            k, generator=g, device=device) * data["orient_jitter"]
        freq = 4.0 + 3.0 * (lab % 3).to(torch.float32)
        phase = _uniform(g, (k,), 0.0, 2 * math.pi)
        amp = _uniform(g, (k,), data["amp_floor"], 1.0)
        proj = torch.cos(theta)[:, None, None] * xx + torch.sin(theta)[:, None, None] * yy
        sig = amp[:, None, None] * torch.sin(2 * math.pi * freq[:, None, None] * proj
                                             + phase[:, None, None]) * env
        t_amp = _uniform(g, (k,), data["amp_floor"], 1.0)[:, None, None]
        sh, sw = max(h // 8, 2), max(w // 8, 2)
        small = torch.randn((k, sh, sw), generator=g, device=device)
        up = small.repeat_interleave(-(-h // sh), 1)[:, :h].repeat_interleave(-(-w // sw), 2)[:, :, :w]
        bg = _blur5(up)
        noise = torch.randn((k, h, w), generator=g, device=device) * data["noise_sigma"]
        base = (data["sig_amp"] * sig + data["tmpl_amp"] * t_amp * tmpl[lab]
                + data["bg_amp"] * bg + noise)
        for c in range(ch):
            out[lo: lo + k, ..., c] = torch.clamp(
                (base * (1.0 - 0.12 * c) * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)
    return out, labels


def federated(cfg: dict, traffic: dict, seed: int, device, clients=None):
    """-> (xs uint8 [c, m, H, W, ch], ys int64 [c, m], xt uint8 [n, H, W,
    ch], yt int64 [n]): IID clients, each client's images class-balanced
    from a stream of its own, so a rank of a client mesh makes only its
    rows (`clients`, default all); and the test set."""
    m = traffic["images_per_client"]
    shape, k = tuple(cfg["input_shape"]), cfg["num_classes"]
    rows = range(traffic["clients"]) if clients is None else clients
    parts = [images(cfg["data"], shape, k, m, seed, "train", device, index=c) for c in rows]
    xt, yt = images(cfg["data"], shape, k, traffic["test_images"], seed, "test", device)
    return (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]), xt, yt)


def initial_weights(spec, seed: int, device) -> dict:
    """LeCun-normal kernels (a normal truncated to two standard deviations,
    rescaled to the fan-in's variance: flax's `lecun_normal`), zero biases,
    unit GroupNorm scales; one draw for every kernel. spec: `param_spec`."""
    g = generator(seed, "weights", 0, device)
    n_rand = sum(math.prod(s) for _, s, init, _ in spec if init == "lecun")
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(n_rand, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo
    z = (torch.erfinv(2 * u - 1) * math.sqrt(2)).to(torch.float32)
    out, off = {}, 0
    trunc_std = 0.87962566103423978      # the std of a unit normal truncated to [-2, 2]
    for name, shape, init, fan_in in spec:
        if init == "lecun":
            n = math.prod(shape)
            out[name] = (z[off: off + n] * (math.sqrt(1.0 / fan_in) / trunc_std)).reshape(shape)
            off += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def round_streams(recipe: dict, traffic: dict, seed: int, rnd: int, device):
    """Round `rnd`'s shuffles and affine draws for every client:
    (perms int64 [C, T, batch], (s, zx, zy, f) float32 [C, T, batch]),
    T = epochs x steps; each epoch a fresh permutation of a client's
    training images, cut to whole batches."""
    c, m = traffic["clients"], traffic["images_per_client"]
    n_val = max(int(m * recipe["val_fraction"]), 1)
    n_tr = m - n_val
    bs = min(recipe["batch_size"], n_tr)
    steps = max(n_tr // bs, 1)
    e = recipe["epochs"]
    g = generator(seed, "round", rnd, device)
    perms = torch.argsort(torch.rand((c, e, n_tr), generator=g, device=device), dim=-1)
    perms = perms[:, :, : steps * bs].reshape(c, e * steps, bs)
    a = recipe["augment"]
    u = torch.rand((4, c, e * steps, bs), generator=g, device=device)
    s = (u[0] * 2 - 1) * a["shear"]
    zx = 1 + (u[1] * 2 - 1) * a["zoom"]
    zy = 1 + (u[2] * 2 - 1) * a["zoom"]
    f = torch.where(u[3] < 0.5, -1.0, 1.0) if a["flip"] else torch.ones_like(u[3])
    return perms, (s, zx, zy, f)
