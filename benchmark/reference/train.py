"""Plain float32 encrypted-FedAvg round, without the encryption.

What one round computes, written from the recipe in the configuration file
(the reference repository's Keras training: Adam with time decay, 10
epochs of batch 32, the head tenth of a client's images for validation,
ReduceLROnPlateau, shear / zoom / flip augmentation), and FedAvg's plain
mean of the clients' trained weights, which the encrypted sum and the
owner's decrypt must reproduce. The shuffles and affine draws are inputs
(`benchmark.inputs.round_streams`), the same ones the system under test is
handed. `train_clients` returns every client's trained weights, so that
the check can also see which clients an average holds.

Clients train independently, so they run in blocks of `block` clients, each
client's step vectorised with `torch.func.vmap`; a block holds its
parameters and Adam moments as one flat [block, P] tensor.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from benchmark.reference.models import forward, param_spec


@contextlib.contextmanager
def float32_exact():
    """float32 matmuls and convolutions without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def geometry(recipe: dict, m: int) -> tuple[int, int, int]:
    """-> (n_val, batch, steps per epoch) of a client with m images."""
    n_val = max(int(m * recipe["val_fraction"]), 1)
    n_tr = m - n_val
    bs = min(recipe["batch_size"], n_tr)
    return n_val, bs, max(n_tr // bs, 1)


def augment(x: torch.Tensor, s, zx, zy, f) -> torch.Tensor:
    """The Keras shear / zoom / flip affine, bilinear with edge clamping:
    output pixel (y, x) samples the input at
    src_y = (y - cy) / zy + cy, src_x = f / zx (x - cx) + cx + tan(s) / zx (y - cy).
    x: float [B, H, W, C]; s, zx, zy, f: [B]."""
    b, h, w, _ = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yv = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xv = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    sy = ((yv - cy) / zy[:, None, None] + cy).expand(b, h, w)
    sx = (f / zx)[:, None, None] * (xv - cx) + cx + (torch.tan(s) / zx)[:, None, None] * (yv - cy)
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def _views(cfg: dict, flat: torch.Tensor) -> dict:
    """Leaves of flat parameters [..., P] as views [..., *shape]."""
    out, off = {}, 0
    lead = flat.shape[:-1]
    for name, shape, _, _ in param_spec(cfg):
        n = math.prod(shape)
        out[name] = flat[..., off: off + n].reshape(*lead, *shape)
        off += n
    return out


def flatten(cfg: dict, params: dict) -> torch.Tensor:
    """Parameter dict -> flat float32 [P] in `param_spec` order."""
    return torch.cat([params[name].reshape(-1).to(torch.float32)
                      for name, _, _, _ in param_spec(cfg)])


def _ce(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def train_clients(cfg: dict, recipe: dict, global_flat: torch.Tensor, xs: torch.Tensor,
                  ys: torch.Tensor, streams: tuple, quant=None, block: int = 32,
                  first_batch: int | None = None, adam_fault: str | None = None
                  ) -> tuple[torch.Tensor, np.ndarray, torch.Tensor]:
    """Every client's local training from the global weights (flat [P]):
    the client half of a round, whose plain mean is FedAvg's new model.

    xs uint8 [C, m, H, W, ch], ys int [C, m]; streams (perms int64 [C, T,
    batch], aug (s, zx, zy, f) each float32 [C, T, batch]). `first_batch`
    takes the first step's mean loss over only that many of its images (a
    planted fault); `adam_fault` plants one in Adam: "lr_x1.5" steps at
    1.5 times the learning rate, "no_bias_correction" drops the moments'
    bias correction. -> (each client's trained weights float32 [C, P],
    metrics float32 [C, epochs, 3]: val loss, val accuracy, lr scale, each
    client's first-step gradient float32 [C, P])."""
    num_c, m = int(xs.shape[0]), int(xs.shape[1])
    n_val, bs, steps = geometry(recipe, m)
    epochs, k = recipe["epochs"], cfg["num_classes"]
    perms, aug = streams
    dev = xs.device
    f32 = np.float32
    b1, b2, eps = 0.9, 0.999, 1e-7
    finals = torch.empty((num_c, int(global_flat.shape[0])), device=dev)
    first = torch.empty_like(finals)
    rows = np.zeros((num_c, epochs, 3), np.float32)

    def loss(p, x, oh):
        return _ce(forward(cfg, p, x, quant), oh)

    def val(p, x, oh):
        logits = forward(cfg, p, x, quant)
        return _ce(logits, oh), (logits.argmax(-1) == oh.argmax(-1)).to(torch.float32).mean()

    step_fn, val_fn = vmap(grad_and_value(loss)), vmap(val)
    for lo in range(0, num_c, block):
        hi = min(lo + block, num_c)
        cb = hi - lo
        p = global_flat[None].repeat(cb, 1)
        mu, nu = torch.zeros_like(p), torch.zeros_like(p)
        scale = np.ones(cb, f32)
        best = np.full(cb, np.inf, f32)
        wait = np.zeros(cb, np.int64)
        x_va = xs[lo:hi, :n_val].to(torch.float32) / 255.0
        oh_va = F.one_hot(ys[lo:hi, :n_val].to(torch.int64), k).to(torch.float32)
        x_tr, y_tr = xs[lo:hi, n_val:], ys[lo:hi, n_val:]
        rows_c = torch.arange(cb, device=dev)[:, None]
        for t in range(epochs * steps):
            idx = perms[lo:hi, t]
            xb = x_tr[rows_c, idx].to(torch.float32) / 255.0
            shp = xb.shape
            xb = augment(xb.reshape(-1, *shp[2:]),
                         *(a[lo:hi, t].reshape(-1) for a in aug)).reshape(shp)
            oh = F.one_hot(y_tr[rows_c, idx].to(torch.int64), k).to(torch.float32)
            if t == 0 and first_batch is not None:
                xb, oh = xb[:, :first_batch], oh[:, :first_batch]
            grads, _ = step_fn(_views(cfg, p), xb, oh)
            g = torch.cat([grads[name].reshape(cb, -1) for name, _, _, _ in param_spec(cfg)],
                          dim=1)
            if t == 0:
                first[lo:hi] = g
            tt = f32(t + 1)
            lr_t = (f32(recipe["lr"]) / (f32(1.0) + f32(recipe["lr_decay"]) * tt)) * scale
            bc1, bc2 = f32(1.0) - f32(b1) ** tt, f32(1.0) - f32(b2) ** tt
            if adam_fault == "lr_x1.5":
                lr_t = lr_t * f32(1.5)
            elif adam_fault == "no_bias_correction":
                bc1 = bc2 = f32(1.0)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            lr_d = torch.from_numpy(lr_t).to(dev)[:, None]
            p = p - lr_d * (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + eps)
            if t % steps != steps - 1:
                continue
            e = t // steps
            with torch.no_grad():
                vl, va = (v.cpu().numpy() for v in val_fn(_views(cfg, p), x_va, oh_va))
            for c in range(cb):
                if vl[c] < best[c] - f32(recipe["min_delta"]):
                    best[c], wait[c] = vl[c], 0
                else:
                    wait[c] += 1
                if wait[c] >= recipe["plateau_patience"]:
                    floor = f32(recipe["min_lr"] / recipe["lr"])
                    scale[c] = max(f32(scale[c] * f32(recipe["plateau_factor"])), floor)
                    wait[c] = 0
            rows[lo:hi, e] = np.stack([vl, va, scale], axis=1)
        finals[lo:hi] = p
    return finals, rows, first


def evaluate(cfg: dict, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             block: int = 256, quant=None) -> float:
    """Accuracy of the weights (flat [P]) on the test images (uint8 NHWC)."""
    p = _views(cfg, flat)
    hits = 0
    with torch.no_grad():
        for lo in range(0, int(x.shape[0]), block):
            logits = forward(cfg, p, x[lo: lo + block].to(torch.float32) / 255.0, quant)
            hits += int((logits.argmax(-1) == y[lo: lo + block].to(logits.device)).sum())
    return hits / int(x.shape[0])
