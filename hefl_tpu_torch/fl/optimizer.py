"""Adam with Keras-style time decay over a parameter dict.

Counterpart of `hefl_tpu.fl.optimizer`: lr_t = lr / (1 + decay*t) * lr_scale
with t = step + 1, bias-corrected moments, eps = 1e-7 (Keras), and the
ReduceLROnPlateau multiplier `lr_scale` as a runtime operand. The scalar
schedule is computed in float32 on the host, as the JAX package computes it
in float32 on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: dict
    nu: dict
    step: int


def adam_init(params: dict) -> AdamState:
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
    return AdamState(mu=zeros(), nu=zeros(), step=0)


def adam_update(
    grads: dict,
    state: AdamState,
    params: dict,
    lr: float,
    decay: float,
    lr_scale,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
    warmup_steps: int = 0,
    inplace: bool = False,
) -> tuple[dict, AdamState]:
    """-> (new_params, new_state). `lr_scale` is a scalar, or float32[C] for
    parameters stacked over C clients (the fused trainer), each client's
    scale broadcast along the leading axis. With `inplace`, each update's
    last operation writes into the tensors of `params` and `state` (the same
    operations, so the same bits), which the result then holds; otherwise
    nothing is updated in place."""
    step = state.step + 1
    f32 = np.float32
    t = f32(step)
    lr_t = f32(lr) / (f32(1.0) + f32(decay) * t) * np.asarray(lr_scale, dtype=f32)
    if warmup_steps > 0:
        lr_t = lr_t * min(f32(1.0), t / f32(warmup_steps))
    bc1 = f32(1.0) - f32(b1) ** t
    bc2 = f32(1.0) - f32(b2) ** t
    mu, nu, new = {}, {}, {}

    def out(dst: torch.Tensor) -> dict:
        return {"out": dst} if inplace else {}

    for k, p in params.items():
        g = grads[k]
        mu[k] = torch.add(b1 * state.mu[k], (1 - b1) * g, **out(state.mu[k]))
        nu[k] = torch.add(b2 * state.nu[k], (1 - b2) * g * g, **out(state.nu[k]))
        lr_k = (float(lr_t) if lr_t.ndim == 0 else
                torch.from_numpy(lr_t).to(p.device).reshape((-1,) + (1,) * (p.dim() - 1)))
        new[k] = torch.sub(p, lr_k * (mu[k] / float(bc1)) / (torch.sqrt(nu[k] / float(bc2)) + eps),
                           **out(p))
    return new, AdamState(mu=mu, nu=nu, step=step)
