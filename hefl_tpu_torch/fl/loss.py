"""Categorical cross-entropy and accuracy over logits (mean over the batch),
as the JAX package's `fl.loss` (optax softmax cross-entropy), and the
optional FedProx proximal term mu/2 * ||w - w_global||^2 (Li et al. 2020)
that pulls local training toward the round's global weights.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


def cross_entropy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return torch.mean(-torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))


def accuracy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits.argmax(-1) == onehot.argmax(-1)).to(torch.float32))


def prox_term(params: dict, global_params: dict, mu: float) -> torch.Tensor:
    """mu/2 * sum over tensors of ||p - g||^2; exactly 0 at mu = 0."""
    if mu == 0.0:
        return torch.tensor(0.0, dtype=torch.float32)
    sq = [torch.sum((params[k] - global_params[k]) ** 2) for k in params]
    return 0.5 * mu * torch.stack(sq).sum()


def loss_fn(model, params: dict, x, onehot, global_params=None, prox_mu: float = 0.0):
    """-> (loss, (ce, acc)). `x` is float [B, H, W, C] in [0, 1]."""
    logits = functional_call(model, params, (x,))
    ce = cross_entropy(logits, onehot)
    loss = ce
    if prox_mu > 0.0 and global_params is not None:
        loss = loss + prox_term(params, global_params, prox_mu)
    return loss, (ce, accuracy(logits, onehot))
