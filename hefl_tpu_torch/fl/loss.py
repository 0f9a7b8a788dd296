"""Categorical cross-entropy and accuracy over logits (mean over the batch),
as the JAX package's `fl.loss` (optax softmax cross-entropy)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return torch.mean(-torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))


def accuracy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits.argmax(-1) == onehot.argmax(-1)).to(torch.float32))
