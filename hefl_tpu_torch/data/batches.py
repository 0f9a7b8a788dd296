"""Index-plan batching: the counterpart of `hefl_tpu.data.batches`.

The reference streams batches through Keras generator objects; here the
whole (small) dataset lives on the device and an epoch is a gather by a
[steps, batch] index plan drawn per epoch from a `torch.Generator`,
reshuffled every epoch like Keras `shuffle=True`, with the tail partial
batch dropped so every step has the same shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Categorical float32 targets (the reference's class_mode='categorical');
    a label outside [0, num_classes) gives a zero row, as `jax.nn.one_hot`."""
    labels = torch.as_tensor(labels)
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Batcher:
    """Epoch index-plan factory over n samples with a fixed batch size."""

    n: int
    batch_size: int

    @property
    def steps_per_epoch(self) -> int:
        return max(self.n // self.batch_size, 1)

    def epoch_indices(self, gen: torch.Generator) -> torch.Tensor:
        """-> int64[steps, min(batch, n)]: a prefix of one permutation drawn
        from `gen`, on the generator's device."""
        perm = torch.randperm(self.n, generator=gen, device=gen.device)
        usable = self.steps_per_epoch * min(self.batch_size, self.n)
        return perm[:usable].reshape(self.steps_per_epoch, -1)

    def epoch_indices_eval(self) -> np.ndarray:
        """The deterministic, unshuffled plan (test/val: shuffle=False in the
        reference's `get_test_data`)."""
        usable = self.steps_per_epoch * min(self.batch_size, self.n)
        return np.arange(usable).reshape(self.steps_per_epoch, -1)
