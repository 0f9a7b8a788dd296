"""Training hyperparameters of the encrypted synchronous round.

The fields of the JAX package's `TrainConfig` (hefl_tpu/fl/config.py) that
this path uses, with the same defaults, which reproduce the reference:
Adam(lr=1e-3, decay=1e-4), 10 local epochs, batch 32,
EarlyStopping(patience=5, restore_best_weights), ReduceLROnPlateau(
patience=2, factor=0.3, min_lr=1e-6), validation_split=0.1, and the
shear/zoom/flip augmentation.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 10
    batch_size: int = 32
    lr: float = 1e-3
    lr_decay: float = 1e-4          # Keras-style: lr_t = lr / (1 + decay*step)
    warmup_steps: int = 0           # linear lr ramp (0 = reference behavior)
    val_fraction: float = 0.1
    es_patience: int = 5            # early stopping on val loss
    plateau_patience: int = 2       # ReduceLROnPlateau on val loss
    plateau_factor: float = 0.3
    min_lr: float = 1e-6
    min_delta: float = 0.0
    augment: bool = True
    aug_shear: float = 0.2
    aug_zoom: float = 0.2
    aug_flip: bool = True
    num_classes: int = 2
