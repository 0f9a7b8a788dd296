"""Model zoo of the port: the reference CNNs and ResNet-20 as PyTorch modules."""

from __future__ import annotations

import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.models.cnn import LogReg, MedCNN, SmallCNN, count_params
from hefl_tpu_torch.models.resnet import ResNet20

# name -> (module class, default num_classes, default input shape NHWC-less)
MODEL_REGISTRY: dict[str, tuple[type, int, tuple[int, int, int]]] = {
    "medcnn": (MedCNN, 2, (256, 256, 3)),
    "smallcnn": (SmallCNN, 10, (28, 28, 1)),
    "logreg": (LogReg, 10, (28, 28, 1)),
    "resnet20": (ResNet20, 10, (32, 32, 3)),
}


def create_model(
    name: str = "medcnn",
    num_classes: int | None = None,
    input_shape: tuple[int, int, int] | None = None,
    gen: torch.Generator | None = None,
    device=None,
):
    """Build a freshly initialized model on `device` (CUDA unless given).
    `gen` seeds the initialization (a CPU generator; default seed 0)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    device = resolve_device(device)
    cls, default_classes, default_shape = MODEL_REGISTRY[name]
    model = cls(
        num_classes=num_classes if num_classes is not None else default_classes,
        input_shape=input_shape if input_shape is not None else default_shape,
    )
    model.reset_parameters(gen if gen is not None else torch.Generator().manual_seed(0))
    return model.to(device)


__all__ = ["LogReg", "MedCNN", "ResNet20", "SmallCNN", "create_model", "count_params",
           "MODEL_REGISTRY"]
