"""The five BASELINE.json benchmark configurations as named presets, and the
CPU-sized fusion and hybrid-HE smoke presets, over the port's configs
(`hefl_tpu.presets`, restated: the JAX module builds the JAX package's
`ExperimentConfig`).

  1. mnist-plain     2-client plaintext FedAvg, 2-conv CNN, MNIST
  2. mnist-enc       2-client CKKS-encrypted FedAvg, MNIST
  3. medical-8       8-client encrypted FedAvg, medical images, IID split
  4. medical-skew    8-client non-IID (label-skew) encrypted FedAvg + FedProx
  5. cifar-resnet16  16-client encrypted FedAvg, ResNet-20, CIFAR-10

Every preset keeps the reference's local-training recipe (10 epochs, batch
32, Adam 1e-3 with Keras decay, EarlyStopping/ReduceLROnPlateau) and runs 3
rounds. Every preset of the JAX package is here (`UNPORTED_PRESETS` is
empty); an unknown name raises a KeyError listing them. `hhe-smoke` and
`chaos-smoke` use a ring of N = 256, which the kernels take like any other.
"""

from __future__ import annotations

from hefl_tpu_torch.experiment import ExperimentConfig, HEConfig
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.faults import FaultConfig

# The five reference-derived benchmark configurations (BASELINE.json).
BASELINE_PRESET_NAMES = (
    "mnist-plain", "mnist-enc", "medical-8", "medical-skew", "cifar-resnet16",
)

# Presets of the JAX package that need a module the port does not have yet
# (none since the robust rounds were ported).
UNPORTED_PRESETS: dict[str, str] = {}


class _Presets(dict):
    def __missing__(self, name):
        if name in UNPORTED_PRESETS:
            raise KeyError(f"preset {name!r} needs {UNPORTED_PRESETS[name]}, which "
                           "hefl_tpu_torch does not have yet")
        raise KeyError(f"unknown preset {name!r}; available: {sorted(self)}")


_MNIST_TRAIN = TrainConfig(num_classes=10, warmup_steps=0)
# Warmup ~= 2 epochs of steps: 8 clients x 200 images -> 180 train, bs 32
# -> 5 steps/epoch, so 10 warmup steps.
_MED_TRAIN = TrainConfig(num_classes=2, warmup_steps=10)

PRESETS: dict[str, ExperimentConfig] = _Presets({
    "mnist-plain": ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=2, rounds=3,
        encrypted=False, train=_MNIST_TRAIN, seed=0,
    ),
    "mnist-enc": ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=2, rounds=3,
        encrypted=True, train=_MNIST_TRAIN, he=HEConfig(), seed=0,
    ),
    "medical-8": ExperimentConfig(
        model="medcnn", dataset="medical", num_clients=8, rounds=3,
        encrypted=True, train=_MED_TRAIN, he=HEConfig(), seed=0,
    ),
    "medical-skew": ExperimentConfig(
        model="medcnn", dataset="medical", num_clients=8, rounds=3,
        encrypted=True, partition="label_skew", skew_alpha=0.5,
        train=TrainConfig(num_classes=2, warmup_steps=10, prox_mu=0.01),
        he=HEConfig(), seed=0,
    ),
    "cifar-resnet16": ExperimentConfig(
        model="resnet20", dataset="cifar10", num_clients=16, rounds=3,
        encrypted=True, train=TrainConfig(num_classes=10), he=HEConfig(),
        seed=0,
    ),
    # Robustness smoke (CPU-sized): an encrypted run under a fault schedule —
    # 25% scheduled dropout and one NaN-poisoned client every round, one
    # simulated device loss at round 2 — that must exclude exactly the
    # scheduled and poisoned clients (CHAOS_SMOKE.json's rounds).
    "chaos-smoke": ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=8, rounds=4,
        encrypted=True, he=HEConfig(n=256), seed=0,
        n_train=512, n_test=128,
        train=TrainConfig(
            num_classes=10, epochs=1, batch_size=8, augment=False,
            val_fraction=0.25, on_overflow="exclude",
        ),
        faults=FaultConfig(seed=0, drop_fraction=0.25, nan_clients=1, fail_rounds=(2,)),
        max_round_retries=1, retry_backoff_s=0.1,
    ),
    # Cross-client fusion smoke (CPU-sized): a plaintext 8-client run with
    # the fused backend pinned.
    "fusion-smoke": ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=8, rounds=2,
        encrypted=False, seed=0, n_train=512, n_test=128,
        train=TrainConfig(
            num_classes=10, epochs=2, batch_size=8, val_fraction=0.25,
            client_fusion="fused",
        ),
    ),
    # Hybrid-HE uplink smoke (CPU-sized): a streaming run with
    # upload_kind=hhe, clients shipping stream-cipher word pairs and the
    # server transciphering into CKKS before the fold.
    "hhe-smoke": ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=8, rounds=2,
        encrypted=True, he=HEConfig(n=256), seed=0,
        n_train=512, n_test=128,
        train=TrainConfig(
            num_classes=10, epochs=1, batch_size=8, augment=False,
            val_fraction=0.25,
        ),
        packing=PackingConfig(bits=8, clip=0.5),
        stream=StreamConfig(quorum=1.0, upload_kind="hhe"),
        hhe=HheConfig(key_seed=0),
    ),
})
