"""Configuration of the encrypted round: training, streaming, packing, HHE.

The fields of the JAX package's `TrainConfig` (hefl_tpu/fl/config.py) that
this path uses, with the same defaults, which reproduce the reference:
Adam(lr=1e-3, decay=1e-4), 10 local epochs, batch 32,
EarlyStopping(patience=5, restore_best_weights), ReduceLROnPlateau(
patience=2, factor=0.3, min_lr=1e-6), validation_split=0.1, and the
shear/zoom/flip augmentation; `prox_mu > 0` adds the FedProx term; `client_fusion`
picks the training backend (`fl.fusion`); `on_overflow="exclude"` and
`max_update_norm > 0` route a round through the masked engine
(`fl.faults.exclusion_bits`). `StreamConfig` is the JAX package's; the
packing and hybrid-HE configs live beside what they configure and are
re-exported here, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

from hefl_tpu_torch.ckks.quantize import PackingConfig  # noqa: F401  (re-export)
from hefl_tpu_torch.hhe.cipher import HheConfig  # noqa: F401  (re-export)


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
    prox_mu: float = 0.0            # FedProx; 0 = plain FedAvg
    augment: bool = True
    aug_shear: float = 0.2
    aug_zoom: float = 0.2
    aug_flip: bool = True
    num_classes: int = 2
    client_fusion: str = "auto"     # "fused" | "vmap" | "auto" (fl.fusion)
    # Encode saturation (encode_overflow > 0): "warn" aggregates and logs,
    # "raise" aborts the run, "exclude" drops the client from the round.
    on_overflow: str = "warn"
    max_update_norm: float = 0.0    # L2 bound on a client's update (0 = none)

    def __post_init__(self):
        if self.on_overflow not in ("warn", "exclude", "raise"):
            raise ValueError(
                f"on_overflow={self.on_overflow!r}: must be one of "
                "'warn' | 'exclude' | 'raise'"
            )
        if self.client_fusion not in ("auto", "fused", "vmap"):
            raise ValueError(
                f"client_fusion={self.client_fusion!r}: must be one of "
                "'auto' | 'fused' | 'vmap'"
            )


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming quorum-aggregation knobs, the fields, defaults and
    validation messages of the JAX package's `StreamConfig`
    (hefl_tpu/fl/config.py). The port's engine (`fl.stream.StreamEngine`)
    runs every knob — cohort sampling, cohort-only training, quorum,
    deadlines, retries with backoff and jitter, bounded staleness,
    real-time pacing, and the hierarchical fold (`num_hosts >= 2`: the
    host quorum, the ship deadline and the tier staleness budget of
    `fl.hierarchy`).

    upload_kind: "ckks" (a float or packed CKKS ciphertext) or "hhe" (a
    stream-cipher encryption of the PACKED quantized update, transciphered
    into CKKS by the server; requires a PackingConfig).
    """

    cohort_size: int = 0
    cohort_only: bool = True
    quorum: float = 1.0
    deadline_s: float = 0.0
    max_retries: int = 0
    retry_backoff_s: float = 0.25
    retry_jitter: float = 0.25
    staleness_rounds: int = 0
    seed: int = 0
    time_scale: float = 0.0
    num_hosts: int = 0
    host_quorum: float = 1.0
    ship_deadline_s: float = 0.0
    host_staleness_rounds: int = 0
    upload_kind: str = "ckks"

    def __post_init__(self):
        if self.upload_kind not in ("ckks", "hhe"):
            raise ValueError(
                f"StreamConfig.upload_kind={self.upload_kind!r}: must be "
                "'ckks' or 'hhe'"
            )
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(
                f"StreamConfig.quorum={self.quorum}: must be in (0, 1]"
            )
        for name in ("cohort_size", "deadline_s", "max_retries", "retry_backoff_s",
                     "staleness_rounds", "time_scale", "num_hosts", "ship_deadline_s",
                     "host_staleness_rounds"):
            if getattr(self, name) < 0:
                raise ValueError(f"StreamConfig.{name} must be >= 0")
        if self.num_hosts == 1:
            raise ValueError(
                "StreamConfig.num_hosts=1: one host IS the flat fold — "
                "use 0 (flat) or >= 2 (hierarchical)"
            )
        if not 0.0 < self.host_quorum <= 1.0:
            raise ValueError(
                f"StreamConfig.host_quorum={self.host_quorum}: must be in "
                "(0, 1] (a fraction of the round's shipping hosts)"
            )
        if self.num_hosts < 2 and (
            self.host_quorum != 1.0
            or self.ship_deadline_s > 0
            or self.host_staleness_rounds > 0
        ):
            raise ValueError(
                "StreamConfig.host_quorum/ship_deadline_s/"
                "host_staleness_rounds describe the tier->root uplink of "
                "the hierarchical fold tree and would be silent no-ops on "
                "the flat engine — set num_hosts >= 2 to define the tiers"
            )
        if not 0.0 <= self.retry_jitter <= 1.0:
            raise ValueError(
                f"StreamConfig.retry_jitter={self.retry_jitter}: must be "
                "in [0, 1] (a fraction of the backoff)"
            )
