"""Runtime utilities of the port: phase timing, checkpoint/resume, and the
key/ciphertext wire files (`utils.serialization`)."""

from hefl_tpu_torch.utils.checkpoint import (
    CheckpointError,
    load_checkpoint,
    load_params,
    save_checkpoint,
    save_params,
)
from hefl_tpu_torch.utils.timers import PhaseTimer

__all__ = [
    "PhaseTimer",
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "save_params",
    "load_params",
]
