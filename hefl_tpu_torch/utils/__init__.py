"""Runtime utilities of the port: phase timing, checkpoint/resume, the
key/ciphertext wire files (`utils.serialization`) and the roofline
accounting and kernel timers (`utils.roofline`)."""

from hefl_tpu_torch.utils.checkpoint import (
    CheckpointError,
    load_checkpoint,
    load_params,
    load_pytree,
    save_checkpoint,
    save_params,
    save_pytree,
)
from hefl_tpu_torch.utils.serialization import (
    load_ciphertext,
    load_galois_key,
    load_public_material,
    load_relin_key,
    load_secret_key,
    save_ciphertext,
    save_galois_key,
    save_public_material,
    save_relin_key,
    save_secret_key,
)
from hefl_tpu_torch.utils.timers import PhaseTimer

__all__ = [
    "PhaseTimer",
    "save_public_material",
    "load_public_material",
    "save_secret_key",
    "load_secret_key",
    "save_ciphertext",
    "load_ciphertext",
    "save_relin_key",
    "load_relin_key",
    "save_galois_key",
    "load_galois_key",
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "save_params",
    "load_params",
    "save_pytree",
    "load_pytree",
]
