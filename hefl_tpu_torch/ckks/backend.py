"""HE backend selection: the CUDA kernels or their plain PyTorch versions.

Counterpart of `hefl_tpu.ckks.backend`, with the same pin (`HEFL_HE`, read
at call time), priority (an explicit override, then `HEFL_HE`, then
"auto") and report. Its backends are the port's: "cuda", the hand-written
kernels of `csrc/ntt.cu`, and "plain", their plain PyTorch versions.

"auto" resolves by the device and never probes, as the JAX module's
"auto" resolves to XLA off the TPU without timing anything: the plain
versions are the kernels' test twins, not a fast path (K3 at [110, 3,
4096] takes 0.031 ms on the H100 against 8.98 ms plain), and a CUDA tensor
never reaches one. So "cuda" is the only backend of a card and "plain" the
only one of the CPU: a pin that contradicts the device raises by name,
and nothing falls back quietly. Every ring the port builds (N = 256 to
16384) runs on the kernels, so the ring is no special case.

Both functions are pure: the resolution routes nothing itself (a wrapper
launches its kernel because its tensor lies on the card); it checks the
pin against the device and names what the run's HE phases run, for the
artifacts (`he_backend_report`).
"""

from __future__ import annotations

import os

import torch

HE_BACKENDS = ("plain", "cuda")


def _requested(override: str | None) -> str:
    return override or os.environ.get("HEFL_HE") or "auto"


def resolve_he_backend(ctx, device, override: str | None = None) -> str:
    """The backend the HE phases of a run on `device` run with.

    `ctx` is the run's CKKS context (None for a run without HE phases):
    every ring runs on the kernels, so only the device decides. Priority:
    `override` > HEFL_HE > "auto". Raises ValueError for an unknown name
    and for a pin the device cannot run ("plain" on a card, "cuda" on the
    CPU)."""
    requested = _requested(override)
    if requested not in HE_BACKENDS + ("auto",):
        raise ValueError(f"HE backend {requested!r}: expected one of {HE_BACKENDS + ('auto',)}")
    device = torch.device(device)
    native = "cuda" if device.type == "cuda" else "plain"
    if requested not in ("auto", native):
        raise ValueError(
            f"HE backend {requested!r} cannot run on a {device.type} device: its HE "
            f"phases run {native!r} ("
            + ("the plain versions are the kernels' CPU twins and never run on a card"
               if native == "cuda" else "the CUDA kernels need a card")
            + "); unset HEFL_HE or pin 'auto'")
    return native


def he_backend_report(device=None, override: str | None = None) -> dict:
    """What the HE layer of a run on `device` runs, with the JAX record's
    keys; `device` None is a run without HE phases (backend None, as the
    JAX record of a plaintext run). Raises as `resolve_he_backend` does.
    No probe runs, so there are no timings and nothing persisted."""
    return {
        "requested": _requested(override),
        "backend": None if device is None else resolve_he_backend(None, device, override),
        "auto_timings_ms": None,
        "auto_persisted": False,
    }
