"""PyTorch/CUDA port of `hefl_tpu`: encrypted FedAvg of CNNs and encrypted
inference serving on one NVIDIA GPU.

The package mirrors `hefl_tpu`'s module layout (ckks/, models/, data/, fl/,
cli.py) so each function has an obvious counterpart, but it is written in
PyTorch and imports nothing of JAX or of `hefl_tpu`. The TPU kernels of the
encrypted round (forward/inverse NTT, fused encrypt, fused decrypt) and of
encrypted-inference serving (fused key-switch, hoisted-rotation products,
`he_inference.py`) are hand-written CUDA C++ for Hopper in `csrc/ntt.cu`,
built with nvcc at first use and called through ctypes (`ckks/cuda_ntt.py`).

Residue tensors are `torch.int32` at every public function (canonical
residues are below 2**27, so int32 holds the same bits as the JAX package's
uint32); the plain PyTorch versions compute in int64.

Entry points run on CUDA unless the caller asks for another device, and raise
when no CUDA device is present and none was asked for (`resolve_device`).
Functions that take tensors run where their tensors live: a CUDA tensor goes
to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Never falls back to the CPU on its own: with no CUDA device and no
    explicit `device`, this raises.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hefl_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda")
