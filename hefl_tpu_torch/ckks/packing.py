"""Pack a model's parameters into CKKS plaintext coefficient blocks.

Counterpart of `hefl_tpu.ckks.packing` (`PackSpec`, `pack_pytree`,
`unpack_blocks`). The parameters are raveled into one flat float32 vector
in the JAX package's `jax.flatten_util.ravel_pytree` order and layout —
layers sorted by name (`Conv_0` ... `Dense_2`), `bias` before `kernel`,
conv kernels in HWIO and dense kernels as (in, out) — zero-padded to a
multiple of N and reshaped to [n_ct, N]. So ciphertext row k carries the same
weights in both packages: MedCNN's 222,722 parameters fill 55 rows at N=4096.
"""

from __future__ import annotations

import dataclasses

import torch

from hefl_tpu_torch.convert import flax_leaf, ravel_order, torch_leaf, torch_name


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static packing geometry for one model template and ring degree."""

    n: int                                   # ring degree (coeffs per ct)
    total: int                               # true parameter count
    n_ct: int                                # ciphertexts per model
    entries: tuple                           # ((layer, leaf, jax_shape), ...) in ravel order

    @classmethod
    def for_params(cls, params: dict[str, torch.Tensor], n: int) -> "PackSpec":
        entries = tuple(
            (layer, leaf, tuple(flax_leaf(layer, leaf, params[torch_name(layer, leaf)]).shape))
            for layer, leaf in ravel_order(params)
        )
        total = sum(int(torch.Size(shape).numel()) for _, _, shape in entries)
        return cls(n=n, total=total, n_ct=-(-total // n), entries=entries)


def pack_params(params: dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """Parameter dict -> coefficient blocks float32[n_ct, n], zero-padded."""
    flat = torch.cat([
        flax_leaf(layer, leaf, params[torch_name(layer, leaf)]).reshape(-1)
        for layer, leaf in ravel_order(params)
    ]).to(torch.float32)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, n)


def unpack_blocks(blocks: torch.Tensor, spec: PackSpec) -> dict[str, torch.Tensor]:
    """float[n_ct, n] -> parameter dict in the port's layout (drops padding)."""
    flat = blocks.reshape(-1)[: spec.total]
    out, off = {}, 0
    for layer, leaf, shape in spec.entries:
        size = int(torch.Size(shape).numel())
        t = flat[off: off + size].reshape(shape)
        out[torch_name(layer, leaf)] = torch_leaf(layer, leaf, t).contiguous()
        off += size
    return out
