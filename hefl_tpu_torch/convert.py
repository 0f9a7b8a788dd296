"""Layout conversion between the JAX package's parameter trees and the port's.

The JAX package keeps flax params: {"Conv_i": {"bias", "kernel" HWIO},
"Dense_j": {"bias", "kernel" (in, out)}}. The port keeps a flat dict of
PyTorch tensors named like `MedCNN.named_parameters()`: "Conv_i.weight"
(OIHW), "Conv_i.bias", "Dense_j.weight" (out, in), "Dense_j.bias".

`flax_leaf`/`torch_leaf` convert one tensor between the two layouts (used by
`ckks.packing` to pack in the JAX package's ravel order and layout);
`from_flax`/`to_flax` convert whole trees (numpy on the JAX side), and
`keys_from_jax` turns the JAX package's uint32 key arrays into the port's
int32 key tensors. The tests use these to make both packages compute on the
same weights and keys.
"""

from __future__ import annotations

import numpy as np
import torch

from hefl_tpu_torch.ckks.keys import PublicKey, SecretKey

_LEAVES = ("bias", "kernel")          # flax leaf names in sorted (ravel) order


def flax_leaf(layer: str, leaf: str, t: torch.Tensor) -> torch.Tensor:
    """Port tensor -> the JAX package's layout (a view where possible)."""
    if leaf == "bias":
        return t
    if layer.startswith("Conv"):
        return t.permute(2, 3, 1, 0)      # OIHW -> HWIO
    return t.t()                          # (out, in) -> (in, out)


def torch_leaf(layer: str, leaf: str, t):
    """JAX-layout array or tensor -> the port's layout."""
    if leaf == "bias":
        return t
    if layer.startswith("Conv"):
        return t.permute(3, 2, 0, 1) if isinstance(t, torch.Tensor) else np.transpose(t, (3, 2, 0, 1))
    return t.t() if isinstance(t, torch.Tensor) else np.transpose(t)


def torch_name(layer: str, leaf: str) -> str:
    return f"{layer}.{'bias' if leaf == 'bias' else 'weight'}"


def ravel_order(params: dict) -> list[tuple[str, str]]:
    """(layer, leaf) pairs in `jax.flatten_util.ravel_pytree` order: layers
    sorted by name, then "bias" before "kernel"."""
    layers = sorted({name.split(".")[0] for name in params})
    return [(layer, leaf) for layer in layers for leaf in _LEAVES]


def from_flax(params, device="cpu") -> dict[str, torch.Tensor]:
    """flax params (nested dict of arrays) -> the port's parameter dict."""
    out = {}
    for layer, leaves in params.items():
        for leaf, arr in leaves.items():
            a = np.array(torch_leaf(layer, leaf, np.asarray(arr, dtype=np.float32)))
            out[torch_name(layer, leaf)] = torch.from_numpy(a).to(device)
    return out


def to_flax(params: dict[str, torch.Tensor]) -> dict[str, dict[str, np.ndarray]]:
    """The port's parameter dict -> flax-layout nested dict of numpy arrays."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for layer, leaf in ravel_order(params):
        t = flax_leaf(layer, leaf, params[torch_name(layer, leaf)].detach())
        out.setdefault(layer, {})[leaf] = t.cpu().contiguous().numpy()
    return out


def keys_from_jax(sk, pk, device="cpu") -> tuple[SecretKey, PublicKey]:
    """The JAX package's SecretKey/PublicKey (uint32 arrays) -> int32 tensors."""
    conv = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=np.uint32).view(np.int32)
    ).to(device)
    return SecretKey(s_mont=conv(sk.s_mont)), PublicKey(
        b_mont=conv(pk.b_mont), a_mont=conv(pk.a_mont)
    )
