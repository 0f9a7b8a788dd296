"""Layout conversion between the JAX package's parameter trees and the port's.

The JAX package keeps flax params: {"Conv_i": {"bias", "kernel" HWIO},
"Dense_j": {"bias", "kernel" (in, out)}}. The port keeps a flat dict of
PyTorch tensors named like `MedCNN.named_parameters()`: "Conv_i.weight"
(OIHW), "Conv_i.bias", "Dense_j.weight" (out, in), "Dense_j.bias".

`flax_leaf`/`torch_leaf` convert one tensor between the two layouts (used by
`ckks.packing` to pack in the JAX package's ravel order and layout);
`from_flax`/`to_flax` convert whole trees (numpy on the JAX side), and
`keys_from_jax`, `relin_key_from_jax`, `galois_keys_from_jax` and
`ciphertext_from_jax` turn the JAX package's uint32 arrays (keys,
ciphertexts) into the port's int32 tensors with the same bits. The tests use
these to make both packages compute on the same weights, keys and
ciphertexts.
"""

from __future__ import annotations

import numpy as np
import torch

from hefl_tpu_torch.ckks.keys import GaloisKey, PublicKey, RelinKey, SecretKey

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


def _residues(a, device) -> torch.Tensor:
    """uint32 array -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32)).to(device)


def keys_from_jax(sk, pk, device="cpu") -> tuple[SecretKey, PublicKey]:
    """The JAX package's SecretKey/PublicKey (uint32 arrays) -> int32 tensors."""
    return SecretKey(s_mont=_residues(sk.s_mont, device)), PublicKey(
        b_mont=_residues(pk.b_mont, device), a_mont=_residues(pk.a_mont, device)
    )


def relin_key_from_jax(rlk, device="cpu") -> RelinKey:
    """The JAX package's RelinKey -> the port's."""
    return RelinKey(b_mont=_residues(rlk.b_mont, device), a_mont=_residues(rlk.a_mont, device))


def galois_keys_from_jax(gks: dict, device="cpu") -> dict:
    """{step: JAX GaloisKey} -> {step: the port's GaloisKey}."""
    return {
        s: GaloisKey(g=int(k.g), b_mont=_residues(k.b_mont, device),
                     a_mont=_residues(k.a_mont, device))
        for s, k in gks.items()
    }


def ciphertext_from_jax(ct, device="cpu"):
    """The JAX package's Ciphertext -> the port's (same scale)."""
    from hefl_tpu_torch.ckks.ops import Ciphertext

    return Ciphertext(c0=_residues(ct.c0, device), c1=_residues(ct.c1, device),
                      scale=float(ct.scale))
