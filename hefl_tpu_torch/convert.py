"""Layout conversion between the JAX package's parameter trees and the port's.

The JAX package keeps flax params, a nested dict of scopes down to the
leaves: {"Conv_i": {"bias", "kernel" HWIO}, "Dense_j": {"bias", "kernel"
(in, out)}, "GroupNorm_k": {"bias", "scale"}, "BasicBlock_b": {"Conv_0":
{...}, ...}}. The port keeps a flat dict of PyTorch tensors named like
`named_parameters()`: the scopes joined by ".", then "weight" (conv OIHW,
dense (out, in), GroupNorm scale) or "bias".

A leaf is addressed here as (layer, leaf): `layer` the scope path joined by
"/" ("BasicBlock_0/Conv_0"; the JAX package's checkpoint names use the same
path), `leaf` flax's name. The layout follows the last scope's name: `Conv*`
OIHW <-> HWIO, `Dense*` transposed, everything else (GroupNorm, biases) as
is. `ravel_order` is `jax.flatten_util.ravel_pytree`'s: dict keys sorted at
every level. `flax_leaf`/`torch_leaf` convert one tensor (used by
`ckks.packing` to pack in the JAX package's order and layout);
`from_flax`/`to_flax` whole trees (numpy on the JAX side). `keys_from_jax`,
`relin_key_from_jax`, `galois_keys_from_jax` and `ciphertext_from_jax` turn
the JAX package's uint32 arrays (keys, ciphertexts) into the port's int32
tensors with the same bits. The tests use these to make both packages
compute on the same weights, keys and ciphertexts.
"""

from __future__ import annotations

import numpy as np
import torch

from hefl_tpu_torch.ckks.keys import GaloisKey, PublicKey, RelinKey, SecretKey


def _scope(layer: str) -> str:
    return layer.rsplit("/", 1)[-1]


def flax_leaf(layer: str, leaf: str, t: torch.Tensor) -> torch.Tensor:
    """Port tensor -> the JAX package's layout (a view where possible)."""
    if leaf != "kernel":
        return t
    if _scope(layer).startswith("Conv"):
        return t.permute(2, 3, 1, 0)      # OIHW -> HWIO
    return t.t()                          # (out, in) -> (in, out)


def torch_leaf(layer: str, leaf: str, t):
    """JAX-layout array or tensor -> the port's layout."""
    if leaf != "kernel":
        return t
    if _scope(layer).startswith("Conv"):
        return t.permute(3, 2, 0, 1) if isinstance(t, torch.Tensor) else np.transpose(t, (3, 2, 0, 1))
    return t.t() if isinstance(t, torch.Tensor) else np.transpose(t)


def torch_name(layer: str, leaf: str) -> str:
    return f"{layer.replace('/', '.')}.{'bias' if leaf == 'bias' else 'weight'}"


def flax_address(name: str) -> tuple[str, str]:
    """A port parameter name -> its (layer, leaf)."""
    scopes, kind = name.rsplit(".", 1)
    layer = scopes.replace(".", "/")
    if kind == "bias":
        return layer, "bias"
    return layer, "scale" if _scope(layer).startswith("GroupNorm") else "kernel"


def ravel_order(params: dict) -> list[tuple[str, str]]:
    """(layer, leaf) pairs in `jax.flatten_util.ravel_pytree` order: the
    flax tree's keys sorted at every level (so "BasicBlock_*" < "Conv_0" <
    "Dense_0" < "GroupNorm_0", and "bias" < "kernel" / "scale")."""
    return sorted((flax_address(name) for name in params),
                  key=lambda a: (*a[0].split("/"), a[1]))


def _flax_leaves(tree, prefix=()):
    """Nested dict -> ((layer, leaf), array) for every leaf."""
    for key, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _flax_leaves(sub, prefix + (key,))
        else:
            yield ("/".join(prefix), key), sub


def from_flax(params, device="cpu") -> dict[str, torch.Tensor]:
    """flax params (nested dict of arrays, any depth) -> the port's
    parameter dict."""
    return from_named(dict(_flax_leaves(params)), device)


def from_named(arrays: dict, device="cpu") -> dict[str, torch.Tensor]:
    """{(layer, leaf): JAX-layout array} -> the port's parameter dict."""
    out = {}
    for (layer, leaf), arr in arrays.items():
        a = np.array(torch_leaf(layer, leaf, np.asarray(arr, dtype=np.float32)))
        out[torch_name(layer, leaf)] = torch.from_numpy(a).to(device)
    return out


def to_flax(params: dict[str, torch.Tensor]) -> dict:
    """The port's parameter dict -> flax-layout nested dict of numpy arrays."""
    out: dict = {}
    for layer, leaf in ravel_order(params):
        t = flax_leaf(layer, leaf, params[torch_name(layer, leaf)].detach())
        node = out
        for scope in layer.split("/"):
            node = node.setdefault(scope, {})
        node[leaf] = t.cpu().contiguous().numpy()
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
