"""Wire files for keys and ciphertexts at the trust boundaries.

Counterpart of `hefl_tpu.utils.serialization`, in its format: every artifact
is a plain `.npz` of integer arrays plus a JSON header (magic
`hefl-tpu-wire-v1`, the same kinds, header keys and member names), so a file
written by either package loads in the other.

  * public material — context tables + public key: what clients and the
    aggregating server receive.
  * secret key — sk alone, a file that never travels with ciphertexts.
  * relin / Galois keys — evaluation keys a server may hold (ct x ct,
    rotations), not decryption.
  * ciphertext — c0/c1 RNS limbs + scale; no key material.

The port keeps residues as int32 tensors with the bits of the JAX package's
uint32 words; the files hold uint32 (`.view`, no arithmetic), and loading
gives int32 CPU tensors with the same bits. The NTT tables travel with the
public material, so a loaded context is the originating one word for word.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, PublicKey, RelinKey, SecretKey
from hefl_tpu_torch.ckks.ntt import NTTContext
from hefl_tpu_torch.ckks.ops import Ciphertext

_MAGIC = "hefl-tpu-wire-v1"
_NTT_FIELDS = ("p", "pinv_neg", "r2", "psi_rev", "psi_inv_rev", "n_inv_mont")


def _words(t: torch.Tensor) -> np.ndarray:
    """int32 residues (any device) -> the uint32 words of the wire format."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _residues(a) -> torch.Tensor:
    """uint32 words from a file -> int32 CPU tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _header(kind: str, **fields) -> np.ndarray:
    return np.frombuffer(json.dumps({"magic": _MAGIC, "kind": kind, **fields}).encode(),
                         dtype=np.uint8)


def _read_header(z, expected_kind: str) -> dict:
    header = json.loads(bytes(z["header"]).decode())
    if header.get("magic") != _MAGIC:
        raise ValueError(f"not a {_MAGIC} file")
    if header.get("kind") != expected_kind:
        raise ValueError(f"expected kind={expected_kind!r}, got {header.get('kind')!r}")
    return header


def save_public_material(path: str, ctx: CkksContext, pk: PublicKey) -> None:
    """Write (context, pk): the broadcast to every client and the server."""
    np.savez_compressed(
        path,
        header=_header("public", n=ctx.n, scale=ctx.scale, sigma=ctx.sigma),
        b_mont=_words(pk.b_mont),
        a_mont=_words(pk.a_mont),
        **{f: np.asarray(getattr(ctx.ntt, f), dtype=np.uint32) for f in _NTT_FIELDS},
    )


def load_public_material(path: str) -> tuple[CkksContext, PublicKey]:
    with np.load(path) as z:
        header = _read_header(z, "public")
        n = int(header["n"])
        ntt = NTTContext(n=n, logn=n.bit_length() - 1,
                         **{f: np.array(z[f], dtype=np.uint32) for f in _NTT_FIELDS})
        ctx = CkksContext(ntt=ntt, scale=float(header["scale"]), sigma=float(header["sigma"]))
        pk = PublicKey(b_mont=_residues(z["b_mont"]), a_mont=_residues(z["a_mont"]))
    return ctx, pk


def save_secret_key(path: str, sk: SecretKey) -> None:
    """sk in its own file, owner-only: nothing else is bundled with it."""
    np.savez_compressed(path, header=_header("secret"), s_mont=_words(sk.s_mont))


def load_secret_key(path: str) -> SecretKey:
    with np.load(path) as z:
        _read_header(z, "secret")
        return SecretKey(s_mont=_residues(z["s_mont"]))


def save_relin_key(path: str, rlk: RelinKey) -> None:
    """Evaluation key the server may hold: enables ct x ct, not decryption."""
    np.savez_compressed(path, header=_header("relin"), b_mont=_words(rlk.b_mont),
                        a_mont=_words(rlk.a_mont))


def load_relin_key(path: str) -> RelinKey:
    with np.load(path) as z:
        _read_header(z, "relin")
        return RelinKey(b_mont=_residues(z["b_mont"]), a_mont=_residues(z["a_mont"]))


def save_galois_key(path: str, gk: GaloisKey) -> None:
    """Rotation key for X -> X^g: an evaluation key, like the relin key."""
    np.savez_compressed(path, header=_header("galois", g=gk.g), b_mont=_words(gk.b_mont),
                        a_mont=_words(gk.a_mont))


def load_galois_key(path: str) -> GaloisKey:
    with np.load(path) as z:
        header = _read_header(z, "galois")
        return GaloisKey(b_mont=_residues(z["b_mont"]), a_mont=_residues(z["a_mont"]),
                         g=int(header["g"]))


def save_ciphertext(path: str, ct: Ciphertext) -> None:
    """Ciphertext limbs only: the client-upload / aggregated-download wire."""
    np.savez_compressed(path, header=_header("ciphertext", scale=ct.scale),
                        c0=_words(ct.c0), c1=_words(ct.c1))


def load_ciphertext(path: str) -> Ciphertext:
    with np.load(path) as z:
        header = _read_header(z, "ciphertext")
        return Ciphertext(c0=_residues(z["c0"]), c1=_residues(z["c1"]),
                          scale=float(header["scale"]))
