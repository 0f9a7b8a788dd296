"""Server-side transciphering: symmetric HHE uploads -> CKKS ciphertexts.

Counterpart of `hefl_tpu.hhe.transcipher`. Per arrived client the server
holds the symmetric ciphertext w = (v + z) mod 2**62 and, provisioned by the
key authority under the PUBLIC key, a CKKS encryption of that client's round
keystream, Enc(z). Transciphering is exact homomorphic arithmetic:

    trivial(w)  = (NTT(encode_packed(w)), 0)
    transcipher = trivial(w) - Enc(z) = Enc(v - 2**62 * gamma)

`transcipher_core` runs where its tensors live: on CUDA one launch of the
fused transcipher kernel K7 over every (upload row, prime), on the CPU the
plain version. `provision_pads` is one fused-encrypt launch (K3) over every
client's pad rows. The server's whole view is symmetric ciphertexts plus
CKKS ciphertexts; the authority derives each client's pad from its wrapped
master key. `retranscipher_decode` is journal replay's half: one persisted
symmetric upload re-transciphered against its re-derived pad (one K7
launch at [n_ct, L, N] on CUDA), bitwise the live fold's residues.
"""

from __future__ import annotations

import numpy as np
import torch

from hefl_tpu_torch.ckks import cuda_ntt, encoding, ops
from hefl_tpu_torch.ckks.keys import CkksContext, PublicKey
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.hhe import cipher


def transcipher_core(ctx: CkksContext, w_hi, w_lo, pad_c0, pad_c1):
    """Transcipher a batch: words int32[..., n_ct, N], pad residues
    int32[..., n_ct, L, N] -> eval-domain (c0, c1). K7 on CUDA."""
    return cuda_ntt.transcipher_fused(ctx.ntt, w_hi, w_lo, pad_c0, pad_c1)


def transcipher(ctx: CkksContext, w_hi, w_lo, pad: Ciphertext) -> Ciphertext:
    """Transcipher one symmetric upload against its provisioned pad."""
    c0, c1 = transcipher_core(ctx, w_hi, w_lo, pad.c0, pad.c1)
    return Ciphertext(c0=c0, c1=c1, scale=pad.scale)


def provision_pads(
    ctx: CkksContext, pk: PublicKey, keys, round_index: int, n_ct: int,
    enc_gens=None, samples=None,
) -> Ciphertext:
    """The key authority's round step: Enc_pk(keystream) per client ->
    Ciphertext [C, n_ct, L, N] (scale: the context's; callers set theirs).

    `keys` uint32[C, 4] are the client master keys. The encryption
    randomness is drawn per client from `enc_gens[c]` (the direct upload's
    convention), or `samples` = (u, e0, e1) int32[C, n_ct, L, N] are given
    (a test feeding the JAX package's draws). Then ONE encrypt core over all
    C * n_ct rows: one K3 launch on CUDA."""
    device = samples[0].device if samples is not None else enc_gens[0].device
    m_z = torch.stack([
        encoding.encode_packed(ctx.ntt, *cipher.keystream_pair(key, round_index,
                                                                 (n_ct, ctx.n), device))
        for key in keys
    ])
    return ops.encrypt_batch(ctx, pk, m_z, enc_gens, samples)


def transcipher_batch(
    ctx: CkksContext, spec, pk: PublicKey, w_hi, w_lo, keys, round_index: int,
    enc_gens=None, samples=None,
) -> tuple[Ciphertext, Ciphertext]:
    """Provision the pads and transcipher a whole arrived batch: words
    int32[C, n_ct, N] -> (transciphered Ciphertext [C, n_ct, L, N] at the
    packed guard scale, pad Ciphertext). One K3 and one K7 launch on CUDA."""
    pad = provision_pads(ctx, pk, keys, round_index, int(spec.n_ct), enc_gens, samples)
    c0, c1 = transcipher_core(ctx, w_hi.contiguous(), w_lo.contiguous(), pad.c0, pad.c1)
    return (
        Ciphertext(c0=c0, c1=c1, scale=spec.guard_scale),
        Ciphertext(c0=pad.c0, c1=pad.c1, scale=spec.guard_scale),
    )


def retranscipher_decode(ctx: CkksContext, w_hi, w_lo, pad_c0, pad_c1):
    """Journal replay's decode: one upload's symmetric words (host uint32 or
    int32 [n_ct, N], as the journal body holds them, or tensors) and its
    pad residues int32[n_ct, L, N] -> (c0, c1) on the pads' device, through
    `transcipher_core` (K7 on CUDA, its plain version on the CPU)."""
    dev = pad_c0.device

    def words(w):
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.ascontiguousarray(np.asarray(w).astype(np.int32)))
        return w.to(device=dev, dtype=torch.int32).contiguous()

    return transcipher_core(ctx, words(w_hi), words(w_lo), pad_c0.contiguous(),
                            pad_c1.contiguous())
