"""Hybrid homomorphic encryption (HHE) client uplink, counterpart of
`hefl_tpu.hhe`.

  * `hhe.cipher` — the client half: an additive stream cipher over the
    packed 62-bit integer domain (counter-mode SplitMix64-style keystream,
    one carry add per slot), ~1x wire expansion, no NTT on the client.
  * `hhe.transcipher` — the server half: the symmetric ciphertext is
    embedded into CKKS and the client's keystream, provisioned as a CKKS
    ciphertext under the public key, is subtracted homomorphically — one
    launch of the fused transcipher kernel K7 over all arrived uploads.

The decrypted aggregate equals the direct packed-CKKS path's bit for bit
(integer field sums), in any arrival order.
"""

from __future__ import annotations

from hefl_tpu_torch.hhe.cipher import (
    HHE_DOMAIN_BITS,
    HheConfig,
    derive_client_keys,
    hhe_bytes_on_wire_record,
    hhe_center_mod,
    keystream_pair,
    stream_decrypt,
    stream_encrypt,
    sym_wire_bytes,
)
# Importing the function `transcipher` here would shadow the submodule.
from hefl_tpu_torch.hhe.transcipher import provision_pads, transcipher_batch

__all__ = [
    "HHE_DOMAIN_BITS",
    "HheConfig",
    "derive_client_keys",
    "hhe_bytes_on_wire_record",
    "hhe_center_mod",
    "keystream_pair",
    "stream_decrypt",
    "stream_encrypt",
    "sym_wire_bytes",
    "provision_pads",
    "transcipher_batch",
]
