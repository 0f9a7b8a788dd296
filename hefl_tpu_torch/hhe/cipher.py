"""Client-side additive stream cipher over the packed integer domain.

Counterpart of `hefl_tpu.hhe.cipher`. A client's packed quantized update is
one integer v < 2**62 per slot, carried as (hi, lo) words below 2**31
(v = hi * 2**31 + lo). The client encrypts it as

    w = (v + z) mod 2**62          z = keystream(key_c, round, slot)

one keystream sweep and one carry-propagating add per slot: no NTT, no RNS
residues, and the wire carries the same 8 bytes a slot as the packed
plaintext. The keystream is the JAX package's counter-mode SplitMix64-style
mix over 64-bit word pairs, keyed by a per-client 128-bit master key; the
port computes the same words with int64 tensors holding 32-bit values
(`_mul64` splits into 16-bit halves, so no product leaves int64, and every
result is masked to 32 bits), so its keystream is the JAX package's bit for
bit. The server's transcipher (`hhe.transcipher`) turns w into a CKKS
ciphertext of v - 2**62 * gamma (gamma in {0, 1}, the cipher's wrap); the
owner's `hhe_center_mod` removes that multiple exactly.

SplitMix64 is a stand-in PRF, statistically strong but not a vetted
cryptographic cipher; the keystream function is the single swap point for
a production ARX cipher over the same (hi, lo) layout.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from hefl_tpu_torch.ckks.quantize import MAX_PACKED_BITS

HHE_DOMAIN_BITS = MAX_PACKED_BITS
_LO_BITS = 31
_MASK31 = (1 << 31) - 1
_MASK32 = (1 << 32) - 1
_MASK16 = (1 << 16) - 1
# Per-upload wire header: client id, round, key epoch, format tag (4 B each).
WIRE_HEADER_BYTES = 16

# SplitMix64 mixing constants as (hi, lo) 32-bit words.
_GAMMA = (0x9E3779B9, 0x7F4A7C15)
_MIX1 = (0xBF58476D, 0x1CE4E5B9)
_MIX2 = (0x94D049BB, 0x133111EB)


@dataclasses.dataclass(frozen=True)
class HheConfig:
    """Hybrid-HE uplink knobs. key_seed: the root of the per-client
    master-key derivation (`derive_client_keys`)."""

    key_seed: int = 0


# --- 64-bit word-pair arithmetic on int64 tensors holding 32-bit words -------


def _mul32_wide(a, b):
    """Full 64-bit product of two 32-bit words -> (hi, lo) words. a is split
    into 16-bit halves so every partial product stays below 2**48."""
    p0 = (a & _MASK16) * b
    p1 = (a >> 16) * b
    mid = p0 + ((p1 & _MASK16) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _MASK32


def _mul_lo32(a, b):
    """(a * b) mod 2**32 for 32-bit words, without leaving int64."""
    return ((a & _MASK16) * b + ((((a >> 16) * b) & _MASK16) << 16)) & _MASK32


def _add64(a_hi, a_lo, b_hi, b_lo):
    lo = (a_lo + b_lo) & _MASK32
    carry = (lo < a_lo).to(torch.int64)
    return (a_hi + b_hi + carry) & _MASK32, lo


def _xor64(a_hi, a_lo, b_hi, b_lo):
    return a_hi ^ b_hi, a_lo ^ b_lo


def _shr64(hi, lo, k: int):
    """Logical right shift by a static 0 < k < 32."""
    return hi >> k, (lo >> k) | ((hi & ((1 << k) - 1)) << (32 - k))


def _mul64(a_hi, a_lo, b_hi, b_lo):
    """Low 64 bits of the product."""
    ll_hi, ll_lo = _mul32_wide(a_lo, b_lo)
    hi = (ll_hi + _mul_lo32(a_lo, b_hi) + _mul_lo32(a_hi, b_lo)) & _MASK32
    return hi, ll_lo


def _mix64(hi, lo):
    """The SplitMix64 finalizer: xor-shift / multiply / xor-shift."""
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 30))
    hi, lo = _mul64(hi, lo, *_MIX1)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 27))
    hi, lo = _mul64(hi, lo, *_MIX2)
    return _xor64(hi, lo, *_shr64(hi, lo, 31))


# --- Key derivation (host) and the counter-mode keystream --------------------


@functools.lru_cache(maxsize=16)
def derive_client_keys(seed: int, num_clients: int) -> np.ndarray:
    """Per-client 128-bit master keys uint32[C, 4], derived from the
    enrollment seed by SHA-256 (read-only: the cached array is shared)."""
    out = np.empty((int(num_clients), 4), np.uint32)
    for c in range(int(num_clients)):
        d = hashlib.sha256(f"hefl-hhe-key-v1|{int(seed)}|{c}".encode()).digest()
        out[c] = np.frombuffer(d[:16], np.uint32)
    out.setflags(write=False)
    return out


def _key_words(key) -> list[int]:
    """A 4-word key (numpy uint32, a sequence, or a tensor) -> Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    return [int(k) & _MASK32 for k in np.asarray(key).reshape(4)]


def keystream_pair(key, round_index: int, shape: tuple[int, int], device="cpu"):
    """The (hi, lo) keystream of one client's round: one draw from [0, 2**62)
    per slot of the packed geometry `shape` = (n_ct, n), as int32 tensors on
    `device`.

    Counter mode: the block counter is (key[2] ^ round, key[3] ^ slot index),
    added to (key[0], key[1]), mixed, xored with (key[1], key[0]), mixed,
    offset by the golden gamma and mixed; bits [31, 62) and [0, 31) of the
    result are hi and lo. `round_index` is taken mod 2**32.
    """
    k0, k1, k2, k3 = _key_words(key)
    n_ct, n = int(shape[0]), int(shape[1])
    r = int(round_index) & _MASK32
    lo = torch.arange(n_ct * n, dtype=torch.int64, device=device).reshape(n_ct, n) ^ k3
    hi = torch.full_like(lo, k2 ^ r)
    hi, lo = _add64(hi, lo, k0, k1)
    hi, lo = _mix64(hi, lo)
    hi, lo = _xor64(hi, lo, k1, k0)
    hi, lo = _mix64(hi, lo)
    hi, lo = _add64(hi, lo, *_GAMMA)
    hi, lo = _mix64(hi, lo)
    return ((hi >> 1) & _MASK31).to(torch.int32), (lo & _MASK31).to(torch.int32)


# --- The cipher: one carry-propagating add / subtract per slot, mod 2**62 ----


def add_packed_mod(a_hi, a_lo, b_hi, b_lo):
    """(a + b) mod 2**62 on (hi, lo) word pairs (each word < 2**31)."""
    lo = a_lo.to(torch.int64) + b_lo.to(torch.int64)
    hi = (a_hi.to(torch.int64) + b_hi.to(torch.int64) + (lo >> _LO_BITS)) & _MASK31
    return hi.to(torch.int32), (lo & _MASK31).to(torch.int32)


def sub_packed_mod(a_hi, a_lo, b_hi, b_lo):
    """(a - b) mod 2**62 on (hi, lo) word pairs."""
    a_lo, b_lo = a_lo.to(torch.int64), b_lo.to(torch.int64)
    borrow = (a_lo < b_lo).to(torch.int64)
    lo = (a_lo - b_lo) & _MASK31
    hi = (a_hi.to(torch.int64) - b_hi.to(torch.int64) - borrow) & _MASK31
    return hi.to(torch.int32), lo.to(torch.int32)


def stream_encrypt(hi, lo, key, round_index: int):
    """One client's packed update (hi, lo int32[n_ct, n]) -> the symmetric
    ciphertext, same shape and bytes: w = (v + keystream) mod 2**62."""
    z_hi, z_lo = keystream_pair(key, round_index, tuple(hi.shape[-2:]), hi.device)
    return add_packed_mod(hi, lo, z_hi, z_lo)


def stream_decrypt(w_hi, w_lo, key, round_index: int):
    """Inverse of `stream_encrypt`."""
    z_hi, z_lo = keystream_pair(key, round_index, tuple(w_hi.shape[-2:]), w_hi.device)
    return sub_packed_mod(w_hi, w_lo, z_hi, z_lo)


def hhe_center_mod(v: np.ndarray, guard: int) -> np.ndarray:
    """Recover the packed aggregate from the transciphered decode (host).

    `v` is `encoding.decode_int_center` of the transciphered sum,
    sum(v_c) - 2**62 * Gamma + E with |E| < 2**(guard-1); one shifted
    mod-2**62 reduction removes the Gamma term exactly while
    -2**(guard-1) <= sum(v) + E < 2**62 - 2**(guard-1) (the window
    `analysis.ranges.certify_transciphering` proves)."""
    v = np.asarray(v, dtype=np.int64)
    mask = np.int64((1 << HHE_DOMAIN_BITS) - 1)
    h = np.int64(1 << max(int(guard) - 1, 0))
    return ((v + h) & mask) - h


# --- Wire accounting ----------------------------------------------------------


def sym_wire_bytes(spec) -> int:
    """Per-client uplink bytes of one HHE upload: the (hi, lo) pair per
    packed slot plus the constant wire header."""
    return spec.n_ct * spec.n * 8 + WIRE_HEADER_BYTES


def hhe_bytes_on_wire_record(spec, num_limbs: int) -> dict:
    """The HHE wire record: symmetric upload bytes against the packed
    plaintext (`expansion_hhe`), the raw b-bit codes, and the packed CKKS
    ciphertext the upload replaces."""
    from hefl_tpu_torch.ckks.packing import ciphertext_bytes

    wire = sym_wire_bytes(spec)
    plain_quantized = spec.n_ct * spec.n * 8
    plain_codes = -(-spec.total * spec.bits // 8)
    ckks = ciphertext_bytes(spec.n_ct, num_limbs, spec.n)
    return {
        "hhe_upload": wire,
        "plain_quantized": plain_quantized,
        "plain_codes": plain_codes,
        "ciphertext_packed": ckks,
        "expansion_hhe": round(wire / plain_quantized, 3),
        "expansion_vs_codes": round(wire / plain_codes, 3),
        "reduction_vs_ckks": round(ckks / wire, 2),
    }
