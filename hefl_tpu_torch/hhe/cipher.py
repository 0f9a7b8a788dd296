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


def exact_int_probes(device="cpu") -> dict:
    """The keystream PRF, the cipher add and the counter-mode round loop as
    declared exact-integer regions: pure integer words, no remainder, no
    float (a float round-trip would shear the packed fields)."""
    key = np.zeros(4, dtype=np.uint32)
    hi = torch.zeros((2, 8), dtype=torch.int32, device=device)
    lo = torch.zeros((2, 8), dtype=torch.int32, device=device)

    def counter(k):
        return [keystream_pair(k, r, (2, 8), device) for r in range(3)]

    return {
        "hhe.cipher.keystream": (lambda k: keystream_pair(k, 1, (2, 8), device), (key,)),
        "hhe.cipher.stream_encrypt": (lambda h, l, k: stream_encrypt(h, l, k, 1),
                                      (hi, lo, key)),
        "hhe.cipher.keystream_counter": (counter, (key,)),
    }


def transcipher_sum_probe(bits: int, k: int, fbits: int, guard: int, clients: int,
                          device="cpu"):
    """The transciphered-aggregation integer pipeline as one traceable
    function (`analysis.ranges.certify_transciphering`).

    Mirrors in plaintext integers what the hybrid-HE path computes under
    encryption: quantize, offset, interleave into the packed value v per
    client; the cipher's wrap carry gamma in {0, 1} (an abstracted INPUT:
    its value depends on the secret keystream, its range does not); the
    transciphered per-client plaintext v - 2**62 * gamma; the C-client sum
    as a `scan` fold plus decrypt noise. Outputs what the certificate
    bounds:

        (field_sums [k, m], noise_sum [m],
         transciphered_total [m],   # sum(v) - 2**62*Gamma + E: the q/2 wall
         recovered_shifted [m])     # sum(v) + E + 2**(guard-1): the window

    -> (fn, example_args) on `device`."""
    from torch._higher_order_ops.scan import scan_op

    from hefl_tpu_torch.ckks import quantize

    qm = quantize.qmax(bits)
    m = 2
    domain = 1 << HHE_DOMAIN_BITS

    def probe(x, gamma, noise):
        q = quantize.quantize(x, 1.0, bits)            # int32 [-qm, qm]
        u = (q + qm).to(torch.int64)                   # [C, k, m] >= 0

        def fold(fs, ns, tot, rec, u_c, g_c, n_c):    # carries, then [k, m], [m], [m]
            packed_c = torch.zeros((m,), dtype=torch.int64, device=u_c.device)
            for j in range(k):
                packed_c = packed_c + (u_c[j] << (guard + j * fbits))
            trans_c = packed_c - g_c * domain          # per-client w - z
            return [fs + u_c, ns + n_c, tot + trans_c + n_c, rec + packed_c + n_c]

        zk = torch.zeros((k, m), dtype=torch.int64, device=x.device)
        zm = torch.zeros((m,), dtype=torch.int64, device=x.device)
        field_sums, noise_sum, total, rec = scan_op(
            fold, [zk, zm, zm.clone(), zm.clone()], [u, gamma, noise], ())
        recovered = rec + (1 << max(guard - 1, 0))
        return field_sums, noise_sum, total, recovered

    x = torch.zeros((int(clients), k, m), dtype=torch.float32, device=device)
    gamma = torch.zeros((int(clients), m), dtype=torch.int64, device=device)
    noise = torch.zeros((int(clients), m), dtype=torch.int64, device=device)
    return probe, (x, gamma, noise)


def keystream_counter_probe(device="cpu"):
    """The counter-mode round loop as one traceable function
    (`analysis.ranges.certify_transciphering`'s loop leg).

    Every round increments the round counter (wrapping mod 2**32 by design,
    modelled as an explicit mask on an int64 carrier so the wrap is a
    proven bound) and encrypts a fresh packed payload with fresh keystream
    words through `add_packed_mod`, the port's word-pair carry add. Over an
    ABSTRACT round count, the analysis proves that the counter stays in
    [0, 2**32), that the carry add never wraps its int64 carrier and that
    both output words stay below 2**31 (the packed (hi, lo) wire
    invariant). The keystream derivation itself wraps by design and enters
    as [0, 2**31) words, the only fact its masking exports.
    -> (fn, example_args) on `device`."""
    from torch._higher_order_ops.while_loop import while_loop_op

    def cond(remaining, r, w_hi, w_lo, *consts):
        return remaining > 0

    def body(remaining, r, w_hi, w_lo, mask, v_hi, v_lo, z_hi, z_lo):
        r = (r + 1) & mask                    # the mod-2**32 counter
        w_hi, w_lo = add_packed_mod(v_hi, v_lo, z_hi, z_lo)
        return remaining - 1, r, w_hi, w_lo

    def probe(rounds, r0, mask, v_hi, v_lo, z_hi, z_lo):
        _, r, w_hi, w_lo = while_loop_op(
            cond, body, (rounds, r0, torch.zeros_like(v_hi), torch.zeros_like(v_lo)),
            (mask, v_hi, v_lo, z_hi, z_lo))
        return r, w_hi, w_lo

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return probe, (scalar(0), scalar(0), scalar(0xFFFFFFFF),
                   *(torch.zeros((2, 8), dtype=torch.int32, device=device) for _ in range(4)))


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
