"""FedBit-style quantization and bit-interleaving for CKKS slot packing.

Counterpart of `hefl_tpu.ckks.quantize`. A client's UPDATE (trained minus
global weights) is quantized to b bits, q = clip(round(x / step), ±qmax)
with qmax = 2**(b-1) - 1 and step = clip / qmax, offset to non-negative
codes u = q + qmax, and k codes are bit-interleaved into one packed integer
per CKKS slot:

    field_bits = b + ceil(log2 C)              # C = max summed clients
    v = sum_j u_j << (guard + j*field_bits)     # guard = guard_bits + ceil(log2 C)

so the homomorphic sum of up to C clients never carries across fields and
the low `guard` bits absorb the decrypt noise. v < 2**62 is carried as a
(hi, lo) pair of words below 2**31 (v = hi * 2**31 + lo), int32 tensors in
the port (the JAX package's uint32 words, same bits).

The quantizer runs in float32 with the JAX package's steps in the same
order (`torch.round` rounds half to even, as `jnp.round` does), so codes
are bitwise the JAX package's. Word and field arithmetic is int64. The
decode side (`deinterleave_fields`, `decode_field_sums`) is host numpy,
copied from the JAX package. `max_interleave` cross-checks its closed-form
k against `hefl_tpu_torch.analysis.ranges.certify_packing`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Exactness ceiling of the packed integer: the (hi, lo) split carries
# v = hi*2**31 + lo with hi < 2**31, and the int64 recombination of
# `encoding.decode_int_center` is exact two's-complement below 2**63.
MAX_PACKED_BITS = 62
_LO_BITS = 31
_LO_MASK = (1 << _LO_BITS) - 1


def qmax(bits: int) -> int:
    """Largest quantized magnitude at b bits (symmetric, zero-centered)."""
    return (1 << (bits - 1)) - 1


def symmetric_step(clip, bits: int):
    """Quantization step for a symmetric b-bit grid covering [-clip, clip]."""
    return clip / qmax(bits)


@dataclasses.dataclass(frozen=True)
class PackingConfig:
    """Quantized-packing knobs, the JAX package's fields and defaults.

    bits:         quantization width b (0 disables packing).
    interleave:   coefficients per slot k (0 = auto, `max_interleave`).
    clip:         symmetric clip bound on a client's update; a scalar, or a
                  per-tensor tuple (one bound per parameter tensor, in
                  ravel order).
    guard_bits:   low bits reserved per slot for decrypt noise (the
                  effective guard adds ceil(log2 C)).
    error_budget: declared max |packed - unpacked| error per averaged
                  coefficient (0 = auto: step/2 + 1e-4).
    error_feedback: residual-carrying quantization (`ef_quantize`): each
                  client quantizes update + residual and carries the
                  remainder to its next upload; needs the streaming
                  engine, which owns the residual rows.
    """

    bits: int = 0
    interleave: int = 0
    clip: "float | tuple[float, ...]" = 0.5
    guard_bits: int = 16
    error_budget: float = 0.0
    error_feedback: bool = False

    def __post_init__(self):
        if self.bits and not 2 <= self.bits <= 16:
            raise ValueError(
                f"PackingConfig.bits={self.bits}: must be 0 (disabled) or 2..16"
            )
        if self.interleave < 0:
            raise ValueError("PackingConfig.interleave must be >= 0 (0 = auto)")
        if isinstance(self.clip, (list, tuple)):
            object.__setattr__(self, "clip", tuple(float(c) for c in self.clip))
            if self.bits and (not self.clip or any(c <= 0 for c in self.clip)):
                raise ValueError(
                    "PackingConfig.clip: a per-tensor clip schedule needs at "
                    "least one entry, every entry > 0"
                )
        elif self.bits and self.clip <= 0:
            raise ValueError("PackingConfig.clip must be > 0")
        if self.bits and not 4 <= self.guard_bits <= 30:
            raise ValueError(f"PackingConfig.guard_bits={self.guard_bits}: need 4..30")
        if self.error_feedback and not self.bits:
            raise ValueError("PackingConfig.error_feedback needs packing (bits > 0)")

    @property
    def enabled(self) -> bool:
        return self.bits > 0

    @property
    def per_tensor(self) -> bool:
        return isinstance(self.clip, tuple)

    @property
    def step(self) -> "float | tuple[float, ...]":
        """Quantization step(s): one float for a scalar clip, else a tuple."""
        if self.per_tensor:
            return tuple(float(symmetric_step(c, self.bits)) for c in self.clip)
        return float(symmetric_step(self.clip, self.bits))


def field_bits(bits: int, clients: int) -> int:
    """Width of one interleaved field: b plus ceil(log2 C) carry headroom."""
    return bits + max(int(clients) - 1, 0).bit_length()


def payload_bits(modulus: int, guard: int) -> int:
    """Usable packed-integer bits: min(floor(log2 q) - 1, 62) - guard."""
    return min(modulus.bit_length() - 2, MAX_PACKED_BITS) - guard


def max_interleave(modulus: int, bits: int, clients: int, guard_bits: int) -> int:
    """The headroom-formula packing factor k = floor(payload / field_bits),
    cross-checked against `analysis.ranges.certify_packing`: a disagreement
    is a bug in one of the two and raises RuntimeError."""
    guard_eff = guard_bits + max(int(clients) - 1, 0).bit_length()
    avail = payload_bits(modulus, guard_eff)
    k = avail // field_bits(bits, clients)
    if k < 1:
        raise ValueError(
            f"no packing headroom: {avail} payload bits cannot hold one "
            f"{field_bits(bits, clients)}-bit field (bits={bits}, "
            f"clients={clients}, guard={guard_bits}); lower bits/guard or "
            "add RNS primes"
        )
    from hefl_tpu_torch.analysis import ranges

    cert = ranges.certify_packing(int(modulus), bits, k, int(clients), guard_bits)
    if not cert.ok:
        raise RuntimeError(
            f"headroom formula and certificate disagree at k={k}: "
            f"{cert.summary()}"
        )
    return k


# --- Quantizer (float32; step a scalar or a per-coefficient vector) ---------


def _step_tensor(step, like: torch.Tensor) -> torch.Tensor:
    """float32(step) on `like`'s device, as `jnp` would convert it."""
    return torch.as_tensor(np.asarray(step, dtype=np.float32), device=like.device)


def quantize(x: torch.Tensor, step, bits: int) -> torch.Tensor:
    """float -> int32 symmetric b-bit code, saturating at +/-qmax."""
    qm = qmax(bits)
    q = torch.clamp(torch.round(x / _step_tensor(step, x)), -qm, qm)
    return q.to(torch.int32)


def dequantize(q: torch.Tensor, step) -> torch.Tensor:
    """int code -> float32 value on the quantization grid."""
    return q.to(torch.float32) * _step_tensor(step, q)


def ef_quantize(x: torch.Tensor, residual: torch.Tensor, step, bits: int):
    """Error-feedback quantization: quantize `x + residual` and return the
    new residual, the part of the carried signal the b-bit grid could not
    express this round:

        q         = quantize(x + residual)        # int32 in [-qmax, qmax]
        residual' = (x + residual) - dequantize(q)

    While the carried value stays inside the clip, |residual'| <= step/2; a
    saturating coefficient parks its excess in the residual instead of
    losing it. The codes are clipped exactly like `quantize`'s, so the
    carry-free interleave certificate holds unchanged. float32 throughout,
    in the JAX package's order, so the codes and the residual are bitwise
    its. -> (q int32, residual' float32)."""
    carried = x.to(torch.float32) + residual.to(torch.float32)
    q = quantize(carried, step, bits)
    return q, carried - dequantize(q, step)


def saturation_count(x: torch.Tensor, step, bits: int) -> torch.Tensor:
    """How many of `x` saturate the b-bit grid at this step (non-finite
    values count)."""
    scaled = x / _step_tensor(step, x)
    bad = ~torch.isfinite(scaled) | (torch.abs(scaled) > qmax(bits) + 0.5)
    return torch.sum(bad, dtype=torch.int32)


# --- Bit-interleave <-> deinterleave ----------------------------------------


def interleave_fields(u: torch.Tensor, k: int, fbits: int, guard: int):
    """Non-negative fields [..., k, n] -> (hi, lo) int32 words [..., n].

    Field j (masked to its width) lands at bit offset guard + j*fbits of
    v = hi*2**31 + lo; offsets are disjoint, so the combine is pure OR.
    """
    total = guard + k * fbits
    if total > MAX_PACKED_BITS:
        raise ValueError(
            f"interleave_fields: guard + k*field_bits = {total} exceeds the "
            f"{MAX_PACKED_BITS}-bit exact-integer ceiling"
        )
    mask = (1 << fbits) - 1
    shape = u.shape[:-2] + u.shape[-1:]
    hi = torch.zeros(shape, dtype=torch.int64, device=u.device)
    lo = torch.zeros(shape, dtype=torch.int64, device=u.device)
    for j in range(k):
        uj = u[..., j, :].to(torch.int64) & mask
        o = guard + j * fbits
        if o >= _LO_BITS:
            hi = hi | (uj << (o - _LO_BITS))
        else:
            lo = lo | ((uj << o) & _LO_MASK)
            if o + fbits > _LO_BITS:
                hi = hi | (uj >> (_LO_BITS - o))
    return hi.to(torch.int32), lo.to(torch.int32)


def packed_value_int64(hi, lo) -> np.ndarray:
    """(hi, lo) words -> the packed integer as int64 (host)."""
    hi = hi.cpu().numpy() if isinstance(hi, torch.Tensor) else np.asarray(hi)
    lo = lo.cpu().numpy() if isinstance(lo, torch.Tensor) else np.asarray(lo)
    return (hi.astype(np.int64) << _LO_BITS) | lo.astype(np.int64)


def deinterleave_fields(v: np.ndarray, k: int, fbits: int, guard: int) -> np.ndarray:
    """int64 packed sums [..., n] -> int64 field sums [..., k, n] (host).

    One arithmetic rounding shift absorbs the guard band (exact while the
    accumulated noise stays below 2**(guard-1)), then masked shifts."""
    v = np.asarray(v, dtype=np.int64)
    w = (v + (1 << (guard - 1))) >> guard if guard else v
    mask = np.int64((1 << fbits) - 1)
    return np.stack([(w >> (j * fbits)) & mask for j in range(k)], axis=-2)


def decode_field_sums(fields: np.ndarray, step: float, offset: int, surviving: int) -> np.ndarray:
    """Field sums over S surviving clients -> the dequantized AVERAGE:
    (sum_fields - S*offset) * step / S, float32."""
    if surviving <= 0:
        raise ValueError("decode_field_sums: surviving must be positive")
    q_sum = fields.astype(np.int64) - np.int64(surviving) * np.int64(offset)
    return (q_sum * (float(step) / surviving)).astype(np.float32)


def quant_error_budget(cfg: PackingConfig) -> float:
    """The declared per-coefficient |packed - unpacked| budget: the
    configured override, else half the coarsest step + 1e-4."""
    if cfg.error_budget:
        return float(cfg.error_budget)
    step = cfg.step
    worst = max(step) if isinstance(step, tuple) else step
    return 0.5 * worst + 1e-4


def describe(cfg: PackingConfig, modulus: int, clients: int) -> dict:
    """Human/artifact-facing summary of a packing choice at one geometry
    (the JAX package's `describe`)."""
    fb = field_bits(cfg.bits, clients)
    guard_eff = cfg.guard_bits + max(int(clients) - 1, 0).bit_length()
    k = cfg.interleave or max_interleave(modulus, cfg.bits, clients, cfg.guard_bits)
    return {
        "bits": cfg.bits,
        "interleave": k,
        "field_bits": fb,
        "guard_bits": guard_eff,
        "clip": cfg.clip,
        "step": cfg.step,
        "payload_bits": payload_bits(modulus, guard_eff),
        "error_budget": quant_error_budget(cfg),
        "error_feedback": bool(cfg.error_feedback),
        "clients": int(clients),
        "headroom_ok": guard_eff + k * fb <= min(modulus.bit_length() - 2, MAX_PACKED_BITS),
    }
