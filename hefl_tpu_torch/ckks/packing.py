"""Pack a model's parameters into CKKS plaintext coefficient blocks.

Counterpart of `hefl_tpu.ckks.packing` (`PackSpec`, `pack_pytree`,
`unpack_blocks`, and the quantized half: `PackedSpec`,
`pack_quantized_flat`/`_delta`, `unpack_quantized`). The parameters are
raveled into one flat float32 vector in the JAX package's
`jax.flatten_util.ravel_pytree` order and layout — layers sorted by name
(`Conv_0` ... `Dense_2`), `bias` before `kernel`, conv kernels in HWIO and
dense kernels as (in, out) — zero-padded to a multiple of N and reshaped to
[n_ct, N]. So ciphertext row k carries the same weights in both packages:
MedCNN's 222,722 parameters fill 55 rows at N=4096.

The quantized path packs a client's UPDATE (trained minus global weights):
b-bit codes, k interleaved per slot (`ckks.quantize`), so the upload is
[ceil(n_ct / k), N] (hi, lo) word pairs — 19 rows for MedCNN at b=8, k=3,
10 at b=4, k=6. The `_ef` packers quantize the update plus a carried
residual (error feedback) and return the new residual.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hefl_tpu_torch.ckks import quantize
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


def flat_params(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Parameter dict -> float32[total] in the JAX package's ravel order."""
    return torch.cat([
        flax_leaf(layer, leaf, params[torch_name(layer, leaf)]).reshape(-1)
        for layer, leaf in ravel_order(params)
    ]).to(torch.float32)


def pack_params(params: dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """Parameter dict -> coefficient blocks float32[n_ct, n], zero-padded."""
    flat = flat_params(params)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, n)


def unpack_blocks(blocks: torch.Tensor, spec: PackSpec) -> dict[str, torch.Tensor]:
    """float[n_ct, n] (or a flat vector) -> parameter dict in the port's
    layout (drops padding)."""
    flat = blocks.reshape(-1)[: spec.total]
    out, off = {}, 0
    for layer, leaf, shape in spec.entries:
        size = int(torch.Size(shape).numel())
        t = flat[off: off + size].reshape(shape)
        out[torch_name(layer, leaf)] = torch_leaf(layer, leaf, t).contiguous()
        off += size
    return out


# --- Quantized bit-interleaved packing --------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """Static packed geometry for one model template + ring + PackingConfig
    (the fields of the JAX package's `PackedSpec`)."""

    base: PackSpec            # the unpacked geometry
    bits: int                 # quantizer width b
    k: int                    # interleave factor (blocks per packed row)
    field_bits: int           # b + ceil(log2(clients)): carry-free field width
    guard: int                # noise guard bits below the payload
    step: float               # quantization step (the coarsest, per-tensor)
    clip: float               # clip bound on updates (max of a schedule)
    clients: int              # max clients a field sum must hold carry-free
    n_ct: int                 # PACKED rows = ceil(base.n_ct / k)
    error_budget: float       # declared |packed - unpacked| per-coeff budget
    clips: "tuple[float, ...] | None" = None   # per-tensor schedule, ravel order
    spans: "tuple[int, ...] | None" = None     # the matching tensor sizes
    error_feedback: bool = False

    @classmethod
    def for_params(cls, params: dict, ctx, cfg: quantize.PackingConfig,
                   num_clients: int) -> "PackedSpec":
        """Geometry for `params` under `ctx` (a CkksContext) and `cfg`;
        `num_clients` sizes the carry-free headroom. The geometry is
        certified by `analysis.ranges.certify_packing` (the closed-form
        restatement of the JAX package's range proof) or refused."""
        from hefl_tpu_torch.analysis import ranges

        if not cfg.enabled:
            raise ValueError("PackedSpec.for_params: PackingConfig is disabled")
        base = PackSpec.for_params(params, ctx.n)
        clips = spans = None
        if cfg.per_tensor:
            if len(cfg.clip) != len(base.entries):
                raise ValueError(
                    f"PackingConfig.clip schedule has {len(cfg.clip)} entries but "
                    f"the model has {len(base.entries)} parameter tensors — one "
                    "clip per tensor, ravel order"
                )
            clips = tuple(float(c) for c in cfg.clip)
            spans = tuple(int(torch.Size(shape).numel()) for _, _, shape in base.entries)
        fb = quantize.field_bits(cfg.bits, num_clients)
        k = cfg.interleave or quantize.max_interleave(
            ctx.modulus, cfg.bits, num_clients, cfg.guard_bits
        )
        guard = cfg.guard_bits + max(int(num_clients) - 1, 0).bit_length()
        cert = ranges.certify_packing(int(ctx.modulus), cfg.bits, k, int(num_clients),
                                      cfg.guard_bits)
        if not cert.ok:
            raise ValueError(
                f"PackedSpec: k={k} at bits={cfg.bits}, clients={num_clients} "
                f"rejected — {cert.summary()} — lower interleave/bits/guard or "
                "add RNS primes"
            )
        step = cfg.step
        return cls(
            base=base, bits=cfg.bits, k=k, field_bits=fb, guard=guard,
            step=max(step) if isinstance(step, tuple) else float(step),
            clip=max(cfg.clip) if cfg.per_tensor else float(cfg.clip),
            clients=int(num_clients), n_ct=-(-base.n_ct // k),
            error_budget=quantize.quant_error_budget(cfg), clips=clips, spans=spans,
            error_feedback=bool(cfg.error_feedback),
        )

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def total(self) -> int:
        return self.base.total

    @property
    def offset(self) -> int:
        """The non-negativity offset added to every code on the wire."""
        return quantize.qmax(self.bits)

    @property
    def guard_scale(self) -> float:
        """The `scale` of a packed ciphertext: 2**guard."""
        return float(1 << self.guard)

    def bytes_on_wire(self, num_limbs: int) -> int:
        """Per-client uplink bytes of one packed encryption (c0 + c1)."""
        return ciphertext_bytes(self.n_ct, num_limbs, self.n)

    def geometry_record(self) -> dict:
        """The packing-geometry fields a run's record embeds."""
        return {
            "bits": self.bits, "interleave": self.k, "field_bits": self.field_bits,
            "guard_bits": self.guard, "clip": self.clip,
            "clips": list(self.clips) if self.clips is not None else None,
            "n_ct": self.n_ct, "n_ct_unpacked": self.base.n_ct,
            "error_budget": self.error_budget, "error_feedback": self.error_feedback,
        }


def step_vector(spec: PackedSpec) -> "np.ndarray | None":
    """Per-coefficient steps float32[total] of a per-tensor clip schedule
    (each tensor's step over its span), or None for the scalar grid."""
    if spec.clips is None:
        return None
    steps = np.concatenate([
        np.full(span, quantize.symmetric_step(c, spec.bits), dtype=np.float32)
        for c, span in zip(spec.clips, spec.spans)
    ])
    if steps.shape[0] != spec.total:
        raise ValueError(
            f"per-tensor spans sum to {steps.shape[0]} but the template has "
            f"{spec.total} coefficients — stale PackedSpec?"
        )
    return steps


def ciphertext_bytes(n_ct: int, num_limbs: int, n: int) -> int:
    """Wire bytes of one [n_ct, L, N] ciphertext batch: c0 and c1, 4 B a word."""
    return 2 * n_ct * num_limbs * n * 4


def bytes_on_wire_record(spec: PackedSpec, num_limbs: int) -> dict:
    """Per-client uplink bytes of the float32 update, the unpacked
    ciphertext pair, and the packed pair."""
    unpacked = ciphertext_bytes(spec.base.n_ct, num_limbs, spec.n)
    packed = spec.bytes_on_wire(num_limbs)
    plain = spec.total * 4
    return {
        "plain_update": plain,
        "ciphertext_unpacked": unpacked,
        "ciphertext_packed": packed,
        "packed_reduction": round(unpacked / packed, 2),
        "expansion_unpacked": round(unpacked / plain, 2),
        "expansion_packed": round(packed / plain, 2),
    }


def _interleave_codes(q: torch.Tensor, spec: PackedSpec):
    """int32 codes [total] -> (hi, lo) int32[n_ct, n]: the shared tail of the
    plain and error-feedback packers — offset to non-negative codes, pad to
    k*n_ct blocks (code 0), interleave k consecutive blocks per packed row."""
    u = q.to(torch.int64) + spec.offset
    pad = spec.n_ct * spec.k * spec.n - spec.total
    if pad:
        u = torch.cat([u, u.new_zeros(pad)])
    return quantize.interleave_fields(
        u.reshape(spec.n_ct, spec.k, spec.n), spec.k, spec.field_bits, spec.guard
    )


def probe_spec(bits: int = 8, k: int = 2, clients: int = 2) -> PackedSpec:
    """A tiny hand-built PackedSpec for the lint's regions and fixtures (the
    JAX module's `probe_spec`): no model template or CKKS context."""
    n = 8
    base = PackSpec(n=n, total=2 * k * n, n_ct=2 * k, entries=())
    return PackedSpec(
        base=base, bits=bits, k=k, field_bits=quantize.field_bits(bits, clients),
        guard=6 + max(clients - 1, 0).bit_length(), step=0.5 / quantize.qmax(bits), clip=0.5,
        clients=clients, n_ct=2, error_budget=0.1,
    )


def exact_int_probes(device="cpu") -> dict:
    """The packed wire format's declared exact-integer region: the integer
    tail of `pack_quantized_flat` (offset + interleave of quantized codes;
    the quantizer before it is float by design)."""
    spec = probe_spec()
    q = torch.zeros((spec.total,), dtype=torch.int32, device=device)
    return {"ckks.packing.interleave_tail": (lambda c: _interleave_codes(c, spec), (q,))}


def _steps(spec: PackedSpec):
    steps = step_vector(spec)
    return spec.step if steps is None else steps


def pack_quantized_flat(flat: torch.Tensor, spec: PackedSpec):
    """float[total] update -> ((hi, lo) int32[n_ct, n], saturation int32).

    Quantize -> `_interleave_codes`. `saturation` counts coefficients that
    clipped or were non-finite."""
    flat = flat.to(torch.float32)
    step = _steps(spec)
    sat = quantize.saturation_count(flat, step, spec.bits)
    hi, lo = _interleave_codes(quantize.quantize(flat, step, spec.bits), spec)
    return hi, lo, sat


def pack_quantized_flat_ef(flat: torch.Tensor, residual: torch.Tensor, spec: PackedSpec):
    """The error-feedback twin of `pack_quantized_flat`: quantize
    `flat + residual` (`quantize.ef_quantize`) and return the new residual
    beside the wire pair -> (hi, lo, saturation, residual' float32[total]).
    The codes keep the [-qmax, qmax] alphabet, so the wire geometry and
    every later step are the plain path's. `saturation` counts the
    coefficients whose CARRIED value clipped."""
    step = _steps(spec)
    carried = flat.to(torch.float32) + residual.to(torch.float32)
    sat = quantize.saturation_count(carried, step, spec.bits)
    q, new_residual = quantize.ef_quantize(flat.to(torch.float32), residual, step, spec.bits)
    hi, lo = _interleave_codes(q, spec)
    return hi, lo, sat, new_residual


def pack_quantized_delta(params: dict, base_params: dict, spec: PackedSpec):
    """Quantize-and-pack one client's UPDATE (params - base_params)."""
    return pack_quantized_flat(flat_params(params) - flat_params(base_params), spec)


def pack_quantized_delta_ef(params: dict, base_params: dict, residual: torch.Tensor,
                            spec: PackedSpec):
    """Quantize-and-pack one client's UPDATE with error feedback: `residual`
    is its carried float32[total] quantization error -> (hi, lo, saturation,
    residual')."""
    return pack_quantized_flat_ef(flat_params(params) - flat_params(base_params), residual,
                                  spec)


def unpack_quantized(v, spec: PackedSpec, surviving: int) -> np.ndarray:
    """Packed-sum integers int64[n_ct, n] -> the dequantized AVERAGE update
    float32[total] (host numpy; exact field recovery, then one multiply).
    `surviving` is both the offset multiplier and the denominator."""
    fields = quantize.deinterleave_fields(np.asarray(v), spec.k, spec.field_bits, spec.guard)
    steps = step_vector(spec)
    if steps is not None:
        if surviving <= 0:
            raise ValueError("unpack_quantized: surviving must be positive")
        q_sum = fields.astype(np.int64).reshape(-1)[: spec.total] - (
            np.int64(surviving) * np.int64(spec.offset)
        )
        return (q_sum.astype(np.float64) * (steps.astype(np.float64) / surviving)).astype(
            np.float32
        )
    avg = quantize.decode_field_sums(fields, spec.step, spec.offset, surviving)
    return avg.reshape(-1)[: spec.total]
