"""Closed-form integer certificates of the packed and hybrid-HE uplinks.

Counterpart of `certify_packing` and `certify_transciphering` in
`hefl_tpu.analysis.ranges`. The JAX package proves these invariants by
interval analysis of a traced jaxpr of the aggregation's integer pipeline;
that pipeline is short and monotone (non-negative codes shifted into
disjoint fields, summed over C clients, plus bounded noise), so its exact
extreme values have a closed form, restated here:

    u   = q + qmax in [0, 2*qmax]                      per field, per client
    v   = sum_j u_j * 2**(guard + j*fbits)             packed per client
    E   = sum_c e_c, |e_c| <= 2**(guard_bits-1) - 1    decrypt noise
    T   = sum_c (v_c - 2**62 * gamma_c) + E            transciphered total
                                                       (gamma_c in {0, 1})

with fbits = b + ceil(log2 C) and guard = guard_bits + ceil(log2 C). Each
certificate checks its conditions at those extremes and, when one fails,
names it in `summary()`.
"""

from __future__ import annotations

import dataclasses
import functools

from hefl_tpu_torch.ckks import quantize


@dataclasses.dataclass(frozen=True)
class _Bounds:
    fbits: int
    guard: int
    field_sum: int       # max per-field C-client sum
    noise: int           # max |accumulated decrypt noise|
    packed_sum: int      # max C-client packed sum (without noise)


def _bounds(bits: int, k: int, clients: int, guard_bits: int) -> _Bounds:
    c = int(clients)
    fbits = quantize.field_bits(bits, c)
    guard = guard_bits + max(c - 1, 0).bit_length()
    umax = 2 * quantize.qmax(bits)
    per_client = sum(umax << (guard + j * fbits) for j in range(k))
    return _Bounds(
        fbits=fbits, guard=guard, field_sum=c * umax,
        noise=c * ((1 << max(guard_bits - 1, 0)) - 1), packed_sum=c * per_client,
    )


def _check(findings: list, checks: list, what: str, lo: int, hi: int,
           bound_lo: int, bound_hi: int) -> None:
    fact = f"{what} in [{lo}, {hi}]"
    if lo < bound_lo or hi > bound_hi:
        findings.append(f"{what}: reaches [{lo}, {hi}], outside [{bound_lo}, {bound_hi}]")
    else:
        checks.append(f"{fact} within [{bound_lo}, {bound_hi}]")


@dataclasses.dataclass(frozen=True)
class PackingCertificate:
    """Proof (or refutation) of one packed-aggregation geometry."""

    ok: bool
    modulus_bits: int
    bits: int
    k: int
    fbits: int
    guard: int
    clients: int
    ceiling_bits: int    # log2 of the binding wall: min(q/2, 2**62)
    findings: tuple      # violated conditions, empty when ok
    checks: tuple        # proven facts

    def summary(self) -> str:
        head = (f"packing b={self.bits} k={self.k} C={self.clients} (field "
                f"{self.fbits}b, guard {self.guard}b, wall 2**{self.ceiling_bits})")
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(self.findings)


@functools.lru_cache(maxsize=256)
def certify_packing(modulus: int, bits: int, k: int, clients: int,
                    guard_bits: int) -> PackingCertificate:
    """The carry-free headroom of one packing geometry, over all inputs:

      field sums <= 2**fbits - 1           (the C-client sum never carries)
      |noise sum| <= 2**(guard - 1) - 1    (decrypt noise stays in the guard)
      |packed total| < min(q/2, 2**62)     (centered decode, int64 exactness)
    """
    b = _bounds(bits, k, clients, guard_bits)
    ceiling = min(modulus // 2, 1 << quantize.MAX_PACKED_BITS)
    half_guard = 1 << max(b.guard - 1, 0)
    findings: list[str] = []
    checks: list[str] = []
    _check(findings, checks, f"per-field {clients}-client sum (carry-free)",
           0, b.field_sum, 0, (1 << b.fbits) - 1)
    _check(findings, checks, "accumulated decrypt noise (guard band)",
           -b.noise, b.noise, -(half_guard - 1), half_guard - 1)
    _check(findings, checks, "packed client-sum (q/2 & 2**62 wall)",
           -b.noise, b.packed_sum + b.noise, -(ceiling - 1), ceiling - 1)
    return PackingCertificate(
        ok=not findings, modulus_bits=modulus.bit_length(), bits=bits, k=k,
        fbits=b.fbits, guard=b.guard, clients=int(clients),
        ceiling_bits=ceiling.bit_length() - 1, findings=tuple(findings),
        checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class TranscipherCertificate:
    """Proof (or refutation) of one hybrid-HE transciphering geometry."""

    ok: bool
    modulus_bits: int
    bits: int
    k: int
    fbits: int
    guard: int
    clients: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (f"transciphering b={self.bits} k={self.k} C={self.clients} (field "
                f"{self.fbits}b, guard {self.guard}b, q/2 wall 2**{self.modulus_bits - 1})")
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(self.findings)


@functools.lru_cache(maxsize=256)
def certify_transciphering(modulus: int, bits: int, k: int, clients: int,
                           guard_bits: int) -> TranscipherCertificate:
    """The hybrid-HE invariants for one (q, bits, k, clients, guard) point,
    the four conditions of the JAX package's certificate:

      field sums <= 2**fbits - 1         (the keystream subtract is
                                          carry-free inside the guard band)
      |noise sum| <= 2**(guard-1) - 1    (decrypt noise stays in the guard)
      |T| < q/2                          (the centered CRT decode holds
                                          sum(v) - 2**62*Gamma + E exactly)
      sum(v) + E + 2**(guard-1) in [0, 2**62)
                                         (`hhe_center_mod`'s shifted
                                          mod-2**62 window recovers sum(v)+E)

    plus the keystream counter's word invariants, which hold at any round
    count by construction (the counter is taken mod 2**32 and both cipher
    words are masked below 2**31).
    """
    b = _bounds(bits, k, clients, guard_bits)
    half_q = modulus // 2
    half_guard = 1 << max(b.guard - 1, 0)
    domain = 1 << quantize.MAX_PACKED_BITS           # the stream cipher's modulus
    findings: list[str] = []
    checks: list[str] = []
    _check(findings, checks, f"per-field {clients}-client sum (carry-free)",
           0, b.field_sum, 0, (1 << b.fbits) - 1)
    _check(findings, checks, "accumulated decrypt noise (guard band)",
           -b.noise, b.noise, -(half_guard - 1), half_guard - 1)
    _check(findings, checks, "transciphered total (q/2 wall)",
           -int(clients) * domain - b.noise, b.packed_sum + b.noise,
           -(half_q - 1), half_q - 1)
    _check(findings, checks, "shifted recovery (mod-2**62 window)",
           half_guard - b.noise, b.packed_sum + b.noise + half_guard, 0, domain - 1)
    checks.append("round counter (mod 2**32) in [0, 2**32 - 1] at any round count")
    checks.append("cipher words hi, lo in [0, 2**31 - 1] at any round count")
    return TranscipherCertificate(
        ok=not findings, modulus_bits=modulus.bit_length(), bits=bits, k=k,
        fbits=b.fbits, guard=b.guard, clients=int(clients),
        findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class FoldCertificate:
    """Proof (or refutation) of the streaming fold's invariant at one prime
    (and, for a packed round, one packing geometry)."""

    ok: bool
    prime: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = f"online fold at p={self.prime}"
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(self.findings)


def certify_fold(prime: int, spec=None, modulus: int | None = None) -> FoldCertificate:
    """The closed-form counterpart of the JAX package's
    `certify_fold_inductive` (M15 ports its interval analysis): the
    `OnlineAccumulator` folds a canonical row into a canonical sum as
    (acc + row) mod p in int64, so the invariant "acc in [0, p - 1]" is
    closed under any number of folds iff p - 1 plus a canonical residue
    fits int64 (and the primes are positive). With a packed `spec` and the
    ciphertext modulus, the headroom-capped `spec.clients`-summand packed
    sum is certified by `certify_packing` at the spec's geometry."""
    prime = int(prime)
    findings: list[str] = []
    checks: list[str] = []
    _check(findings, checks, "prime", prime, prime, 2, (1 << 62) - 1)
    _check(findings, checks, "fold carrier (p - 1) + canonical residue",
           0, 2 * (prime - 1), 0, (1 << 63) - 1)
    if spec is not None and modulus is not None:
        guard_bits = spec.guard - max(spec.clients - 1, 0).bit_length()
        cert = certify_packing(int(modulus), spec.bits, spec.k, spec.clients, guard_bits)
        (checks if cert.ok else findings).append(cert.summary())
    return FoldCertificate(ok=not findings, prime=prime, findings=tuple(findings),
                           checks=tuple(checks))


# The arrival-count ceiling of the JAX package's inductive fold proof: its
# loop post-fixpoint is taken over any count in [0, 2**48].
LOOP_COUNT_CEILING = 1 << 48


@dataclasses.dataclass(frozen=True)
class FoldTreeCertificate:
    """Proof (or refutation) of the two-tier fold tree, with the fields and
    summary of the JAX package's `FoldCertificate`."""

    ok: bool
    prime_bits: int
    count_ceiling_bits: int
    bits: int | None     # packed leg (None: the tree certifies unpacked)
    k: int | None
    clients: int | None
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (f"fold-inductive p<2**{self.prime_bits} "
                f"arrivals<=2**{self.count_ceiling_bits}")
        if self.bits is not None:
            head += f" packed(b={self.bits} k={self.k} C={self.clients})"
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_fold_tree(prime: int) -> FoldTreeCertificate:
    """The closed-form counterpart of the JAX package's `certify_fold_tree`:
    the fold loop's invariant (`certify_fold`: acc in [0, p - 1] after every
    fold, the int64 carrier wrap-free, for any arrival count) plus the three
    facts the two-tier tree (`fl.hierarchy`) adds on top of it:

      * tier partials are canonical — each host fold ends in [0, p - 1],
        the canonical-input precondition of the root fold, so the root is
        one more instance of the same loop;
      * tree == flat bitwise — every fold is an exact canonical addition
        mod p, associative and commutative, so any bracketing and arrival
        order of the same uploads gives the same residues;
      * carried partials stay certified — a sealed tier partial folded at
        a later round's root is the same canonical residue, one more
        instance of the loop.

    An unsafe loop makes the tree unsafe (no tree claim on a broken
    invariant)."""
    base = certify_fold(int(prime))
    fields = dict(prime_bits=int(prime).bit_length(),
                  count_ceiling_bits=LOOP_COUNT_CEILING.bit_length() - 1,
                  bits=None, k=None, clients=None)
    if not base.ok:
        return FoldTreeCertificate(ok=False, findings=base.findings, checks=base.checks,
                                   **fields)
    checks = base.checks + (
        "tier partials canonical: each host fold ends in the loop "
        "post-fixpoint [0, p-1], satisfying the root fold's canonical-"
        "input precondition — the root is the same certified loop",
        "fold-tree = flat fold bitwise: exact canonical add mod p is "
        "associative+commutative, so any bracketing/arrival order of the "
        "same uploads yields identical residues",
        "carried partials certified: a sealed tier partial is a frozen "
        "canonical residue, so a stale tier fold at a later round's root "
        "is the same certified loop on the same value — late folding "
        "cannot leave the proven region",
    )
    return FoldTreeCertificate(ok=True, findings=(), checks=checks, **fields)
