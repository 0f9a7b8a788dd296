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


# --- Serving: the gadget key-switch and the rotate-and-sum ladder -----------
# The port's carriers: the plain versions compute in int64 (a Montgomery
# product's t + m*p must stay below 2**63); the kernels in 32-bit words
# (add_mod's a + b below 2**32) with 64-bit Montgomery products, and K6
# sums up to K = lazy_terms(p) raw products in 64 bits before one REDC,
# which is exact while the sum stays below p * 2**32.


def _lazy_terms(prime: int) -> int:
    """`cuda_ntt.lazy_terms` of one prime, restated (analysis imports no
    kernel module)."""
    return ((prime << 32) - 1) // max(prime - 1, 1) ** 2


def _gadget_checks(findings: list, checks: list, prime: int, digit_bits: int,
                   num_digits: int) -> None:
    """The facts every gadget key-switch (K5 and its plain version) rests on."""
    w, d = int(digit_bits), int(num_digits)
    canonical_hi = prime - 1
    _check(findings, checks, "gadget digits (base-2**w bound)", 0, (1 << w) - 1, 0, (1 << w) - 1)
    _check(findings, checks, "gadget covers every residue (p - 1 below 2**(w*d))",
           0, canonical_hi, 0, (1 << (w * d)) - 1)
    _check(findings, checks, "last digit's shift w*(d-1) (32-bit words)", 0, w * (d - 1), 0, 31)
    _check(findings, checks, "gadget digits canonical (the kernel's sub_mod precondition)",
           0, (1 << w) - 1, 0, canonical_hi)
    _check(findings, checks, "digit x key product (mul) inside the 2**62 wall",
           0, canonical_hi ** 2, 0, (1 << 62) - 1)
    _check(findings, checks, "Montgomery carrier t + m*p (int64 plain version)",
           0, canonical_hi ** 2 + ((1 << 32) - 1) * prime, 0, (1 << 63) - 1)
    _check(findings, checks, "accumulated c0 / c1 correction: add_mod of canonical terms "
           "(32-bit kernel words)", 0, 2 * canonical_hi, 0, (1 << 32) - 1)


@dataclasses.dataclass(frozen=True)
class KeyswitchCertificate:
    """Proof (or refutation) of one key-switch gadget geometry, with the
    fields and summary of the JAX package's certificate."""

    ok: bool
    prime_bits: int
    digit_bits: int
    num_digits: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (f"keyswitch gadget p<2**{self.prime_bits} "
                f"(w={self.digit_bits} d={self.num_digits})")
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_keyswitch(prime: int, digit_bits: int, num_digits: int) -> KeyswitchCertificate:
    """The closed-form counterpart of the JAX package's `certify_keyswitch`:
    for every canonical input, every base-2**w digit stays below 2**w and
    below the prime (the centring's sub_mod precondition), the gadget covers
    every residue, every digit x key product and Montgomery carrier stays
    inside its word (the 2**62 wall, int64 in the plain version, 32-bit
    add_mod words in the kernel), so the accumulated (c0, c1) correction is
    canonical."""
    prime = int(prime)
    findings: list[str] = []
    checks: list[str] = []
    _gadget_checks(findings, checks, prime, digit_bits, num_digits)
    if not findings:
        checks.append(f"digit x key products inside the 2**62 wall "
                      f"(w={digit_bits}, d={num_digits})")
    return KeyswitchCertificate(
        ok=not findings, prime_bits=prime.bit_length(), digit_bits=int(digit_bits),
        num_digits=int(num_digits), findings=tuple(findings), checks=tuple(checks),
    )


@dataclasses.dataclass(frozen=True)
class InferenceCertificate:
    """Proof (or refutation) of the serving programs' integer invariants,
    with the fields and summary of the JAX package's certificate."""

    ok: bool
    prime_bits: int
    digit_bits: int
    num_digits: int
    depth_ceiling_bits: int
    findings: tuple
    checks: tuple

    def summary(self) -> str:
        head = (f"inference ladder p<2**{self.prime_bits} "
                f"gadget(w={self.digit_bits} d={self.num_digits}) "
                f"depth<=2**{self.depth_ceiling_bits}")
        if self.ok:
            return f"{head}: CERTIFIED — " + "; ".join(self.checks)
        return f"{head}: UNSAFE — " + "; ".join(str(f) for f in self.findings)


@functools.lru_cache(maxsize=64)
def certify_inference(prime: int, digit_bits: int, num_digits: int) -> InferenceCertificate:
    """The closed-form counterpart of the JAX package's `certify_inference`
    over the three serving programs:

      * the rotate-and-sum ladder: a stage adds a canonical rotation (the
        signed automorphism of canonical residues, then a certified
        key-switch) to the canonical carry with add_mod, so by induction the
        carried (c0, c1) are canonical after any number of stages;
      * the hoisted sweep (K6): the UNCENTERED digits must be canonical as
        extracted (2**w - 1 <= p - 1), and each 64-bit lazy sum of up to
        K = lazy_terms(p) raw products stays below p * 2**32, so one REDC
        gives a canonical word at any step count;
      * the composed two-layer MLP: every Montgomery product, add_mod and
        sub_mod of canonical residues (the square, its relinearization, the
        rescale's subtract and multiply) returns a canonical residue.

    An uncertified key-switch gadget makes every program unsafe."""
    prime = int(prime)
    w = int(digit_bits)
    findings: list[str] = []
    checks: list[str] = []
    _gadget_checks(findings, checks, prime, digit_bits, num_digits)
    canonical = f"[0, {prime - 1}]"
    ladder_ok = not findings
    if ladder_ok:
        checks.append(f"carried c0 residues (any ladder depth) in {canonical}")
        checks.append(f"carried c1 residues (any ladder depth) in {canonical}")
        checks.append(f"gadget digit x key products inside the 2**62 wall "
                      f"(w={digit_bits}, d={num_digits})")
    terms = _lazy_terms(prime)
    _check(findings, checks, "hoisted sweep: uncentered gadget digits (shared across every step)",
           0, (1 << w) - 1, 0, prime - 1)
    _check(findings, checks, f"hoisted sweep: 64-bit lazy sum of K={max(terms, 1)} digit x key "
           "terms (one REDC)", 0, max(terms, 1) * (prime - 1) ** 2, 0, (prime << 32) - 1)
    if not findings:
        checks.append(f"hoisted sweep: hoisted c0 / c1 outputs (any step count) in {canonical}")
        checks.append("mlp compose: composed c0 / c1 residues (sweep -> square -> relin -> "
                      f"rescale -> sweep) in {canonical}")
    return InferenceCertificate(
        ok=not findings, prime_bits=prime.bit_length(), digit_bits=w,
        num_digits=int(num_digits), depth_ceiling_bits=LOOP_COUNT_CEILING.bit_length() - 1,
        findings=tuple(findings), checks=tuple(checks),
    )
