"""Encrypted-inference serving: the rotate-and-sum ladder and baby-step
giant-step (BSGS) scoring of slot-packed encrypted features.

Counterpart of `hefl_tpu.he_inference`. A server holding only the context,
the public key, Galois keys (and, for the MLP, a relin key) scores an
ENCRYPTED feature vector against its own plaintext model; the client
decrypts the scores.

The ladder (`LinearScorer`, `MlpScorer`, the serving reference): a slot-wise
product of the query with each class's weights (`ops.ct_mul_plain_poly`),
then log2(slots) rotate-and-add stages that leave every slot holding the
inner product, then the bias: K x log2(slots) key-switches per score. Each
stage rotates the previous stage's output, so no decomposition is shared:
per stage one K2 launch (c0 and c1), the automorphism gather, one K5 call on
the whole [..., K, L, N] batch, one K1 launch (the rotated c0) and two
add_mods. The MLP's hidden layer is the same ladder over its H units, the
square activation one ct_mul (K5 in its eval-input mode), and the output
layer a Montgomery contraction with eval-domain constants.

BSGS (`BsgsLinearScorer`, `BsgsMlpScorer`): the linear layer decomposed over
the model's generalized diagonals (Halevi-Shoup): all K class scores land in
ONE output ciphertext, at (baby - 1) + #giants key-switches per score. The
baby sweep shares one gadget decomposition (`ops.hoisted_digits`, one K1
launch) and runs every baby rotation as one K6 launch plus a permutation
gather; each giant rotation is one K5 call.

The JAX package's `jit` programs and `lax.scan` sweeps are Python loops
here. Keys come from `torch.Generator`s seeded by (seed, step), so they
differ from the JAX package's for the same seed; the tests hand the JAX
package's keys and ciphertexts to the port (`convert`) and compare the
output ciphertexts bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.profiler import record_function

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.ckks import encoding, galois, modular, ops
from hefl_tpu_torch.ckks.cuda_ntt import gadget_digits
from hefl_tpu_torch.ckks.keys import (
    CkksContext,
    GaloisKey,
    PublicKey,
    SecretKey,
    gen_galois_key,
    gen_relin_key,
    keygen,
)
from hefl_tpu_torch.ckks.ntt import ntt_forward, ntt_inverse, plain_tables, to_mont
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs.scopes import scoped

ROTATION_MODES = ("hoisted", "unhoisted", "legacy")


def rotation_steps(num_slots: int) -> list[int]:
    """Power-of-two left-rotation steps a full rotate-and-sum needs."""
    steps = []
    s = 1
    while s < num_slots:
        steps.append(s)
        s *= 2
    return steps


def _step_generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def gen_rotation_keys_for_steps(
    ctx: CkksContext, sk: SecretKey, seed: int, steps
) -> dict[int, GaloisKey]:
    """Galois keys for a set of left-rotation steps (the key bundle a BSGS
    server holds), on the secret key's device. Each key is drawn from a
    generator seeded by (seed, step), so the same (seed, step) always gives
    the same key whatever set it is generated in."""
    out = {}
    for step in sorted({int(s) for s in steps}):
        if step == 0:
            continue
        out[step] = gen_galois_key(
            ctx, sk, _step_generator(seed, step), galois.galois_elt_rotation(ctx.n, step)
        )
    return out


def _encrypt_slots(ctx: CkksContext, pk: PublicKey, z: np.ndarray, gen) -> Ciphertext:
    res = encoding.encode_slots(ctx.ntt, z, ctx.scale)
    m = torch.from_numpy(res.view(np.int32)).to(pk.b_mont.device)
    return ops.encrypt(ctx, pk, m, gen)


def encrypt_features(
    ctx: CkksContext, pk: PublicKey, x: np.ndarray, gen: torch.Generator
) -> Ciphertext:
    """Real feature vector [..., d] (d <= slots) -> slot-packed ciphertext,
    zero-padded, on the public key's device."""
    slots = encoding.num_slots(ctx.ntt)
    x = np.asarray(x, np.float64)
    if x.shape[-1] > slots:
        raise ValueError(f"{x.shape[-1]} features exceed {slots} slots")
    z = np.zeros(x.shape[:-1] + (slots,), np.float64)
    z[..., : x.shape[-1]] = x
    return _encrypt_slots(ctx, pk, z, gen)


def slice_secret_key(sk: SecretKey, num_primes: int) -> SecretKey:
    """Drop RNS limbs from sk to match a rescaled (shrunken) context."""
    return SecretKey(s_mont=sk.s_mont[:num_primes].contiguous())


# --- The rotate-and-sum ladder ------------------------------------------------


def gen_rotation_keys(ctx: CkksContext, sk: SecretKey, seed: int) -> dict[int, GaloisKey]:
    """Galois keys for every power-of-two rotation up to slots/2, the key
    bundle the ladder server holds (log2(slots) keys, never sk itself), on
    the secret key's device; each step's key is `gen_rotation_keys_for_steps`'s
    for the same (seed, step)."""
    return gen_rotation_keys_for_steps(ctx, sk, seed, rotation_steps(encoding.num_slots(ctx.ntt)))


def rotate_and_sum(ctx: CkksContext, ct: Ciphertext, gks: dict[int, GaloisKey]) -> Ciphertext:
    """Fold all slots into their total: after log2(slots) rotate+add stages
    every slot holds sum_j z_j (step by step through `ops.ct_rotate`; the
    serving path runs `rotate_and_sum_scan` over stacked tables)."""
    for step in rotation_steps(encoding.num_slots(ctx.ntt)):
        ct = ops.ct_add(ctx, ct, ops.ct_rotate(ctx, ct, gks[step], step))
    return ct


def stack_rotation_ladder(ctx: CkksContext, gks: dict[int, GaloisKey], device=None):
    """The ladder's stacked tables and keys: `stack_rotation_steps` at steps
    1, 2, 4, ..., slots/2."""
    return stack_rotation_steps(ctx, gks, rotation_steps(encoding.num_slots(ctx.ntt)), device)


def ladder_stage_forward_ntts(ctx: CkksContext) -> int:
    """Forward [L, N] transforms one ladder stage pays: L*d gadget-digit
    transforms inside the K5 call plus the rotated c0's. Each stage rotates
    the previous stage's output, so there is no shared input whose
    decomposition could be hoisted (the BSGS baby sweep is where that
    applies)."""
    return ctx.num_primes * ctx.ksk_num_digits + 1


def rotate_and_sum_scan(ctx: CkksContext, ct: Ciphertext, ladder) -> Ciphertext:
    """`rotate_and_sum` over the stacked `ladder` (src, flip, b_mont,
    a_mont), any leading batch shape on `ct`. Per stage: one inverse-NTT
    launch (K2) on c0 and c1 together, the automorphism gather, one K5 call
    on the rotated c1, one K1 launch on the rotated c0, two add_mods; the
    same arithmetic as `rotate_and_sum`, so the same words. One
    serve_rotate range holds the whole ladder, its K5 calls included: the
    stages run one after another, and a serve_keyswitch range a stage cost
    ~4 % of a score's host time on the H100's host."""
    ntt = ctx.ntt
    p = plain_tables(ntt, ct.c0.device).p
    i64 = lambda t: t.to(torch.int64)  # noqa: E731
    src, flip, b_mont, a_mont = ladder
    c0, c1 = ct.c0, ct.c1
    with record_function(scopes.SERVE_ROTATE):
        for i in range(src.shape[0]):
            cc = ntt_inverse(ntt, torch.stack([c0, c1]))
            pc0 = galois.apply_automorphism(cc[0], p, src[i], flip[i])
            pc1 = galois.apply_automorphism(cc[1], p, src[i], flip[i])
            k0, k1 = ops._keyswitch_coeff(ctx, pc1, b_mont[i], a_mont[i])
            rot0 = modular.add_mod(i64(ntt_forward(ntt, pc0)), i64(k0), p)
            c0 = modular.add_mod(i64(c0), rot0, p).to(torch.int32)
            c1 = modular.add_mod(i64(c1), i64(k1), p).to(torch.int32)
    return Ciphertext(c0=c0, c1=c1, scale=ct.scale)


def _linear_apply(ctx: CkksContext, pt_scale: float, ct_x: Ciphertext, w_res, b_res,
                  ladder) -> Ciphertext:
    """Score encrypted samples (any leading batch shape) against all K
    classes: the ct x plaintext product broadcast over a new K axis, ONE
    ladder over the whole [..., K, L, N] block, the bias."""
    with record_function(scopes.SERVE_SCORE):
        ct = ops.ct_mul_plain_poly(
            ctx, Ciphertext(c0=ct_x.c0[..., None, :, :], c1=ct_x.c1[..., None, :, :],
                            scale=ct_x.scale), w_res, pt_scale)
    ct = rotate_and_sum_scan(ctx, ct, ladder)
    with record_function(scopes.SERVE_SCORE):
        return ops.ct_add_plain(ctx, ct, b_res)


def _encode_linear_model(ctx: CkksContext, weights: np.ndarray, bias: np.ndarray,
                         ct_scale: float, pt_scale: float, device):
    """Check and slot-encode a linear model (weights [K, d <= slots], bias
    [K]) for ciphertexts of scale `ct_scale` -> (w_res, b_res) int32
    [K, L, N] coefficient-domain residues on `device`."""
    slots = encoding.num_slots(ctx.ntt)
    weights = np.asarray(weights, np.float64)
    bias = np.asarray(bias, np.float64)
    if weights.ndim != 2 or weights.shape[1] > slots:
        raise ValueError(f"weights must be [K, d<= {slots}], got {weights.shape}")
    if bias.shape != (weights.shape[0],):
        raise ValueError(f"bias must be [{weights.shape[0]}], got {bias.shape}")
    wz = np.zeros((weights.shape[0], slots), np.float64)
    wz[:, : weights.shape[1]] = weights
    w_res = encoding.encode_slots(ctx.ntt, wz, pt_scale)
    b_res = np.stack([encoding.encode_slots_const(ctx.ntt, float(b), ct_scale * pt_scale)
                      for b in bias])
    return tuple(torch.from_numpy(r.view(np.int32)).to(device) for r in (w_res, b_res))


def _check_scale(scorer, ct: Ciphertext) -> None:
    if ct.scale != scorer.ct_scale:
        raise ValueError(f"scorer was built for ct scale {scorer.ct_scale}, got {ct.scale}")


def _split_classes(batched: Ciphertext) -> list[Ciphertext]:
    return [Ciphertext(c0=batched.c0[k], c1=batched.c1[k], scale=batched.scale)
            for k in range(batched.c0.shape[0])]


class LinearScorer:
    """Private-inference server for a FIXED linear model on the ladder, the
    serving reference the BSGS plan is held to. The weights and bias are
    slot-encoded and the ladder's tables and keys stacked once here, on
    `device` (CUDA unless given); `score_batched` returns the K class scores
    as one [K, L, N] ciphertext, each score in every slot."""

    def __init__(self, ctx: CkksContext, weights: np.ndarray, bias: np.ndarray,
                 gks: dict[int, GaloisKey], pt_scale: float = 2.0**14,
                 ct_scale: float | None = None, device=None):
        self.device = resolve_device(device)
        self.ctx = ctx
        self.pt_scale = pt_scale
        self.ct_scale = ctx.scale if ct_scale is None else ct_scale
        # Only the stacked ladder is kept: the gks dict would be a second
        # copy of the key material for the scorer's lifetime.
        self._ladder = stack_rotation_ladder(ctx, gks, self.device)
        self.num_classes = int(np.asarray(weights).shape[0])
        self._w_res, self._b_res = _encode_linear_model(
            ctx, weights, bias, self.ct_scale, pt_scale, self.device)

    def score_batched(self, ct_x: Ciphertext) -> Ciphertext:
        """K class scores as ONE batched ciphertext (leading axis K)."""
        _check_scale(self, ct_x)
        return _linear_apply(self.ctx, self.pt_scale, ct_x, self._w_res, self._b_res,
                             self._ladder)

    def score(self, ct_x: Ciphertext) -> list[Ciphertext]:
        return _split_classes(self.score_batched(ct_x))

    def score_many(self, ct_xs: Ciphertext) -> Ciphertext:
        """Score a batch [B, L, N] -> [B, K] batched score ciphertext, one
        ladder over all B*K rows; decrypt with `decrypt_score_matrix`."""
        _check_scale(self, ct_xs)
        _check_batched(ct_xs)
        return _linear_apply(self.ctx, self.pt_scale, ct_xs, self._w_res, self._b_res,
                             self._ladder)


def encrypted_linear(ctx: CkksContext, ct_x: Ciphertext, weights: np.ndarray,
                     bias: np.ndarray, gks: dict[int, GaloisKey], pt_scale: float = 2.0**14,
                     device=None) -> list[Ciphertext]:
    """scores[k] = <x, weights[k]> + bias[k] under encryption -> K
    ciphertexts, each holding its score in every slot at scale
    ct_x.scale * pt_scale. One-shot `LinearScorer`, on the query's device
    unless `device` is given."""
    device = ct_x.c0.device if device is None else device
    return LinearScorer(ctx, weights, bias, gks, pt_scale, ct_scale=ct_x.scale,
                        device=device).score(ct_x)


def decrypt_scores(ctx: CkksContext, sk: SecretKey, cts: list[Ciphertext]) -> np.ndarray:
    """Owner-side: decrypt each class ciphertext, read slot 0 -> scores [K].
    After rescales, `sk` is `slice_secret_key(sk, ctx.num_primes)`."""
    return np.asarray([float(decrypt_score_matrix(ctx, sk, ct)) for ct in cts])


def decrypt_score_matrix(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> np.ndarray:
    """Owner-side: a batched ladder score ciphertext (any leading axes, e.g.
    [B, K] from `score_many`) -> its real scores (slot 0 of each), in one
    decrypt."""
    return decrypt_class_scores(ctx, sk, ct, 1)[..., 0]


@dataclasses.dataclass(frozen=True)
class BsgsPlan:
    """A baby-step giant-step rotation plan for one scoring geometry.

    y = sum_t u_t (.) rot(x, t) over the generalized diagonals
    u_t[m] = W_pad[m, (m+t) mod slots], t' = i*baby + j in the window
    [t_lo, t_hi]: `baby` rotations of the query plus one rotation per
    giant group. `giants` groups block indices by their step i*baby mod
    slots, the identity (step 0) group first."""

    slots: int
    d: int
    num_classes: int
    baby: int
    t_lo: int
    t_hi: int
    giants: tuple[tuple[int, ...], ...]
    baby_steps: tuple[int, ...]
    giant_steps: tuple[int, ...]

    @property
    def num_keyswitches(self) -> int:
        """Key-switches one score costs under this plan."""
        return len(self.baby_steps) + len(self.giant_steps)

    @property
    def rotation_steps_needed(self) -> tuple[int, ...]:
        """The Galois-key bundle the serving server must hold."""
        return tuple(sorted(set(self.baby_steps) | set(self.giant_steps)))

    def forward_ntts(self, gadget_rows: int, hoisted: bool) -> int:
        """Forward [L, N] transforms one score pays in the rotation sweeps."""
        per_rot = gadget_rows + 1
        giant = len(self.giant_steps) * per_rot
        if hoisted:
            return gadget_rows + giant
        return len(self.baby_steps) * per_rot + giant


def ladder_keyswitches(slots: int, num_classes: int) -> int:
    """Key-switches one score costs under the per-class rotate-and-sum ladder."""
    return num_classes * len(rotation_steps(slots))


def bsgs_plan(slots: int, d: int, num_classes: int, baby: int | None = None) -> BsgsPlan:
    """Plan the BSGS sweep for (slots, d features, K classes); the default
    block size is round(sqrt(d + K - 1))."""
    if not 1 <= d <= slots:
        raise ValueError(f"need 1 <= d <= {slots} features, got {d}")
    if not 1 <= num_classes <= slots:
        raise ValueError(f"need 1 <= num_classes <= {slots}, got {num_classes}")
    t_lo = -(num_classes - 1)
    # Each residue class mod `slots` appears at most once in the window.
    t_hi = min(d - 1, t_lo + slots - 1)
    n_diag = t_hi - t_lo + 1
    b = int(baby) if baby else max(1, round(math.sqrt(n_diag)))
    by_step: dict[int, list[int]] = {}
    for i in range(t_lo // b, t_hi // b + 1):
        by_step.setdefault((i * b) % slots, []).append(i)
    steps = [0] + sorted(s for s in by_step if s != 0)
    return BsgsPlan(
        slots=int(slots), d=int(d), num_classes=int(num_classes), baby=b,
        t_lo=t_lo, t_hi=t_hi,
        giants=tuple(tuple(by_step[s]) for s in steps),
        baby_steps=tuple(range(1, b)),
        giant_steps=tuple(steps[1:]),
    )


def stack_rotation_steps(ctx: CkksContext, gks: dict[int, GaloisKey], steps, device=None):
    """Per-step automorphism tables and Galois keys for a step sequence ->
    (src int64[S, N], flip bool[S, N], b_mont int32[S, C, L, N], a_mont
    likewise), on `device` (default: the keys' device). All key/step
    checks happen here, once per scorer."""
    steps = [int(s) for s in steps]
    if not steps:
        dev = torch.device(device or "cpu")
        num_c = ctx.num_primes * ctx.ksk_num_digits + 1
        zk = torch.zeros((0, num_c, ctx.num_primes, ctx.n), dtype=torch.int32, device=dev)
        return (torch.zeros((0, ctx.n), dtype=torch.int64, device=dev),
                torch.zeros((0, ctx.n), dtype=torch.bool, device=dev), zk, zk)
    missing = [s for s in steps if s not in gks]
    if missing:
        raise ValueError(f"rotation keys missing for steps {missing}")
    dev = torch.device(device or gks[steps[0]].b_mont.device)
    srcs, flips = [], []
    for s in steps:
        want = galois.galois_elt_rotation(ctx.n, s)
        if gks[s].g != want:
            raise ValueError(f"galois key for step {s} has g={gks[s].g}, rotation needs g={want}")
        src, flip = galois.automorphism_tables(ctx.n, want)
        srcs.append(src)
        flips.append(flip)
    return (
        torch.from_numpy(np.stack(srcs).astype(np.int64)).to(dev),
        torch.from_numpy(np.stack(flips)).to(dev),
        torch.stack([gks[s].b_mont.to(dev) for s in steps]),
        torch.stack([gks[s].a_mont.to(dev) for s in steps]),
    )


def _bsgs_diag_tables(
    ctx: CkksContext, plan: BsgsPlan, weights: np.ndarray, pt_scale: float,
    queries_per_ct: int, device,
) -> torch.Tensor:
    """The pre-rotated generalized diagonals v_{i,j} = rot(u_{i*b+j}, -i*b),
    slot-encoded at pt_scale, in eval-domain Montgomery form ->
    int32[G, baby, L, N]. With queries_per_ct = q > 1 the diagonals are the
    D-periodic tiling (D = slots/q) of the single block's."""
    s, b, num_k, d = plan.slots, plan.baby, plan.num_classes, plan.d
    q = int(queries_per_ct)
    block = s // q
    weights = np.asarray(weights, np.float64)
    vecs = np.zeros((len(plan.giants), b, s))
    rows = np.arange(num_k)
    for g_idx, group in enumerate(plan.giants):
        for i in group:
            for j in range(b):
                t = i * b + j
                if t < plan.t_lo or t > plan.t_hi:
                    continue
                if q == 1:
                    cols = (rows + t) % s
                    sel = cols < d
                    u = np.zeros(s)
                    u[rows[sel]] = weights[rows[sel], cols[sel]]
                else:
                    cols = rows + t
                    sel = (cols >= 0) & (cols < d)
                    blk = np.zeros(block)
                    blk[rows[sel]] = weights[rows[sel], cols[sel]]
                    u = np.tile(blk, q)
                vecs[g_idx, j] += np.roll(u, i * b)
    res = encoding.encode_slots(ctx.ntt, vecs, pt_scale)
    m = torch.from_numpy(res.view(np.int32)).to(device)
    return to_mont(ctx.ntt, ntt_forward(ctx.ntt, m))


def _bsgs_apply(
    ctx: CkksContext, plan: BsgsPlan, pt_scale: float, ct_x: Ciphertext,
    u_mont, b_res, baby_tables, giant_tables, mode: str = "hoisted",
) -> Ciphertext:
    """The BSGS scoring program (any leading batch shape on ct_x): the baby
    rotations of the query, the modular contraction of the diagonals
    against them, the giant rotate-and-accumulate, the bias.

    `mode` picks the baby sweep: "hoisted" shares ONE uncentered gadget
    decomposition (K1) and serves every step with one K6 launch and a
    permutation; "unhoisted" applies the same decomposition step by step
    (bitwise equal to "hoisted"); "legacy" runs a centered-digit `rotate`
    (one K5 call) per step, equal only after decryption. Giant rotations act
    on distinct partial sums: one K5 call each, in every mode."""
    ntt = ctx.ntt
    tabs = plain_tables(ntt, ct_x.c0.device)
    p, pinv = tabs.p, tabs.pinv_neg
    i64 = lambda t: t.to(torch.int64)  # noqa: E731

    def rotate_all(pairs, src, flip, b_mont, a_mont):
        """Rotations of COEFFICIENT-domain pairs [(c0, c1)], pair i by step i
        of the tables -> [(r0, r1)] in the eval domain (int64), inside the
        caller's serve_rotate range. The pairs are independent, so each
        stage runs over all of them in turn (the same launches and words as
        pair by pair) and one serve_keyswitch range holds every K5 call."""
        rot = [(galois.apply_automorphism(c0, p, src[i], flip[i]),
                galois.apply_automorphism(c1, p, src[i], flip[i]))
               for i, (c0, c1) in enumerate(pairs)]
        with record_function(scopes.SERVE_KEYSWITCH):
            ks = [ops._keyswitch_coeff(ctx, pc1, b_mont[i], a_mont[i])
                  for i, (_, pc1) in enumerate(rot)]
        return [(modular.add_mod(i64(ntt_forward(ntt, pc0)), i64(k0), p), i64(k1))
                for (pc0, _), (k0, k1) in zip(rot, ks)]

    if not plan.baby_steps:
        rots0, rots1 = ct_x.c0[None], ct_x.c1[None]
    elif mode == "hoisted":
        with record_function(scopes.SERVE_ROTATE):
            cc1 = ntt_inverse(ntt, ct_x.c1)
        with record_function(scopes.SERVE_HOIST):
            d_eval = ops.hoisted_digits(ctx, cc1)
            r0, r1 = ops.hoisted_rotations_core(ctx, ct_x.c0, d_eval, *baby_tables)
        rots0, rots1 = torch.cat([ct_x.c0[None], r0]), torch.cat([ct_x.c1[None], r1])
    else:
        with record_function(scopes.SERVE_ROTATE):
            cc = ntt_inverse(ntt, torch.stack([ct_x.c0, ct_x.c1]))
            cc0, cc1 = cc[0], cc[1]
            src, flip, bks, aks = baby_tables
            num_r = ctx.num_primes * ctx.ksk_num_digits
            if mode == "unhoisted":
                lifted = gadget_digits(cc1, ctx.ksk_digit_bits,
                                       ctx.ksk_num_digits).to(torch.int32)
                rots = []
                for i in range(len(plan.baby_steps)):
                    with record_function(scopes.SERVE_HOIST):
                        d_eval = ntt_forward(
                            ntt, galois.apply_automorphism(lifted, p, src[i], flip[i]))
                        pc0 = ntt_forward(ntt, galois.apply_automorphism(cc0, p, src[i], flip[i]))
                        rots.append(ops.step_key_products(ctx, pc0, d_eval, bks[i][:num_r],
                                                          aks[i][:num_r]))
            else:
                rots = rotate_all([(cc0, cc1)] * len(plan.baby_steps), src, flip, bks, aks)
            rots0 = torch.stack([ct_x.c0] + [r0.to(torch.int32) for r0, _ in rots])
            rots1 = torch.stack([ct_x.c1] + [r1.to(torch.int32) for _, r1 in rots])

    # Giant partial sums: s[g] = sum_j rots[j] * u[g, j] mod p (canonical
    # products summed exactly in int64, then reduced: the same residue as
    # the JAX package's add_mod chain).
    batch_ndim = ct_x.c0.dim() - 2
    g_count = len(plan.giants)
    u = i64(u_mont).reshape((g_count, u_mont.shape[1]) + (1,) * batch_ndim + tuple(u_mont.shape[2:]))
    with record_function(scopes.SERVE_SCORE):
        s0 = modular.mont_mul(i64(rots0)[None], u, p, pinv).sum(dim=1) % p
        s1 = modular.mont_mul(i64(rots1)[None], u, p, pinv).sum(dim=1) % p

    # Giant sweep: the identity group seeds the accumulator; every other
    # group rotates by its step (one K2 launch for both components, one K5).
    y0, y1 = s0[0], s1[0]
    with record_function(scopes.SERVE_ROTATE):
        gcs = [ntt_inverse(ntt, torch.stack([s0[gi + 1], s1[gi + 1]]).to(torch.int32))
               for gi in range(len(plan.giant_steps))]
        for rr0, rr1 in rotate_all([(gc[0], gc[1]) for gc in gcs], *giant_tables):
            y0 = modular.add_mod(y0, rr0, p)
            y1 = modular.add_mod(y1, rr1, p)

    out = Ciphertext(c0=y0.to(torch.int32), c1=y1.to(torch.int32), scale=ct_x.scale * pt_scale)
    with record_function(scopes.SERVE_SCORE):
        return ops.ct_add_plain(ctx, out, b_res)


def serving_batch_bucket(batch: int) -> int:
    """Next power-of-two batch bucket `score_many` pads query batches to."""
    return 1 << max(0, (int(batch) - 1).bit_length())


def _baby_giant_tables(ctx, plan, gks, mode, device):
    if mode == "hoisted":
        baby = ops.hoisted_rotation_tables(ctx, gks, plan.baby_steps, device)
    else:
        baby = stack_rotation_steps(ctx, gks, plan.baby_steps, device)
    return baby, stack_rotation_steps(ctx, gks, plan.giant_steps, device)


def _check_mode(mode: str) -> None:
    if mode not in ROTATION_MODES:
        raise ValueError(f"rotation_mode must be hoisted|unhoisted|legacy, got {mode!r}")


def _pad_to_bucket(ct: Ciphertext) -> Ciphertext:
    batch = ct.c0.shape[0]
    extra = serving_batch_bucket(batch) - batch
    if not extra:
        return ct
    pad = lambda t: torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])  # noqa: E731
    return Ciphertext(c0=pad(ct.c0), c1=pad(ct.c1), scale=ct.scale)


def _check_batched(ct: Ciphertext) -> None:
    if ct.c0.dim() != 3:
        raise ValueError(
            f"score_many needs a batched ciphertext [B, L, N], got limbs of shape "
            f"{tuple(ct.c0.shape)}; use score() for a single sample"
        )


class BsgsLinearScorer:
    """BSGS private-inference server for a FIXED linear model: scores[k] =
    <x, W[k]> + b[k] for all K classes in one output ciphertext (slot m =
    class m; decrypt with `decrypt_class_scores`).

    Everything per model is built once here, on `device` (CUDA unless
    given): the plan, the per-step tables and Galois keys, the pre-rotated
    diagonal encodings and the bias. `queries_per_ct` = q > 1 packs q
    queries into one ciphertext (`encrypt_query_block`); `rotation_mode`
    picks the baby sweep (see `_bsgs_apply`)."""

    def __init__(
        self,
        ctx: CkksContext,
        weights: np.ndarray,
        bias: np.ndarray,
        gks: dict[int, GaloisKey],
        pt_scale: float = 2.0**14,
        ct_scale: float | None = None,
        baby: int | None = None,
        queries_per_ct: int = 1,
        rotation_mode: str = "hoisted",
        device=None,
    ):
        _check_mode(rotation_mode)
        weights = np.asarray(weights, np.float64)
        bias = np.asarray(bias, np.float64)
        slots = encoding.num_slots(ctx.ntt)
        q = int(queries_per_ct)
        if q < 1 or slots % q != 0:
            raise ValueError(f"queries_per_ct must divide slots={slots}, got {q}")
        block = slots // q
        if weights.ndim != 2 or weights.shape[1] > block:
            raise ValueError(
                f"weights must be [K, d<= {block}] (slots/queries_per_ct), got {weights.shape}"
            )
        if bias.shape != (weights.shape[0],):
            raise ValueError(f"bias must be [{weights.shape[0]}], got {bias.shape}")
        if weights.shape[0] > block:
            raise ValueError(f"{weights.shape[0]} classes exceed the {block}-slot query block")
        self.device = resolve_device(device)
        self.ctx = ctx
        self.pt_scale = pt_scale
        self.ct_scale = ctx.scale if ct_scale is None else ct_scale
        self.queries_per_ct = q
        self.rotation_mode = rotation_mode
        self.num_classes, d = weights.shape
        self.plan = bsgs_plan(slots, d, self.num_classes, baby)
        self._baby_tables, self._giant_tables = _baby_giant_tables(
            ctx, self.plan, gks, rotation_mode, self.device
        )
        rows = ctx.num_primes * ctx.ksk_num_digits
        self.gadget_rows = rows
        self.hoisted_ntts = self.plan.forward_ntts(rows, hoisted=True)
        self.unhoisted_ntts = self.plan.forward_ntts(rows, hoisted=False)
        self._u_mont = _bsgs_diag_tables(ctx, self.plan, weights, pt_scale, q, self.device)
        bz = np.zeros(slots)
        bz.reshape(q, block)[:, : self.num_classes] = bias
        b_res = encoding.encode_slots(ctx.ntt, bz, self.ct_scale * pt_scale)
        self._b_res = torch.from_numpy(b_res.view(np.int32)).to(self.device)

    def _run(self, ct: Ciphertext) -> Ciphertext:
        return _bsgs_apply(
            self.ctx, self.plan, self.pt_scale, ct, self._u_mont, self._b_res,
            self._baby_tables, self._giant_tables, self.rotation_mode,
        )

    def score(self, ct_x: Ciphertext) -> Ciphertext:
        """All K class scores of one sample [L, N] as ONE ciphertext."""
        _check_scale(self, ct_x)
        if ct_x.c0.dim() != 2:
            raise ValueError(
                f"score takes one sample [L, N], got {tuple(ct_x.c0.shape)}; "
                "use score_many for a batch"
            )
        return self._run(ct_x)

    def score_many(self, ct_xs: Ciphertext) -> Ciphertext:
        """Score a batch [B, L, N] -> [B] score ciphertexts. The batch is
        padded with zero ciphertexts to the next power of two
        (`serving_batch_bucket`) and the padding sliced away."""
        _check_scale(self, ct_xs)
        _check_batched(ct_xs)
        batch = ct_xs.c0.shape[0]
        out = self._run(_pad_to_bucket(ct_xs))
        return Ciphertext(c0=out.c0[:batch], c1=out.c1[:batch], scale=out.scale)


def encrypt_query_block(
    ctx: CkksContext, pk: PublicKey, xs: np.ndarray, gen: torch.Generator,
    queries_per_ct: int,
) -> Ciphertext:
    """Client-side slot packing: feature vectors [..., q, d] -> one
    ciphertext per leading index, query r in slots [r*D, r*D + d) with
    D = slots/q; short batches zero-pad."""
    slots = encoding.num_slots(ctx.ntt)
    q = int(queries_per_ct)
    if q < 1 or slots % q != 0:
        raise ValueError(f"queries_per_ct must divide slots={slots}, got {q}")
    block = slots // q
    xs = np.asarray(xs, np.float64)
    if xs.ndim < 2 or xs.shape[-2] > q or xs.shape[-1] > block:
        raise ValueError(f"query block must be [..., <= {q}, <= {block}], got {xs.shape}")
    z = np.zeros(xs.shape[:-2] + (q, block), np.float64)
    z[..., : xs.shape[-2], : xs.shape[-1]] = xs
    return _encrypt_slots(ctx, pk, z.reshape(xs.shape[:-2] + (slots,)), gen)


def decrypt_class_scores(
    ctx: CkksContext, sk: SecretKey, ct: Ciphertext, num_classes: int,
    queries_per_ct: int = 1,
) -> np.ndarray:
    """Owner-side decrypt of a BSGS score ciphertext (any leading axes):
    slots 0..K-1 -> real scores [..., K]; with q > 1 each D-slot block holds
    one query's scores -> [..., q, K]."""
    res = ops.decrypt(ctx, sk, ct).cpu().contiguous().numpy().view(np.uint32)
    z = encoding.decode_slots(ctx.ntt, res, ct.scale)
    q = int(queries_per_ct)
    if q == 1:
        return np.real(z[..., :num_classes])
    z = z.reshape(z.shape[:-1] + (q, z.shape[-1] // q))
    return np.real(z[..., :num_classes])


# --- The depth-2 MLP as two composed BSGS plans ------------------------------
# Layer 1 lands all H hidden pre-activations in slots 0..H-1 of one
# ciphertext (zeros above), the square activation is one ct_mul + relin,
# and after `rescales` rescales layer 2 reads those slots as its features.


def _sliced_context(ctx: CkksContext) -> CkksContext:
    """The context `ops.rescale` returns: one limb fewer."""
    return CkksContext(
        ntt=ctx.ntt.slice_limbs(0, ctx.num_primes - 1),
        scale=ctx.scale,
        sigma=ctx.sigma,
        ksk_digit_bits=ctx.ksk_digit_bits,
    )


def mlp_sub_context(ctx: CkksContext, rescales: int) -> CkksContext:
    """The post-rescale context a depth-2 MLP ends at (layer 2's keys and
    tables are built against it)."""
    cur = ctx
    for _ in range(int(rescales)):
        cur = _sliced_context(cur)
    return cur


def bsgs_mlp_plans(
    slots: int, d: int, hidden: int, num_classes: int,
    baby1: int | None = None, baby2: int | None = None,
) -> tuple[BsgsPlan, BsgsPlan]:
    """The two composed plans: (d -> hidden) at full level, (hidden ->
    num_classes) after the rescales."""
    return bsgs_plan(slots, d, hidden, baby1), bsgs_plan(slots, hidden, num_classes, baby2)


class BsgsMlpScorer:
    """Depth-2 MLP server on composed BSGS plans:
    scores = W2 . (W1 x + b1)^2 + b2. `gks1` on `ctx` covers plan1's steps,
    `gks2` on `mlp_sub_context(ctx, rescales)` (generated under
    `slice_secret_key(sk, sub_ctx.num_primes)`) covers plan2's. Decrypt with
    `decrypt_class_scores(self.sub_ctx, sliced_sk, out, K)`."""

    def __init__(
        self,
        ctx: CkksContext,
        w1: np.ndarray,
        b1: np.ndarray,
        w2: np.ndarray,
        b2: np.ndarray,
        gks1: dict[int, GaloisKey],
        rlk,
        gks2: dict[int, GaloisKey],
        pt_scale: float = 2.0**14,
        rescales: int = 2,
        ct_scale: float | None = None,
        baby1: int | None = None,
        baby2: int | None = None,
        rotation_mode: str = "hoisted",
        device=None,
    ):
        _check_mode(rotation_mode)
        w1 = np.asarray(w1, np.float64)
        b1 = np.asarray(b1, np.float64)
        w2 = np.asarray(w2, np.float64)
        b2 = np.asarray(b2, np.float64)
        slots = encoding.num_slots(ctx.ntt)
        if w1.ndim != 2 or w1.shape[1] > slots:
            raise ValueError(f"w1 must be [H, d<= {slots}], got {w1.shape}")
        if b1.shape != (w1.shape[0],):
            raise ValueError(f"b1 must be [{w1.shape[0]}], got {b1.shape}")
        if w2.ndim != 2 or w2.shape[1] != w1.shape[0]:
            raise ValueError(f"w2 must be [K, {w1.shape[0]}], got {w2.shape}")
        if b2.shape != (w2.shape[0],):
            raise ValueError(f"b2 must be [{w2.shape[0]}], got {b2.shape}")
        hidden = int(w1.shape[0])
        if hidden > slots:
            raise ValueError(f"{hidden} hidden units exceed {slots} slots")
        self.device = resolve_device(device)
        self.ctx = ctx
        self.pt_scale = pt_scale
        self.ct_scale = ctx.scale if ct_scale is None else ct_scale
        self.rotation_mode = rotation_mode
        self.num_classes = int(w2.shape[0])
        self._rescales = int(rescales)
        self.plan1, self.plan2 = bsgs_mlp_plans(
            slots, w1.shape[1], hidden, self.num_classes, baby1, baby2
        )
        self.rlk = dataclasses.replace(
            rlk, b_mont=rlk.b_mont.to(self.device), a_mont=rlk.a_mont.to(self.device)
        )
        self.sub_ctx = mlp_sub_context(ctx, rescales)
        h_scale = self.ct_scale * pt_scale
        sq_scale = h_scale * h_scale
        p_np = np.asarray(ctx.ntt.p)[:, 0]
        for i in range(self._rescales):
            sq_scale /= float(p_np[ctx.num_primes - 1 - i])
        self.sq_scale = sq_scale
        self._baby1, self._giant1 = _baby_giant_tables(
            ctx, self.plan1, gks1, rotation_mode, self.device)
        self._baby2, self._giant2 = _baby_giant_tables(
            self.sub_ctx, self.plan2, gks2, rotation_mode, self.device)
        self._u1 = _bsgs_diag_tables(ctx, self.plan1, w1, pt_scale, 1, self.device)
        self._u2 = _bsgs_diag_tables(self.sub_ctx, self.plan2, w2, pt_scale, 1, self.device)
        bz1 = np.zeros(slots)
        bz1[:hidden] = b1
        bz2 = np.zeros(slots)
        bz2[: self.num_classes] = b2
        enc = lambda c, z, s: torch.from_numpy(  # noqa: E731
            encoding.encode_slots(c.ntt, z, s).view(np.int32)).to(self.device)
        self._b1_res = enc(ctx, bz1, h_scale)
        self._b2_res = enc(self.sub_ctx, bz2, sq_scale * pt_scale)
        rows1 = ctx.num_primes * ctx.ksk_num_digits
        rows2 = self.sub_ctx.num_primes * self.sub_ctx.ksk_num_digits
        self.hoisted_ntts = (self.plan1.forward_ntts(rows1, True)
                             + self.plan2.forward_ntts(rows2, True))
        self.unhoisted_ntts = (self.plan1.forward_ntts(rows1, False)
                               + self.plan2.forward_ntts(rows2, False))

    @property
    def num_keyswitches(self) -> int:
        """Key-switches per score: both plans' sweeps + the relinearization."""
        return self.plan1.num_keyswitches + self.plan2.num_keyswitches + 1

    def _run(self, ct_x: Ciphertext) -> Ciphertext:
        mode = self.rotation_mode
        h = _bsgs_apply(self.ctx, self.plan1, self.pt_scale, ct_x, self._u1, self._b1_res,
                        self._baby1, self._giant1, mode)
        with record_function(scopes.SERVE_SCORE):
            sq = ops.ct_mul(self.ctx, h, h, self.rlk)
            cur = self.ctx
            for _ in range(self._rescales):
                cur, sq = ops.rescale(cur, sq)
        return _bsgs_apply(cur, self.plan2, self.pt_scale, sq, self._u2, self._b2_res,
                           self._baby2, self._giant2, mode)

    def score(self, ct_x: Ciphertext) -> Ciphertext:
        """All K class scores of one sample as ONE ciphertext at
        `self.sub_ctx`'s level (slot k = class k)."""
        _check_scale(self, ct_x)
        if ct_x.c0.dim() != 2:
            raise ValueError(
                f"score takes one sample [L, N], got {tuple(ct_x.c0.shape)}; "
                "use score_many for a batch"
            )
        return self._run(ct_x)

    def score_many(self, ct_xs: Ciphertext) -> Ciphertext:
        """Score a batch [B, L, N], padded to the power-of-two bucket."""
        _check_scale(self, ct_xs)
        _check_batched(ct_xs)
        batch = ct_xs.c0.shape[0]
        out = self._run(_pad_to_bucket(ct_xs))
        return Ciphertext(c0=out.c0[:batch], c1=out.c1[:batch], scale=out.scale)


# --- The depth-2 MLP on the ladder -------------------------------------------
# The hidden layer is `_linear_apply` over the H units ([..., H, L, N], each
# unit in every slot), the square one batched ct_mul + relinearization, then
# `rescales` rescales, and the output layer a Montgomery product with the
# eval-domain constant w2[k, j] (a constant polynomial is the constant at
# every evaluation point) contracted over H: no rotation, no NTT.


def _const_eval_residues(ctx: CkksContext, c: np.ndarray, scale: float) -> np.ndarray:
    """Eval-domain residues of constant-in-every-slot plaintexts: round(c *
    scale) mod p_i as uint32 [..., L, 1]."""
    coeffs = np.round(np.asarray(c, np.float64) * scale).astype(np.int64)
    p = np.asarray(ctx.ntt.p)[:, 0].astype(np.int64)
    q = ctx.modulus
    if np.any(2 * np.abs(coeffs.astype(object)) >= q):
        raise ValueError(
            f"constant plaintext saturates: |round(c*scale)| up to "
            f"{np.max(np.abs(coeffs))} must stay below q/2 (q~2**{q.bit_length()})"
        )
    return np.mod(coeffs[..., None], p)[..., None].astype(np.uint32)


def _const_eval_mont(ctx: CkksContext, c: np.ndarray, scale: float) -> np.ndarray:
    """Montgomery form of `_const_eval_residues` (x * 2**32 mod p), uint32
    [..., L, 1]."""
    res = _const_eval_residues(ctx, c, scale).astype(np.int64)
    p = np.asarray(ctx.ntt.p)[:, 0].astype(np.int64)[:, None]
    return ((res << 32) % p).astype(np.uint32)


@scoped(scopes.SERVE_SCORE)
def _mlp_tail_apply(ctx: CkksContext, pt_scale: float, rescales: int, h: Ciphertext, rlk,
                    w2m, b2e) -> Ciphertext:
    """Everything after the hidden layer, any leading batch shape on the
    [..., H, L, N] hidden ciphertext: the square (batched ct_mul, one K5
    eval-input call), `rescales` rescales, and scores_k = sum_j w2[k, j] *
    h_j**2 + b2[k] as a Montgomery product with `w2m` [K, H, L, 1] contracted
    over H, plus `b2e` [K, L, 1]."""
    sq = ops.ct_mul(ctx, h, h, rlk)
    cur = ctx
    for _ in range(rescales):
        cur, sq = ops.rescale(cur, sq)
    tabs = plain_tables(cur.ntt, sq.c0.device)
    p, pinv = tabs.p, tabs.pinv_neg
    w = w2m.to(torch.int64)

    def contract(c: torch.Tensor) -> torch.Tensor:
        t = modular.mont_mul(c.to(torch.int64)[..., None, :, :, :], w, p, pinv)
        return t.sum(dim=-3) % p

    c0 = modular.add_mod(contract(sq.c0), b2e.to(torch.int64), p)
    return Ciphertext(c0=c0.to(torch.int32), c1=contract(sq.c1).to(torch.int32),
                      scale=sq.scale * pt_scale)


def encrypted_mlp(ctx: CkksContext, ct_x: Ciphertext, w1: np.ndarray, b1: np.ndarray,
                  w2: np.ndarray, b2: np.ndarray, gks: dict[int, GaloisKey], rlk,
                  pt_scale: float = 2.0**14, rescales: int = 2,
                  device=None) -> tuple[CkksContext, list[Ciphertext]]:
    """Private 1-hidden-layer MLP: scores = W2 (W1 x + b1)**2 + b2 under
    encryption, a depth-2 circuit (`ctx` needs num_primes >= 3 + rescales).
    -> (the post-rescale context, K score ciphertexts); decrypt with
    `decrypt_scores(sub_ctx, slice_secret_key(sk, sub_ctx.num_primes), ...)`.
    One-shot `MlpScorer`, on the query's device unless `device` is given."""
    device = ct_x.c0.device if device is None else device
    scorer = MlpScorer(ctx, w1, b1, w2, b2, gks, rlk, pt_scale, rescales,
                       ct_scale=ct_x.scale, device=device)
    return scorer.sub_ctx, scorer.score(ct_x)


class MlpScorer:
    """Private-inference server for a FIXED depth-2 MLP on the ladder: the
    hidden layer's slot encodes, the post-rescale context and the output
    layer's eval-domain constants are built once here, on `device` (CUDA
    unless given). Decrypt against `self.sub_ctx` with
    `slice_secret_key(sk, self.sub_ctx.num_primes)`."""

    def __init__(self, ctx: CkksContext, w1: np.ndarray, b1: np.ndarray, w2: np.ndarray,
                 b2: np.ndarray, gks: dict[int, GaloisKey], rlk, pt_scale: float = 2.0**14,
                 rescales: int = 2, ct_scale: float | None = None, device=None):
        w1 = np.asarray(w1, np.float64)
        w2 = np.asarray(w2, np.float64)
        b2 = np.asarray(b2, np.float64)
        # The output layer's shapes first: a malformed model fails before
        # any encode.
        if w1.ndim != 2:
            raise ValueError(f"w1 must be [H, d], got {w1.shape}")
        if w2.ndim != 2 or w2.shape[1] != w1.shape[0]:
            raise ValueError(f"w2 must be [K, {w1.shape[0]}], got {w2.shape}")
        if b2.shape != (w2.shape[0],):
            raise ValueError(f"b2 must be [{w2.shape[0]}], got {b2.shape}")
        self.device = resolve_device(device)
        self.ctx = ctx
        self.pt_scale = pt_scale
        self.ct_scale = ctx.scale if ct_scale is None else ct_scale
        self._ladder = stack_rotation_ladder(ctx, gks, self.device)
        self.rlk = dataclasses.replace(
            rlk, b_mont=rlk.b_mont.to(self.device), a_mont=rlk.a_mont.to(self.device))
        self.num_classes = int(w2.shape[0])
        self._rescales = int(rescales)
        self._w1_res, self._b1_res = _encode_linear_model(
            ctx, w1, b1, self.ct_scale, pt_scale, self.device)
        h_scale = self.ct_scale * pt_scale
        sq_scale = h_scale * h_scale
        p_np = np.asarray(ctx.ntt.p)[:, 0]
        for i in range(self._rescales):
            sq_scale /= float(p_np[ctx.num_primes - 1 - i])
        self.sub_ctx = mlp_sub_context(ctx, self._rescales)
        as_tensor = lambda a: torch.from_numpy(a.view(np.int32)).to(self.device)  # noqa: E731
        self._w2m = as_tensor(_const_eval_mont(self.sub_ctx, w2, pt_scale))
        self._b2e = as_tensor(_const_eval_residues(self.sub_ctx, b2, sq_scale * pt_scale))

    @property
    def num_keyswitches(self) -> int:
        """Key-switches per score: the hidden ladder's, one relinearization
        per hidden unit."""
        hidden = int(self._w1_res.shape[0])
        return ladder_keyswitches(encoding.num_slots(self.ctx.ntt), hidden) + hidden

    def _run(self, ct: Ciphertext) -> Ciphertext:
        h = _linear_apply(self.ctx, self.pt_scale, ct, self._w1_res, self._b1_res, self._ladder)
        return _mlp_tail_apply(self.ctx, self.pt_scale, self._rescales, h, self.rlk,
                               self._w2m, self._b2e)

    def score_batched(self, ct_x: Ciphertext) -> Ciphertext:
        """K class scores as ONE batched ciphertext at `self.sub_ctx`'s level."""
        _check_scale(self, ct_x)
        return self._run(ct_x)

    def score(self, ct_x: Ciphertext) -> list[Ciphertext]:
        return _split_classes(self.score_batched(ct_x))

    def score_many(self, ct_xs: Ciphertext) -> Ciphertext:
        """Score a batch [B, L, N] -> [B, K] batched score ciphertext at
        `self.sub_ctx`'s level; decrypt with `decrypt_score_matrix`."""
        _check_scale(self, ct_xs)
        _check_batched(ct_xs)
        return self._run(ct_xs)


def rotation_ladder_range_probe(prime: int, digit_bits: int, num_digits: int,
                                device="cpu"):
    """The rotate-and-sum serving ladder's carrier arithmetic as ONE
    traceable loop (`analysis.ranges.certify_inference`).

    Per ladder stage, what `rotate_and_sum_scan` computes on each RNS limb:
    the automorphism (an `index_select` through the rotation table plus the
    sign flip, taken at its worst case `(p - x) mod p`), the gadget
    key-switch (base-2**w digits, centring, the digit x key inner product
    summed mod p) and the rotate+add re-canonicalisation, as a `while_loop`
    over an ABSTRACT stage count, so the carried (c0, c1) invariant is
    proven for any ladder depth. `%` stands in for the Montgomery REDC
    contract on the int64 carrier. -> (fn, example_args) on `device`."""
    from torch._higher_order_ops.while_loop import while_loop_op

    p = int(prime)
    w = int(digit_bits)
    half = 1 << max(w - 1, 0)
    mask = (1 << w) - 1
    m = 4  # coefficients per probe limb; ranges are per element anyway

    def cond(remaining, c0, c1, *consts):
        return remaining > 0

    def body(remaining, c0, c1, key_b, key_a, src):
        # Rotation: gather through the automorphism table, sign flip at its
        # worst case (canonical-preserving).
        g0 = torch.index_select(c0, -1, src)
        g1 = torch.index_select(c1, -1, src)
        pc0 = (p - g0) % p
        pc1 = (p - g1) % p
        # Gadget key-switch: digit-decompose pc1, centre, inner-product
        # against the key tensors, modular tree-sum.
        ks0 = torch.zeros_like(c0)
        ks1 = torch.zeros_like(c1)
        for kk in range(int(num_digits)):
            digit = (pc1 >> (w * kk)) & mask       # [0, 2**w - 1]
            centered = (digit + (p - half)) % p    # canonical
            ks0 = (ks0 + centered * key_b) % p
            ks1 = (ks1 + centered * key_a) % p
        return remaining - 1, (pc0 + ks0) % p, ks1

    def probe(depth, c0, c1, key_b, key_a, src):
        _, c0, c1 = while_loop_op(cond, body, (depth, c0, c1), (key_b, key_a, src))
        return c0, c1

    return probe, (torch.zeros((), dtype=torch.int64, device=device),
                   *(torch.zeros((m,), dtype=torch.int64, device=device) for _ in range(5)))


def mlp_bsgs_range_probe(prime: int, digit_bits: int, num_digits: int, device="cpu"):
    """The two-layer composed MLP circuit's carrier arithmetic as a
    traceable mirror (`analysis.ranges.certify_inference`).

    Per RNS limb, what `MlpScorer`'s program computes: a layer-1 hoisted
    sweep (uncentered shared digits, digit x key products, the eval
    permutation) as a `while_loop` over an abstract step count, the square's
    Montgomery-contract products (`ct_mul`'s d0/d1/d2 at canonical inputs),
    the relinearisation's centred gadget key-switch of d2, the rescale's
    (x - rep) * p_last^-1 mod p at a canonical stand-in for the dropped
    limb, and a layer-2 hoisted sweep. Both sweeps are abstract-depth
    loops, so the invariants hold for any plan geometry; `%` stands in for
    REDC on the int64 carrier. -> (fn, example_args) on `device`."""
    from torch._higher_order_ops.while_loop import while_loop_op

    p = int(prime)
    w = int(digit_bits)
    half = 1 << max(w - 1, 0)
    mask = (1 << w) - 1
    m = 4  # coefficients per probe limb; ranges are per element anyway

    def cond(remaining, a0, a1, *consts):
        return remaining > 0

    def body(remaining, a0, a1, x0, x1, key_b, key_a, perm, *digits):
        k0 = torch.zeros_like(x0)
        k1 = torch.zeros_like(x1)
        for k in range(int(num_digits)):
            k0 = (k0 + digits[k] * key_b) % p
            k1 = (k1 + digits[k] * key_a) % p
        r0 = torch.index_select((x0 + k0) % p, -1, perm)
        r1 = torch.index_select(k1, -1, perm)
        return remaining - 1, (a0 + r0) % p, (a1 + r1) % p

    def hoisted_sweep(steps, x0, x1, key_b, key_a, perm):
        digits = [((x1 >> (w * k)) & mask) for k in range(int(num_digits))]
        _, a0, a1 = while_loop_op(cond, body,
                                  (steps, torch.zeros_like(x0), torch.zeros_like(x1)),
                                  (x0, x1, key_b, key_a, perm, *digits))
        return a0, a1

    def probe(steps1, steps2, c0, c1, key_b, key_a, perm, rs_inv):
        # Layer 1: hoisted sweep.
        h0, h1 = hoisted_sweep(steps1, c0, c1, key_b, key_a, perm)
        # Square activation: ct_mul's d0/d1/d2 Montgomery-contract mirror.
        d0 = (h0 * h0) % p
        d1 = ((h0 * h1) % p + (h1 * h0) % p) % p
        d2 = (h1 * h1) % p
        # Relinearisation: the centred gadget key-switch of d2.
        k0 = torch.zeros_like(d2)
        k1 = torch.zeros_like(d2)
        for k in range(int(num_digits)):
            digit = (d2 >> (w * k)) & mask
            centered = (digit + (p - half)) % p
            k0 = (k0 + centered * key_b) % p
            k1 = (k1 + centered * key_a) % p
        s0 = (d0 + (k0 + key_b) % p) % p
        s1 = (d1 + (k1 + key_a) % p) % p
        # Rescale: (x - rep) * p_last^-1 mod p, rep canonical (the dropped
        # limb's representative re-embedded under the head prime).
        rep = torch.index_select(s0, -1, perm)
        s0 = (((s0 + (p - rep)) % p) * rs_inv) % p
        s1 = (((s1 + (p - rep)) % p) * rs_inv) % p
        # Layer 2: hoisted sweep on the rescaled hidden ciphertext.
        return hoisted_sweep(steps2, s0, s1, key_b, key_a, perm)

    return probe, (torch.zeros((), dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.int64, device=device),
                   *(torch.zeros((m,), dtype=torch.int64, device=device) for _ in range(6)))


def exact_int_probes(device="cpu") -> dict:
    """The serving side's declared exact-integer regions, on a tiny ring
    (n = 256, 128 slots): the rotate-and-sum ladder (its seven stages, each
    K2, the automorphism gather, K5, K1 and two add_mods) and the composed
    two-layer MLP (the hidden layer's ladder, the square, its
    relinearization, two rescales and the output contraction)."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    ctx = CkksContext.create(n=256)
    sk, _ = keygen(ctx, gen, device=device)
    ladder = stack_rotation_ladder(ctx, gen_rotation_keys(ctx, sk, 1), device)
    zeros = torch.zeros((ctx.num_primes, ctx.n), dtype=torch.int32, device=device)
    ct = Ciphertext(c0=zeros, c1=zeros, scale=ctx.scale)

    mctx = CkksContext.create(n=256, num_primes=5)
    msk, _ = keygen(mctx, gen, device=device)
    rng = np.random.default_rng(0)
    mlp = MlpScorer(mctx, rng.normal(0, 0.3, (2, 4)), rng.normal(0, 0.2, (2,)),
                    rng.normal(0, 0.3, (2, 2)), rng.normal(0, 0.2, (2,)),
                    gen_rotation_keys(mctx, msk, 2), gen_relin_key(mctx, msk, gen),
                    device=device)
    mzeros = torch.zeros((mctx.num_primes, mctx.n), dtype=torch.int32, device=device)
    mct = Ciphertext(c0=mzeros, c1=mzeros, scale=mctx.scale)
    return {
        "he_inference.rotate_ladder": (lambda c: rotate_and_sum_scan(ctx, c, ladder), (ct,)),
        "he_inference.mlp_compose": (mlp._run, (mct,)),
    }
