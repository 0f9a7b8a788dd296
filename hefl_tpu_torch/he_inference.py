"""Encrypted-inference serving: baby-step giant-step (BSGS) scoring of
slot-packed encrypted features.

Counterpart of the BSGS half of `hefl_tpu.he_inference`. A server holding
only the context, the public key, Galois keys (and, for the MLP, a relin
key) scores an ENCRYPTED feature vector against its own plaintext model; the
client decrypts the scores. The linear layer is decomposed over the model's
generalized diagonals (Halevi-Shoup): all K class scores land in ONE output
ciphertext, at (baby - 1) + #giants key-switches per score.

Per score on CUDA: the baby sweep shares one gadget decomposition
(`ops.hoisted_digits`, one K1 launch) and runs every baby rotation as one K6
launch plus a permutation gather; each giant rotation is one K5 call; the
relinearization of the MLP's square activation is one K5 call in its
eval-input mode. The JAX package's `lax.scan` sweeps are Python loops here.

Keys come from `torch.Generator`s, so they differ from the JAX package's for
the same seed; the tests hand the JAX package's keys and ciphertexts to the
port (`convert`) and compare the output ciphertexts bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.ckks import encoding, galois, modular, ops
from hefl_tpu_torch.ckks.cuda_ntt import gadget_digits
from hefl_tpu_torch.ckks.keys import (
    CkksContext,
    GaloisKey,
    PublicKey,
    SecretKey,
    gen_galois_key,
)
from hefl_tpu_torch.ckks.ntt import ntt_forward, ntt_inverse, plain_tables, to_mont
from hefl_tpu_torch.ckks.ops import Ciphertext

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

    def rotate(c0_coeff, c1_coeff, src, flip, b_mont, a_mont):
        """One rotation of a COEFFICIENT-domain pair -> eval domain (int64)."""
        pc0 = galois.apply_automorphism(c0_coeff, p, src, flip)
        pc1 = galois.apply_automorphism(c1_coeff, p, src, flip)
        k0, k1 = ops._keyswitch_coeff(ctx, pc1, b_mont, a_mont)
        return modular.add_mod(i64(ntt_forward(ntt, pc0)), i64(k0), p), i64(k1)

    if not plan.baby_steps:
        rots0, rots1 = ct_x.c0[None], ct_x.c1[None]
    elif mode == "hoisted":
        d_eval = ops.hoisted_digits(ctx, ntt_inverse(ntt, ct_x.c1))
        r0, r1 = ops.hoisted_rotations_core(ctx, ct_x.c0, d_eval, *baby_tables)
        rots0, rots1 = torch.cat([ct_x.c0[None], r0]), torch.cat([ct_x.c1[None], r1])
    else:
        cc = ntt_inverse(ntt, torch.stack([ct_x.c0, ct_x.c1]))
        cc0, cc1 = cc[0], cc[1]
        src, flip, bks, aks = baby_tables
        num_r = ctx.num_primes * ctx.ksk_num_digits
        if mode == "unhoisted":
            lifted = gadget_digits(cc1, ctx.ksk_digit_bits, ctx.ksk_num_digits).to(torch.int32)
        r0s, r1s = [ct_x.c0], [ct_x.c1]
        for i in range(len(plan.baby_steps)):
            if mode == "unhoisted":
                d_eval = ntt_forward(ntt, galois.apply_automorphism(lifted, p, src[i], flip[i]))
                k0, k1 = ops._uncentered_products(ctx, d_eval, bks[i][:num_r], aks[i][:num_r])
                pc0 = ntt_forward(ntt, galois.apply_automorphism(cc0, p, src[i], flip[i]))
                r0, r1 = modular.add_mod(i64(pc0), k0, p), k1
            else:
                r0, r1 = rotate(cc0, cc1, src[i], flip[i], bks[i], aks[i])
            r0s.append(r0.to(torch.int32))
            r1s.append(r1.to(torch.int32))
        rots0, rots1 = torch.stack(r0s), torch.stack(r1s)

    # Giant partial sums: s[g] = sum_j rots[j] * u[g, j] mod p (canonical
    # products summed exactly in int64, then reduced: the same residue as
    # the JAX package's add_mod chain).
    batch_ndim = ct_x.c0.dim() - 2
    g_count = len(plan.giants)
    u = i64(u_mont).reshape((g_count, u_mont.shape[1]) + (1,) * batch_ndim + tuple(u_mont.shape[2:]))
    s0 = modular.mont_mul(i64(rots0)[None], u, p, pinv).sum(dim=1) % p
    s1 = modular.mont_mul(i64(rots1)[None], u, p, pinv).sum(dim=1) % p

    # Giant sweep: the identity group seeds the accumulator; every other
    # group rotates by its step (one K2 launch for both components, one K5).
    y0, y1 = s0[0], s1[0]
    src, flip, gbk, gak = giant_tables
    for gi in range(len(plan.giant_steps)):
        gc = ntt_inverse(ntt, torch.stack([s0[gi + 1], s1[gi + 1]]).to(torch.int32))
        rr0, rr1 = rotate(gc[0], gc[1], src[gi], flip[gi], gbk[gi], gak[gi])
        y0 = modular.add_mod(y0, rr0, p)
        y1 = modular.add_mod(y1, rr1, p)

    out = Ciphertext(c0=y0.to(torch.int32), c1=y1.to(torch.int32), scale=ct_x.scale * pt_scale)
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

    def _check_scale(self, ct: Ciphertext) -> None:
        if ct.scale != self.ct_scale:
            raise ValueError(f"scorer was built for ct scale {self.ct_scale}, got {ct.scale}")

    def _run(self, ct: Ciphertext) -> Ciphertext:
        return _bsgs_apply(
            self.ctx, self.plan, self.pt_scale, ct, self._u_mont, self._b_res,
            self._baby_tables, self._giant_tables, self.rotation_mode,
        )

    def score(self, ct_x: Ciphertext) -> Ciphertext:
        """All K class scores of one sample [L, N] as ONE ciphertext."""
        self._check_scale(ct_x)
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
        self._check_scale(ct_xs)
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

    def _check_scale(self, ct: Ciphertext) -> None:
        if ct.scale != self.ct_scale:
            raise ValueError(f"scorer was built for ct scale {self.ct_scale}, got {ct.scale}")

    def _run(self, ct_x: Ciphertext) -> Ciphertext:
        mode = self.rotation_mode
        h = _bsgs_apply(self.ctx, self.plan1, self.pt_scale, ct_x, self._u1, self._b1_res,
                        self._baby1, self._giant1, mode)
        sq = ops.ct_mul(self.ctx, h, h, self.rlk)
        cur = self.ctx
        for _ in range(self._rescales):
            cur, sq = ops.rescale(cur, sq)
        return _bsgs_apply(cur, self.plan2, self.pt_scale, sq, self._u2, self._b2_res,
                           self._baby2, self._giant2, mode)

    def score(self, ct_x: Ciphertext) -> Ciphertext:
        """All K class scores of one sample as ONE ciphertext at
        `self.sub_ctx`'s level (slot k = class k)."""
        self._check_scale(ct_x)
        if ct_x.c0.dim() != 2:
            raise ValueError(
                f"score takes one sample [L, N], got {tuple(ct_x.c0.shape)}; "
                "use score_many for a batch"
            )
        return self._run(ct_x)

    def score_many(self, ct_xs: Ciphertext) -> Ciphertext:
        """Score a batch [B, L, N], padded to the power-of-two bucket."""
        self._check_scale(ct_xs)
        _check_batched(ct_xs)
        batch = ct_xs.c0.shape[0]
        out = self._run(_pad_to_bucket(ct_xs))
        return Ciphertext(c0=out.c0[:batch], c1=out.c1[:batch], scale=out.scale)
