"""Encrypted FedAvg: train, encrypt, sum mod p, owner decrypt.

Counterpart of the synchronous paths of `hefl_tpu.fl.secure`. Each client's
upload goes through ONE encrypt core call over the whole client stack (one
fused-encrypt kernel launch on CUDA):

  * float (`encrypt_stack`): the trained weights packed into [n_ct, N]
    coefficient blocks and encoded; the 1/C of FedAvg costs nothing, since
    the owner's decode divides by scale * C.
  * packed (`encrypt_stack_packed`): the UPDATE (trained minus global
    weights) quantized to b bits and interleaved k to a slot, [n_ct/k, N]
    integers through the exact `encode_packed`; the owner decodes exact
    field sums (`decrypt_average(packing=...)`).
  * hybrid HE (`hhe_encrypt_stack`): the same packed integers under each
    client's stream cipher — no CKKS work on the client at all; the server
    transciphers them (`hhe.transcipher`) before the sum.
  * error feedback (`residual_blk=` on the packed and hybrid-HE stacks):
    the upload of update + carried residual, returning the new residual;
    only the streaming engine, which carries the residual rows across
    rounds, runs it.

The server's aggregation is the ciphertext sum mod p over the client axis;
across the client mesh (`mesh=`, one rank a GPU) each rank sums its block
and the partial sums are all-reduced mod p (`psum_ciphertext`); on a
("clients", "ct") mesh the ct ranks of a client row split each client's
encrypt rows (`ct_sharded_encrypt_core`); and the owner's encrypt and
decrypt can split their rows over a ct mesh (`encrypt_params_sharded`,
`decrypt_sharded`).
Trust split: the round touches only the `PublicKey`; the `SecretKey`
appears only in `decrypt_average`, the model owner's step.

Robust and private rounds (the JAX package's masked engine): a client's
trained weights are DP-sanitized (`fl.dp`, clip and a distributed noise
share), then poisoned (`fl.faults` fault injection), then encrypted; the
sanitizing predicates give each client an exclusion bit, and an excluded
client's ciphertext rows are zeroed before the sum (every client is still
encrypted, so the encrypt launch keeps its shape). The owner decodes by the
surviving count (`decrypt_average(meta=)`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from hefl_tpu_torch.ckks import encoding, ops
from hefl_tpu_torch.ckks.keys import CkksContext, PublicKey, SecretKey
from hefl_tpu_torch.ckks.ntt import plain_tables
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.ckks.packing import (
    PackedSpec,
    PackSpec,
    flat_params,
    pack_params,
    pack_quantized_flat,
    pack_quantized_flat_ef,
    unpack_blocks,
    unpack_quantized,
)
from hefl_tpu_torch.fl.client import hoist_streams
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig, calibration_clients, dp_sanitize
from hefl_tpu_torch.fl.faults import RoundMeta, exclusion_bits, poison_tree
from hefl_tpu_torch.fl.fedavg import (
    _round_geometry,
    _trivial_mask,
    agree_shift_backend,
    client_block,
    client_generators,
    cohort_bucket,
    cohort_gather_index,
    gather_clients,
    masked_mean_tree,
    resident_index,
    masked_mode,
    participation_mask,
    plain_mean,
    train_block,
)
from hefl_tpu_torch.fl.fusion import resolve_fusion_backend
from hefl_tpu_torch.hhe import cipher
from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs.scopes import scoped
from hefl_tpu_torch.parallel import (
    CT_AXIS, client_axes, client_mesh_size, ct_shard_count, hierarchical_psum_mod, pmean_tree,
)


def ct_sharded_encrypt_core(ctx: CkksContext, pk: PublicKey, m_res: torch.Tensor, u, e0, e1,
                            mesh) -> Ciphertext:
    """The stacked encrypt core [C, n_ct, L, N] with the ciphertext rows
    (axis 1) split over the mesh's "ct" axis, the counterpart of the JAX
    package's `_ct_sharded_encrypt_core`: the rows zero-padded to a
    multiple of the ct size, this ct rank's `per = ceil(n_ct / ct)` rows
    encrypted (one K3 launch at [C * per, L, N] on CUDA), the slices
    all-gathered in ct order over the ct group and cut to n_ct. Every row's
    math is the unsplit core's, so the result is bitwise it. Every ct rank
    of a client row calls this alike; a mesh without a ct axis (or None)
    runs the unsplit core."""
    shards = 1 if mesh is None else ct_shard_count(mesh)
    if shards <= 1:
        return ops.encrypt_batch(ctx, pk, m_res, samples=(u, e0, e1))
    group = mesh.groups.get(CT_AXIS)
    if group is None:
        raise ValueError("ct_sharded_encrypt_core: the ct split needs the mesh's process "
                         "group (a layout-only mesh has none)")
    n_ct = int(m_res.shape[1])
    per = -(-n_ct // shards)
    lo = mesh.coords[CT_AXIS] * per

    def local(t):
        pad = per * shards - n_ct
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], dim=1)
        return t[:, lo: lo + per]

    ct = ops.encrypt_batch(ctx, pk, local(m_res), samples=(local(u), local(e0), local(e1)))

    def gather(blk):
        parts = [torch.empty_like(blk) for _ in range(shards)]
        dist.all_gather(parts, blk.contiguous(), group=group)
        return torch.cat(parts, dim=1)[:, :n_ct]

    return Ciphertext(c0=gather(ct.c0), c1=gather(ct.c1), scale=ct.scale)


def _encrypt_rows(ctx: CkksContext, pk: PublicKey, m_res: torch.Tensor, enc_gens, samples,
                  mesh) -> Ciphertext:
    """The batched encrypt of residues [C, n_ct, L, N], split over the
    mesh's ct axis when it has one (`ct_sharded_encrypt_core`): the samples
    are drawn at the whole [n_ct] shape first, as the unsplit call draws
    them."""
    if samples is None:
        samples = ops.batch_samples(ctx, enc_gens, int(m_res.shape[1]), m_res.device)
    return ct_sharded_encrypt_core(ctx, pk, m_res, *samples, mesh)


def encode_stack(ctx: CkksContext, p_out: list[dict]) -> torch.Tensor:
    """Per-client pack + encode -> coefficient residues int32[C, n_ct, L, N]."""
    return torch.stack([
        encoding.encode(ctx.ntt, pack_params(prm, ctx.n), ctx.scale) for prm in p_out
    ])


@scoped(scopes.ENCRYPT)
def encrypt_stack(
    ctx: CkksContext, pk: PublicKey, p_out: list[dict], enc_gens=None, samples=None, mesh=None
) -> Ciphertext:
    """Encrypt C clients' parameter dicts into one [C, n_ct, L, N] Ciphertext
    (client c's randomness from `enc_gens[c]`, or the given `samples`); on
    a ("clients", "ct") `mesh` the rows split over its ct axis."""
    return _encrypt_rows(ctx, pk, encode_stack(ctx, p_out), enc_gens, samples, mesh)


def encrypt_params(
    ctx: CkksContext, pk: PublicKey, params: dict, gen: torch.Generator | None = None,
    samples=None,
) -> Ciphertext:
    """Encrypt one client's parameter dict -> Ciphertext [n_ct, L, N] (one
    K3 launch on CUDA): the analog of the reference's
    `encrypt_export_weights`, 55 batched ciphertexts for MedCNN. The
    randomness (u, e0, e1) is drawn from `gen`, or `samples` = (u, e0, e1)
    int32[n_ct, L, N] are given (a test feeding the JAX package's)."""
    ct = encrypt_stack(ctx, pk, [params], None if gen is None else [gen], samples)
    return Ciphertext(c0=ct.c0[0], c1=ct.c1[0], scale=ct.scale)


def encrypt_params_packed(
    ctx: CkksContext, pk: PublicKey, params: dict, base_params: dict,
    gen: torch.Generator | None, spec: PackedSpec, samples=None,
) -> Ciphertext:
    """Encrypt one client's quantized interleaved UPDATE (params minus
    `base_params`) -> Ciphertext [spec.n_ct, L, N] at the guard scale: the
    packed twin of `encrypt_params`, k-fold fewer rows through the same
    encrypt core (one K3 launch on CUDA)."""
    ct, _ = encrypt_stack_packed(ctx, pk, [params], base_params,
                                 None if gen is None else [gen], spec, samples)
    return Ciphertext(c0=ct.c0[0], c1=ct.c1[0], scale=ct.scale)


def _pad_rows(t: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad axis 0 to a multiple of `mult` (ciphertext-shard padding)."""
    pad = (-int(t.shape[0])) % mult
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    return t


def _row_block(mesh, *ts: torch.Tensor) -> tuple[list, int]:
    """Each [n_ct, ...] tensor zero-padded to the ct mesh and cut to this
    rank's block of rows -> (blocks, n_ct)."""
    n_dev = mesh.size
    rows = -(-int(ts[0].shape[0]) // n_dev)
    lo = mesh.coords[mesh.axis_names[0]] * rows
    return [_pad_rows(t, n_dev)[lo: lo + rows] for t in ts], int(ts[0].shape[0])


def _gather_rows(mesh, blk: torch.Tensor, n_ct: int) -> torch.Tensor:
    """Every rank's block of rows, in rank order, less the padding."""
    if mesh.group is None:
        return blk[:n_ct]
    parts = [torch.empty_like(blk) for _ in range(mesh.size)]
    dist.all_gather(parts, blk.contiguous(), group=mesh.group)
    return torch.cat(parts)[:n_ct]


def encrypt_params_sharded(ctx: CkksContext, pk: PublicKey, params: dict,
                           gen: torch.Generator, mesh) -> Ciphertext:
    """`encrypt_params` with the [n_ct] ciphertext rows split over a ct mesh
    (`parallel.make_ct_mesh`; every member rank calls it alike): encode
    and the samples at the whole [n_ct] shape from `gen`, as the one-device
    path draws them, then each rank's block of rows through the encrypt
    core (one K3 launch a rank on CUDA), the blocks gathered on every rank.
    Bitwise `encrypt_params(..., gen)`."""
    m_res = encoding.encode(ctx.ntt, pack_params(params, ctx.n), ctx.scale)
    samples = ops.encrypt_samples(ctx, gen, (int(m_res.shape[0]),), m_res.device)
    (m_blk, u, e0, e1), n_ct = _row_block(mesh, m_res, *samples)
    ct = ops.encrypt_core(ctx, pk, m_blk, u, e0, e1)
    return Ciphertext(c0=_gather_rows(mesh, ct.c0, n_ct), c1=_gather_rows(mesh, ct.c1, n_ct),
                      scale=ctx.scale)


def decrypt_sharded(ctx: CkksContext, sk: SecretKey, ct: Ciphertext, mesh) -> torch.Tensor:
    """`ops.decrypt` with the [n_ct] rows split over a ct mesh (one K4 launch
    a rank on CUDA), gathered on every rank: bitwise the residues."""
    (c0, c1), n_ct = _row_block(mesh, ct.c0, ct.c1)
    res = ops.decrypt(ctx, sk, Ciphertext(c0=c0, c1=c1, scale=ct.scale))
    return _gather_rows(mesh, res, n_ct)


def _pack_updates(p_out: list[dict], base_params: dict, spec: PackedSpec,
                  residual_blk: torch.Tensor | None) -> list[tuple]:
    """Each client's UPDATE (trained weights minus `base_params`) quantized
    and interleaved -> (hi, lo, saturation) a client; with `residual_blk`
    (float32[C, total], error feedback) quantized THROUGH its carried
    residual row, with the new row fourth."""
    base = flat_params(base_params)
    if residual_blk is None:
        return [pack_quantized_flat(flat_params(prm) - base, spec) for prm in p_out]
    return [pack_quantized_flat_ef(flat_params(prm) - base, residual_blk[c], spec)
            for c, prm in enumerate(p_out)]


def _with_residual(out: tuple, packed: list[tuple], residual_blk) -> tuple:
    return out if residual_blk is None else out + (torch.stack([r for *_, r in packed]),)


@scoped(scopes.ENCRYPT)
def encrypt_stack_packed(
    ctx: CkksContext, pk: PublicKey, p_out: list[dict], base_params: dict, enc_gens,
    spec: PackedSpec, samples=None, residual_blk: torch.Tensor | None = None, mesh=None,
) -> tuple:
    """The packed twin of `encrypt_stack`: each client's UPDATE (trained
    weights minus `base_params`, the round's global weights) quantized and
    interleaved -> (Ciphertext [C, spec.n_ct, L, N] at the guard scale,
    saturation int32[C], the packed analog of the encode overflow). With
    `residual_blk` (error feedback: float32[C, total] in `p_out`'s client
    order) each update is quantized through its residual row and the new
    rows come back third, float32[C, total]; the wire geometry is the same.
    On a ("clients", "ct") `mesh` the rows split over its ct axis."""
    packed = _pack_updates(p_out, base_params, spec, residual_blk)
    m_res = torch.stack([encoding.encode_packed(ctx.ntt, hi, lo) for hi, lo, *_ in packed])
    ct = _encrypt_rows(ctx, pk, m_res, enc_gens, samples, mesh)
    out = (Ciphertext(c0=ct.c0, c1=ct.c1, scale=spec.guard_scale),
           torch.stack([s for _, _, s, *_ in packed]))
    return _with_residual(out, packed, residual_blk)


@scoped(scopes.ENCRYPT)
def hhe_encrypt_stack(
    p_out: list[dict], base_params: dict, hhe_keys, round_index: int, spec: PackedSpec,
    residual_blk: torch.Tensor | None = None,
) -> tuple:
    """The hybrid-HE twin of `encrypt_stack_packed`: each client's packed
    update under its stream cipher (`hhe_keys[c]`, uint32[4]) instead of
    CKKS — one keystream sweep and one add per slot, no NTT.
    -> (w_hi, w_lo int32[C, spec.n_ct, N], saturation int32[C]), and the
    new residual rows fourth with `residual_blk`, as `encrypt_stack_packed`."""
    packed = _pack_updates(p_out, base_params, spec, residual_blk)
    words = [cipher.stream_encrypt(hi, lo, hhe_keys[c], round_index)
             for c, (hi, lo, *_) in enumerate(packed)]
    out = (torch.stack([wh for wh, _ in words]), torch.stack([wl for _, wl in words]),
           torch.stack([s for _, _, s, *_ in packed]))
    return _with_residual(out, packed, residual_blk)


def lazy_sum_mod(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum int32 residues over axis 0 mod p -> canonical int32.

    An int64 sum then one reduction: 2**36 summands below 2**27 fit int64,
    whereas 32 of them already overflow int32. Canonical output, so bitwise
    equal to the JAX package's chunked uint32 `_lazy_sum_mod`."""
    return torch.remainder(torch.sum(x.to(torch.int64), dim=0), p).to(torch.int32)


def exact_int_probes(device="cpu") -> dict:
    """The lazy modular sum as a declared exact-integer region: it runs per
    ciphertext limb on the aggregation path."""
    p = torch.full((3, 1), 2**27 - 39, dtype=torch.int64, device=device)
    x = torch.zeros((4, 3, 8), dtype=torch.int32, device=device)
    return {"fl.secure.lazy_sum_mod": (lambda v: lazy_sum_mod(v, p), (x,))}


def lazy_sum_chunk_probe(chunk: int = 32, device="cpu"):
    """Range probe (`analysis.ranges.certify_aggregation`): the int64 sum
    inside `lazy_sum_mod` of `chunk` canonical int32 residues before its one
    reduction, so the no-wrap proof is the sum's bound against int64.
    -> (fn, example_args) on `device`."""

    def probe(x):
        return torch.sum(x.to(torch.int64), dim=0)

    return probe, (torch.zeros((int(chunk), 8), dtype=torch.int32, device=device),)


@scoped(scopes.PSUM_AGGREGATE)
def aggregate_encrypted(ctx: CkksContext, cts: Ciphertext) -> Ciphertext:
    """Homomorphic sum of a [C, n_ct, L, N] ciphertext stack over clients."""
    p = plain_tables(ctx.ntt, cts.c0.device).p
    return Ciphertext(
        c0=lazy_sum_mod(cts.c0, p), c1=lazy_sum_mod(cts.c1, p), scale=cts.scale
    )


@scoped(scopes.PSUM_AGGREGATE)
def zero_excluded(cts: Ciphertext, keep: torch.Tensor) -> Ciphertext:
    """Zero the ciphertext rows [C, n_ct, L, N] of the clients with
    keep[c] False: zero residues are the additive identity mod p, so the
    sum that follows holds only the kept clients."""
    sel = keep.to(cts.c0.device).reshape((-1, 1, 1, 1))
    zero = torch.zeros((), dtype=cts.c0.dtype, device=cts.c0.device)
    return Ciphertext(c0=torch.where(sel, cts.c0, zero), c1=torch.where(sel, cts.c1, zero),
                      scale=cts.scale)


def client_uploads(
    model, cfg: TrainConfig, ctx: CkksContext, pk: PublicKey, global_params: dict,
    xs: torch.Tensor, ys: torch.Tensor, gen: torch.Generator, packing: PackedSpec | None = None,
    hhe_keys=None, round_index: int = 0, streams=None, dp: DpConfig | None = None,
    participation=None, poison=None, want_bits: bool = False, cohort=None,
    ef_residual=None, block=None, num_real_clients: int | None = None, mesh=None,
    resident_rows=None,
):
    """The client half of a round, in the JAX package's order: train ->
    DP-sanitize (`dp`, shares calibrated to `calibration_clients`) ->
    poison (`poison`, fault injection corrupts the upload) -> encrypt each
    upload — float CKKS, packed CKKS (`packing`), or the packed update under
    the stream cipher (`hhe_keys`, requires `packing`) — with its overflow
    count -> the exclusion bits (`want_bits`).

    `gen` seeds the per-client training generators, then the per-client
    encryption generators (made on xs's device), then, with `dp`, the
    per-client DP generators: the same draws on every path, so a round
    trains the same weights whatever it uploads, the server's pad
    encryption (`hhe.transcipher.provision_pads`) uses the encryption
    generators the direct upload would have, and a round without DP draws
    what it always drew. `participation` (int[C], 0 = scheduled out)
    reaches the fused trainer and the exclusion bits.

    `cohort` (sorted client indices, fewer than C) trains and encrypts only
    the cohort, as the JAX package's `fl.stream.produce_uploads` does: the
    cohort's rows (data, mask, poison, symmetric keys) are gathered and
    padded up to `fedavg.cohort_bucket` with client 0's slot, scheduled out;
    the per-client generators are drawn at the full count C and then
    gathered, so a cohort row's training, DP noise and ciphertext are
    bitwise what the full-C round computes for that client. The outputs
    are then cohort-rowed ([len(cohort), ...], cohort order); the padding
    rows are encrypted (the launch keeps the bucket's shape) and dropped.

    `ef_residual` (float32[C, total], the registry's rows) is REQUIRED when
    `packing.error_feedback` is set: each client quantizes its update plus
    its residual row, and the new residual rows (cohort-rowed under
    `cohort`) come back as a seventh output, for the streaming engine to
    scatter into its cross-round state.

    `block` (a rank's `fedavg.client_block`, or with `cohort` its
    `fedavg.cohort_block`: a gather index into the clients and its count of
    real rows) trains and encrypts this rank's block of the client mesh,
    with the generators drawn at the full count; the padding rows are
    scheduled out and KEPT (block-rowed outputs, cpd rows), as the JAX
    package keeps a device's padding slots. `num_real_clients`: the client
    count when xs is padded (`fedavg.pad_federated`) or holds only the
    clients `resident_rows` (a rank's staged rows). `mesh`: a ("clients",
    "ct") mesh splits each client's encrypt rows over its ct axis
    (`ct_sharded_encrypt_core`; the hybrid-HE upload runs no NTT and
    ignores it).

    -> (Ciphertext [C, n_ct, L, N] or the (w_hi, w_lo) word pair,
    metrics float32[C, E, 4], overflow [C], uploaded params, enc_gens,
    exclusion bits int32[C] or None[, residual' float32[C, total]])."""
    num_clients = int(xs.shape[0]) if num_real_clients is None else int(num_real_clients)
    if resident_rows is not None and num_real_clients is None:
        raise ValueError("client_uploads: resident_rows= needs num_real_clients=, the "
                         "registry's size")
    ef_on = packing is not None and packing.error_feedback
    if ef_on and ef_residual is None:
        raise ValueError(
            "PackingConfig.error_feedback needs the per-client residual "
            "rows (ef_residual) the StreamEngine carries across rounds — "
            "pass f32[num_clients, total] (zeros on round 0; see "
            "fl.client.init_ef_residuals)"
        )
    if packing is not None and packing.clients < num_clients:
        raise ValueError(
            f"packing spec sized for {packing.clients} clients cannot hold a "
            f"carry-free sum over {num_clients} — rebuild PackedSpec.for_params "
            "with the round's client count"
        )
    if hhe_keys is not None and packing is None:
        raise ValueError(
            "the hybrid-HE upload ships the PACKED quantized update under the "
            "stream cipher; give a PackedSpec"
        )
    cfg = agree_shift_backend(cfg, mesh, xs.device)
    gidx, rows = None, num_clients
    if cohort is not None:
        cohort = np.asarray(cohort, dtype=np.int64)
        if len(cohort) < num_clients and not hoist_streams(
                cfg, resolve_fusion_backend(cfg.client_fusion, model, xs.device)):
            # The JAX package's refusal: its nested layout derives the
            # shuffle inside the sharded region, where a cohort gather could
            # diverge bitwise from the full-C reference.
            raise ValueError(
                "cohort-only training requires the hoisted shuffle streams "
                "(TrainConfig.flat_scan=True, the default, or the fused backend); "
                "set flat_scan=True or train the full registry with "
                "StreamConfig.cohort_only=False (the CLI's --full-cohort-train)"
            )
        if len(cohort) > num_clients or (
                len(cohort) and (int(cohort.min()) < 0 or int(cohort.max()) >= num_clients)):
            raise ValueError(
                f"client_uploads: cohort of {len(cohort)} with indices in "
                f"[{cohort.min() if len(cohort) else 0}, "
                f"{cohort.max() if len(cohort) else 0}] does not fit the "
                f"{num_clients} registered clients"
            )
        if len(cohort) < num_clients and block is None:
            gidx = cohort_gather_index(cohort, cohort_bucket(len(cohort), num_clients))
            rows = len(cohort)
    if block is not None:
        gidx, rows = block
    elif gidx is None and resident_rows is not None:
        gidx = np.arange(num_clients)
    train_gens = client_generators(gen, num_clients, xs.device, gidx)
    enc_gens = client_generators(gen, num_clients, xs.device, gidx)
    dp_gens = client_generators(gen, num_clients, xs.device, gidx) if dp is not None else None
    part = participation_mask(num_clients, participation)
    if gidx is not None:
        part = part[gidx].copy()
        part[rows:] = 0                    # bucket padding: scheduled out, never ships
        if poison is not None:
            poison = np.asarray(poison).astype(np.int32).reshape(num_clients)[gidx].copy()
            poison[rows:] = 0
        idx = resident_index(gidx, resident_rows, xs.device)
        xs, ys = xs.index_select(0, idx), ys.index_select(0, idx)
        if hhe_keys is not None:
            hhe_keys = np.asarray(hhe_keys)[gidx]
        if ef_on:
            ef_residual = ef_residual[torch.from_numpy(gidx).to(ef_residual.device)]
    p_out, mets = train_block(
        model, cfg, global_params, xs, ys,
        gens=None if streams is not None else train_gens, streams=streams,
        participation=part if want_bits else None,
    )
    with torch.profiler.record_function(scopes.SANITIZE):
        if dp is not None:
            dp_k = calibration_clients(dp, num_clients)
            p_out = [dp_sanitize(g, global_params, prm, dp, dp_k)[0]
                     for g, prm in zip(dp_gens, p_out)]
        if poison is not None:
            p_out = [poison_tree(prm, int(code)) for prm, code in zip(p_out, np.asarray(poison))]
    ef_blk = ef_residual if ef_on else None
    ef = []
    if hhe_keys is not None:
        w_hi, w_lo, overflow, *ef = hhe_encrypt_stack(p_out, global_params, hhe_keys,
                                                      round_index, packing, residual_blk=ef_blk)
        cts = (w_hi, w_lo)
    elif packing is not None:
        cts, overflow, *ef = encrypt_stack_packed(ctx, pk, p_out, global_params, enc_gens,
                                                  packing, residual_blk=ef_blk, mesh=mesh)
    else:
        with torch.profiler.record_function(scopes.ENCRYPT):
            overflow = torch.stack([
                encoding.encode_overflow_count(pack_params(prm, ctx.n), ctx.scale)
                for prm in p_out
            ])
        cts = encrypt_stack(ctx, pk, p_out, enc_gens, mesh=mesh)
    bits = None
    if want_bits:
        with torch.profiler.record_function(scopes.SANITIZE):
            bits = exclusion_bits(cfg, global_params, p_out, part, overflow)
    ef_out = ef[0] if ef else None
    if gidx is not None and block is None:
        if hhe_keys is None:
            cts = Ciphertext(c0=cts.c0[:rows], c1=cts.c1[:rows], scale=cts.scale)
        else:
            cts = (cts[0][:rows], cts[1][:rows])
        mets, overflow, p_out, enc_gens = mets[:rows], overflow[:rows], p_out[:rows], enc_gens[:rows]
        bits = bits[:rows] if bits is not None else None
        ef_out = ef_out[:rows] if ef_out is not None else None
    if ef_on:
        return cts, mets, overflow, p_out, enc_gens, bits, ef_out
    return cts, mets, overflow, p_out, enc_gens, bits


def secure_fedavg_round(
    model,
    cfg: TrainConfig,
    ctx: CkksContext,
    pk: PublicKey,
    global_params: dict,
    xs: torch.Tensor,
    ys: torch.Tensor,
    gen: torch.Generator,
    with_plain_reference: bool = False,
    streams=None,
    packing: PackedSpec | None = None,
    dp: DpConfig | None = None,
    participation=None,
    poison=None,
    mesh=None,
    num_real_clients: int | None = None,
    resident_rows=None,
):
    """One encrypted FedAvg round on the device of `xs`.

    xs: uint8[C, m, H, W, ch], ys: int[C, m]. `gen` seeds the per-client
    training, encryption and (with `dp`) DP generators (made on xs's
    device); `streams` optionally replaces the training streams. `packing`
    (a PackedSpec) uploads quantized interleaved updates; follow with
    `decrypt_average(..., packing=, base_params=global_params)`. `dp` (a
    DpConfig) clips each client's delta and adds its noise share before
    encryption.
    -> (Ciphertext sum [n_ct, L, N], metrics float32[C, E, 4],
    encode_overflow (or quantizer saturation) [C]).

    A participation mask (int[C], 0 = scheduled out), poison codes
    (`faults.POISON_*`[C]), `max_update_norm` > 0 or on_overflow="exclude"
    route the round through the masked engine (`fedavg.masked_mode`): every
    client is encrypted, the excluded clients' rows are zeroed before the
    sum, and the return gains the round's `RoundMeta` after the overflow,
    whose `surviving` is the owner's decode denominator. A clean schedule
    without sanitizing knobs is the unmasked round bit for bit, with a
    full-participation meta. A DP round that survives below its
    calibration floor raises ValueError: its release would carry less
    noise than `epsilon_spent` accounts.

    `with_plain_reference=True` is a MEASUREMENT-ONLY mode that appends the
    plaintext FedAvg mean of the same uploaded weights (the masked mean over
    the kept clients on the masked engine): it leaks what the encrypted
    path exists to hide, and exists only to check encode + encrypt + sum +
    decrypt against a plaintext reference in one program.

    `mesh` (a `parallel.Mesh` of several ranks; every member rank calls
    this with the same arguments) takes this rank's block of clients
    through `client_uploads`, sums the block's ciphertexts
    (`aggregate_encrypted`) and all-reduces the partial sums mod p over the
    client axes (`parallel.hierarchical_psum_mod`): the sum is the
    one-device round's bit for bit, on every rank. A count the mesh does
    not divide is padded with masked-out slots; `num_real_clients` marks
    xs/ys as padded by `fedavg.pad_federated`, `resident_rows` (with
    `num_real_clients`) as holding only those clients (this rank's block).
    Metrics, overflow and the RoundMeta come back for every client on
    every rank. On a ("clients", "ct") mesh (`parallel.make_mesh_2d`)
    every ct rank of a client row trains the row's block, the encrypt rows
    split over the ct axis (`ct_sharded_encrypt_core`) and the sum reduces
    over the client axis only: bitwise the 1-D round.
    """
    if packing is not None and packing.error_feedback:
        # One-shot round: nowhere to carry the residual, so an EF spec here
        # would silently degrade to plain low-bit quantization.
        raise ValueError(
            "PackingConfig.error_feedback requires the streaming engine's "
            "cross-round residual state (fl.stream); the batched secure "
            "round cannot carry it — add a StreamConfig or drop "
            "error_feedback"
        )
    n_dev = 1 if mesh is None else client_mesh_size(mesh)
    num_clients, pad_idx, _ = _round_geometry(xs, n_dev, num_real_clients, resident_rows)
    sanitizing = cfg.on_overflow == "exclude" or cfg.max_update_norm > 0
    explicit = participation is not None or poison is not None
    masked = masked_mode(cfg, num_clients, n_dev, explicit, secure=True)
    trivial = (masked and pad_idx is None and not sanitizing
               and _trivial_mask(participation, poison))
    want_bits = masked and not trivial
    block = client_block(mesh, num_clients, pad_idx) if n_dev > 1 else None
    cts, mets, overflow, p_out, _, bits = client_uploads(
        model, cfg, ctx, pk, global_params, xs, ys, gen, packing=packing, streams=streams,
        dp=dp, participation=participation if want_bits else None,
        poison=poison if want_bits else None, want_bits=want_bits, block=block,
        num_real_clients=num_clients, mesh=mesh, resident_rows=resident_rows,
    )
    keep = bits == 0 if want_bits else None
    if keep is not None:
        cts = zero_excluded(cts, keep)
    ct_sum = aggregate_encrypted(ctx, cts)
    if block is not None:
        ct_sum = psum_ciphertext(ctx, ct_sum, mesh)
        mets = gather_clients(mesh, mets, num_clients)
        overflow = gather_clients(mesh, overflow, num_clients)
    if not want_bits:
        outs = (ct_sum, mets, overflow)
        if masked:
            outs = outs + (RoundMeta.full_participation(num_clients),)
        if with_plain_reference:
            outs = outs + (pmean_tree(plain_mean(p_out), mesh),)
        return outs
    meta = RoundMeta.from_bits(bits if block is None else gather_clients(mesh, bits, num_clients))
    if dp is not None and meta.surviving < calibration_clients(dp, num_clients):
        raise ValueError(
            f"dp round survived {meta.surviving} clients, below the "
            f"declared noise-calibration floor "
            f"{calibration_clients(dp, num_clients)} of {num_clients} "
            f"({meta.excluded}); the release would carry less noise than "
            "epsilon_spent accounts — raise DpConfig.min_surviving (more "
            "over-noising headroom) or reduce the fault pressure"
        )
    outs = (ct_sum, mets, overflow, meta)
    if with_plain_reference:
        total = num_clients if block is None else len(block[0]) * n_dev
        outs = outs + (masked_mean_tree(global_params, p_out, keep, total, mesh=mesh)[0],)
    return outs


def psum_ciphertext(ctx: CkksContext, ct: Ciphertext, mesh) -> Ciphertext:
    """The ranks' partial sums [n_ct, L, N] summed mod p over the mesh's
    client axes (`parallel.hierarchical_psum_mod`), on every rank."""
    p = plain_tables(ctx.ntt, ct.c0.device).p
    axes = client_axes(mesh)
    with torch.profiler.record_function(scopes.PSUM_AGGREGATE):
        return Ciphertext(c0=hierarchical_psum_mod(ct.c0, p, mesh, axes),
                          c1=hierarchical_psum_mod(ct.c1, p, mesh, axes), scale=ct.scale)


@scoped(scopes.DECRYPT)
def decrypt_average(
    ctx: CkksContext,
    sk: SecretKey,
    ct_sum: Ciphertext,
    num_clients: int | None = None,
    spec: PackSpec | None = None,
    meta: RoundMeta | None = None,
    packing: PackedSpec | None = None,
    base_params: dict | None = None,
    hhe: bool = False,
    exact: bool = False,
    mesh=None,
) -> dict:
    """Owner-side decrypt of the aggregated sum -> averaged parameter dict.

    Float path (`spec`): the division by the client count happens in the
    decode scale; `exact=True` decodes through the exact host CRT
    (`encoding.decode_exact`, the trust-boundary decode of the final model
    export) instead of the float32 recombination. Packed path (`packing`,
    with `base_params` the round's global weights): the integers are
    recovered EXACTLY (`decode_int_center` and one guard-rounding shift),
    deinterleaved, offset-corrected and averaged, and the average update is
    added onto `base_params`. `hhe` marks a transciphered aggregate, whose
    cipher wrap multiples `hhe_center_mod` removes first — bitwise the
    direct path's integers.
    The denominator is `meta.surviving` when the round's RoundMeta is given
    (cross-checked against `num_clients`), else `num_clients`. `mesh` (a
    ct mesh, `parallel.make_ct_mesh`) splits the decrypt's rows over its
    ranks (`decrypt_sharded`), each of which then holds the average.
    """
    if packing is None and spec is None:
        raise TypeError("decrypt_average: spec (the PackSpec) is required")
    if packing is not None and base_params is None:
        raise TypeError(
            "decrypt_average: the packed path decodes AVERAGE UPDATES — pass "
            "base_params (the round's global weights) to add them to"
        )
    if hhe and packing is None:
        raise TypeError("decrypt_average: hhe=True decodes a PACKED aggregate; pass packing")
    if meta is not None:
        if num_clients is not None and int(num_clients) != int(meta.num_clients):
            raise ValueError(
                f"decrypt_average: num_clients={num_clients} disagrees with the "
                f"round metadata ({meta.num_clients} clients)"
            )
        surviving = int(meta.surviving)
        if surviving <= 0:
            raise ValueError(
                "decrypt_average: round metadata reports 0 surviving clients — "
                "the aggregate is an encryption of zero; skip the round"
            )
    elif num_clients is None:
        raise TypeError("decrypt_average: need num_clients or the round's RoundMeta")
    else:
        surviving = int(num_clients)
    res = ops.decrypt(ctx, sk, ct_sum) if mesh is None else decrypt_sharded(ctx, sk, ct_sum, mesh)
    if packing is not None:
        v = encoding.decode_int_center(ctx.ntt, res)
        if hhe:
            v = cipher.hhe_center_mod(v, packing.guard)
        delta = unpack_quantized(v, packing, surviving)
        base = flat_params(base_params)
        return unpack_blocks(base + torch.from_numpy(delta).to(base.device), packing.base)
    denom = ct_sum.scale * surviving
    if exact:
        host = encoding.decode_exact(ctx.ntt, res.cpu().numpy().view(np.uint32), denom)
        blocks = torch.from_numpy(host.astype(np.float32)).to(res.device)
    else:
        blocks = encoding.decode(ctx.ntt, res, denom)
    return unpack_blocks(blocks, spec)
