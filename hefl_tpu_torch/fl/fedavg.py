"""Client training across a round, the plaintext FedAvg round, and
evaluation, on one device or across the client mesh.

Counterpart of `hefl_tpu.fl.fedavg`. A round's clients train through
`train_block`, the one training body of the plaintext round, the encrypted
round (`secure.client_uploads`) and the streaming round, under the
configured backend (`TrainConfig.client_fusion`, `fl.fusion`): "vmap", the
per-client loop `train_clients` over the leading axis of the federated
arrays, or "fused", `fusion.fused_train`.

Across GPUs (`mesh=`, a `parallel.Mesh`, one rank a GPU): the clients are
laid out on the mesh's client axes in blocks of cpd = C / ranks, rank d
training clients d * cpd .. (d + 1) * cpd - 1; FedAvg is
`parallel.pmean_tree` of the block means. A rank holds either the whole
federated arrays or only the rows it trains (`resident_rows=`, the rows a
`data.RoundPrefetcher` staged on its card). A
client count that does not divide the mesh is padded with masked-out
slots that repeat client 0 (`pad_index`, `pad_federated`); the padded
round runs the masked engine. Every rank draws all C clients' generators
and keeps its block's, so a client's stream does not depend on the world
size. No mesh, or a one-rank one, is the one-device round bit for bit.

The participation-masked engine (`masked_mode`): a participation mask or
poison codes (`fl.faults`), or a `max_update_norm` bound, route a round
through poison -> `faults.exclusion_bits` -> `masked_mean_tree`, and the
round returns its `faults.RoundMeta` too. A clean schedule (every client
in, no poison, no sanitizing knob) takes the all-clients path bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from hefl_tpu_torch.data.augment import rescale
from hefl_tpu_torch.fl.client import local_train
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.faults import RoundMeta, exclusion_bits, poison_tree
from hefl_tpu_torch.fl.fusion import fused_train, resolve_fusion_backend
from hefl_tpu_torch.fl.metrics import classification_metrics
from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs.scopes import scoped
from hefl_tpu_torch.parallel import (
    client_axes, client_index, client_mesh_size, pmean_tree, psum_tree,
)


def train_clients(
    model, cfg: TrainConfig, global_params: dict, xs, ys, gens=None, streams=None
):
    """Train every client from the global weights, one after another: the
    "vmap" backend of `train_block`, and the semantics reference of the
    fused one.

    xs: uint8[C, m, H, W, ch], ys: int[C, m]; `gens` one generator per
    client, or `streams` one (perms, aug) pair per client.
    -> (list of C parameter dicts, metrics float32[C, E, 4])."""
    p_out, mets = [], []
    for c in range(int(xs.shape[0])):
        prm, met = local_train(
            model, cfg, global_params, xs[c], ys[c],
            gen=None if gens is None else gens[c],
            streams=None if streams is None else streams[c],
        )
        p_out.append(prm)
        mets.append(met)
    return p_out, torch.stack(mets)


def train_block(
    model, cfg: TrainConfig, global_params: dict, xs, ys, gens=None, streams=None,
    participation=None,
):
    """Train a round's clients under `cfg.client_fusion` (resolved on xs's
    device; a run resolves "auto" once and passes the pin): the fused
    backend (`fusion.fused_train`) or the per-client loop (`train_clients`).
    Same arguments and result as `train_clients`. `participation` (the
    masked round's int[C] mask) reaches the fused backend, where a
    scheduled-out client's updates are no-ops; the per-client loop trains
    everyone, as the JAX package's vmap reference does, and exclusion is
    left to the aggregation on both."""
    if resolve_fusion_backend(cfg.client_fusion, model, xs.device) == "fused":
        return fused_train(model, cfg, global_params, xs, ys, gens=gens, streams=streams,
                           participation=participation)
    return train_clients(model, cfg, global_params, xs, ys, gens=gens, streams=streams)


def client_generators(gen: torch.Generator, count: int, device,
                      index=None) -> list[torch.Generator]:
    """`count` generators on `device`, seeded by draws from `gen`. With
    `index` (a gather index into the `count` clients) the draws are the
    same and one NEW generator is made per entry of `index`, seeded as
    client index[i]'s: a cohort row's stream is the full round's, and a
    repeated client (bucket padding) gets its own copy of the stream."""
    seeds = torch.randint(0, 2**62, (count,), generator=gen, device=gen.device).tolist()
    if index is not None:
        seeds = [seeds[int(i)] for i in index]
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def cohort_bucket(cohort_size: int, num_clients: int, n_dev: int = 1) -> int:
    """Client-slot count a cohort of `cohort_size` trains at, as the JAX
    package computes it (`hefl_tpu.fl.fedavg.cohort_bucket`): the next power
    of two, rounded to a multiple of `n_dev`, at least 2 * n_dev when the
    full registry trains >= 2 slots a device, capped at the full registry.
    `n_dev` is the client mesh's rank count (`parallel.client_mesh_size`):
    the buckets, and with them the shape of the fused-encrypt launch
    (bucket * n_ct rows), are the JAX package's on that mesh. An oversized
    cohort fails loudly."""
    if cohort_size < 1:
        raise ValueError(
            f"cohort_bucket: cohort_size={cohort_size} must be >= 1"
        )
    if cohort_size > num_clients:
        raise ValueError(
            f"cohort_bucket: cohort of {cohort_size} exceeds the "
            f"{num_clients} registered clients — the sampler cannot have "
            "produced this; refusing to train phantom slots"
        )
    bucket = 1 << (int(cohort_size) - 1).bit_length()   # next power of two
    bucket = -(-bucket // n_dev) * n_dev                # mesh-divisible
    full = -(-num_clients // n_dev) * n_dev             # full-C padded shape
    if full > n_dev:
        bucket = max(bucket, 2 * n_dev)
    return min(bucket, full)


def cohort_gather_index(cohort, bucket: int) -> np.ndarray:
    """Gather index [bucket] into the client rows: the sampled cohort
    first, then client 0's slot repeated for the bucket padding (padding
    slots are scheduled out and never fold)."""
    cohort = np.asarray(cohort, dtype=np.int64)
    idx = np.zeros(int(bucket), np.int64)
    idx[: len(cohort)] = cohort
    return idx


def cohort_block(mesh, cohort, num_clients: int) -> tuple[np.ndarray, int]:
    """This rank's block of a cohort's bucket -> (gather index into the
    clients, count of real rows): the bucket (`cohort_bucket` at the
    client mesh's rank count) is laid out on the client axes like the
    registry, cpd = bucket / ranks slots a rank, the sampled clients first
    and client 0's slot repeated for the padding, so a block's real rows
    lead it. Off a mesh (None): the whole bucket."""
    cohort = np.asarray(cohort, dtype=np.int64)
    n_dev = 1 if mesh is None else client_mesh_size(mesh)
    gidx = cohort_gather_index(cohort, cohort_bucket(len(cohort), num_clients, n_dev))
    if mesh is None:
        return gidx, len(cohort)
    cpd = len(gidx) // n_dev
    lo = client_index(mesh) * cpd
    return gidx[lo: lo + cpd], int(np.clip(len(cohort) - lo, 0, cpd))


def resident_index(gidx, resident_rows, device) -> torch.Tensor:
    """Where the clients `gidx` sit in federated arrays holding the clients
    `resident_rows` (None: the whole registry, where client c is row c) ->
    int64 positions on `device`. A client that is not resident fails: a
    rank trains only what was staged on its card."""
    gidx = np.asarray(gidx, dtype=np.int64)
    if resident_rows is None:
        return torch.from_numpy(gidx).to(device)
    resident = np.asarray(resident_rows, dtype=np.int64)
    first = {}
    for pos, c in enumerate(resident.tolist()):
        first.setdefault(c, pos)
    missing = sorted({int(c) for c in gidx} - set(first))
    if missing:
        raise ValueError(
            f"clients {missing} are not among the rows resident on this rank "
            f"({resident.tolist()}): stage them first (data.RoundPrefetcher)")
    return torch.tensor([first[int(c)] for c in gidx], dtype=torch.int64, device=device)


def pad_index(num_clients: int, n_dev: int) -> np.ndarray | None:
    """Client-axis gather index that pads `num_clients` up to the next
    multiple of `n_dev` by repeating client 0's slot (the padding slots
    train on client 0's data with its recycled generator and are masked
    out of the aggregation). None when no padding is needed."""
    pad = (-num_clients) % n_dev
    if pad == 0:
        return None
    return np.concatenate([np.arange(num_clients), np.zeros(pad, np.int64)])


def pad_federated(xs, ys, n_dev: int):
    """Pad the federated arrays once a run -> (xs, ys, num_real): the rounds
    take `num_real_clients=num_real` with the padded arrays. numpy arrays
    or tensors; a divisible count returns the inputs untouched."""
    num = int(xs.shape[0])
    idx = pad_index(num, n_dev)
    if idx is None:
        return xs, ys, num
    return xs[idx], ys[idx], num


def _round_geometry(xs, n_dev: int, num_real_clients: int | None, resident_rows=None):
    """-> (num_clients, pad_idx, prepadded). `num_real_clients` marks xs as
    padded by `pad_federated`; a row count that disagrees fails (averaging
    padding rows as real clients must never happen). With `resident_rows`
    (xs holds those clients only) `num_real_clients` is the registry's
    size and is required."""
    if resident_rows is not None:
        if num_real_clients is None:
            raise ValueError("resident_rows= needs num_real_clients=, the registry's size")
        if len(resident_rows) != int(xs.shape[0]):
            raise ValueError(f"resident_rows names {len(resident_rows)} clients, the "
                             f"federated arrays hold {int(xs.shape[0])} rows")
        return int(num_real_clients), pad_index(int(num_real_clients), n_dev), True
    if num_real_clients is None:
        num_clients = int(xs.shape[0])
        return num_clients, pad_index(num_clients, n_dev), False
    num_clients = int(num_real_clients)
    pad_idx = pad_index(num_clients, n_dev)
    want = num_clients if pad_idx is None else len(pad_idx)
    if int(xs.shape[0]) != want:
        raise ValueError(
            f"num_real_clients={num_clients} on a {n_dev}-device mesh "
            f"needs federated arrays pre-padded to {want} rows "
            f"(fedavg.pad_federated), got {int(xs.shape[0])}"
        )
    return num_clients, pad_idx, True


def client_block(mesh, num_clients: int, pad_idx) -> tuple[np.ndarray, int]:
    """This rank's clients -> (gather index into the real clients, count of
    real rows). The block is rows block * cpd .. (block + 1) * cpd - 1 of
    the padded registry; padding slots (client 0's, repeated) are a suffix
    of the registry, so a block's real rows lead it. Off a mesh (None):
    every client."""
    padded = np.arange(num_clients) if pad_idx is None else np.asarray(pad_idx, np.int64)
    if mesh is None:
        return padded, num_clients
    cpd = len(padded) // client_mesh_size(mesh)
    lo = client_index(mesh) * cpd
    return padded[lo: lo + cpd], int(np.clip(num_clients - lo, 0, cpd))


def gather_clients(mesh, t: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Every rank's block of a per-client tensor [cpd, ...], in client
    order, -> the real clients' [num_clients, ...] on t's device (one
    all-gather over the client axes, on the mesh's device: NCCL takes no
    host tensor, and the training metrics live on the host). Off a mesh
    (None) or on one rank: t's real rows."""
    group = None if mesh is None else mesh.axes_group(client_axes(mesh))
    if group is None:
        return t[:num_clients]
    buf = t.to(mesh.device).contiguous()
    parts = [torch.empty_like(buf) for _ in range(client_mesh_size(mesh))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts)[:num_clients].to(t.device)


def replicate_on(mesh, tree: dict) -> dict:
    """The mesh's rank 0's parameter dict on every member rank (a broadcast
    over the mesh; the dict itself off a mesh of several ranks)."""
    if mesh is None or mesh.group is None:
        return tree
    out = {}
    for k in sorted(tree):      # one order on every rank, whatever its dict's
        buf = tree[k].detach().clone().contiguous()
        dist.broadcast(buf, dist.get_global_rank(mesh.group, 0), group=mesh.group)
        out[k] = buf
    return {k: out[k] for k in tree}


@scoped(scopes.AGGREGATE)
def plain_mean(p_out: list[dict]) -> dict:
    """The plaintext FedAvg mean of the clients' trained weights (the JAX
    package's all-kept `masked_mean_tree`)."""
    return {k: torch.stack([prm[k] for prm in p_out]).mean(dim=0) for k in p_out[0]}


@scoped(scopes.AGGREGATE)
def masked_mean_tree(global_params: dict, p_out: list[dict], keep: torch.Tensor,
                     total: int, mesh=None) -> tuple[dict, torch.Tensor]:
    """Participation-masked FedAvg mean of the clients' weights, shared by
    the plaintext round and the encrypted round's plain reference.

    keep: bool[C]. The JAX op sequence: mean over clients of
    where(keep, t, 0), then * (total / count) — so an all-kept round is
    bitwise `plain_mean` (where(True, t, 0) selects t, total/count is
    exactly 1.0f). A round where nobody survives returns `global_params`.
    On a mesh of several ranks (`p_out` and `keep` this rank's block, `total`
    the padded registry's size) the block means and the kept count are
    reduced across the client axes, in the JAX package's op sequence.
    -> (aggregated params, surviving count float32)."""
    local = {k: torch.where(keep.reshape((-1,) + (1,) * g.dim()),
                            torch.stack([prm[k] for prm in p_out]),
                            torch.zeros((), dtype=g.dtype, device=g.device)).mean(dim=0)
             for k, g in global_params.items()}
    local[_COUNT] = torch.sum(keep.to(torch.float32)).reshape(1)
    # One rank-ordered reduction carries the block means and the count;
    # off a mesh it returns them, and x / 1 is exact.
    summed = psum_tree(local, mesh)
    n = 1 if mesh is None else client_mesh_size(mesh)
    count = summed.pop(_COUNT).reshape(())
    scale = torch.where(count > 0, torch.tensor(np.float32(total), device=count.device) / count,
                        torch.zeros((), device=count.device))
    out = {k: torch.where(count > 0, (summed[k] / n * scale).to(g.dtype), g)
           for k, g in global_params.items()}
    return out, count


_COUNT = "\0count"     # the kept count's key in the reduced dict (no parameter's name)


def masked_mode(cfg: TrainConfig, num_clients: int, n_dev: int, explicit: bool,
                secure: bool = False) -> bool:
    """The masked-round routing predicate, shared by `fedavg_round`,
    `fl.secure.secure_fedavg_round` and the experiment driver (the rounds'
    return arity follows it). `explicit`: the caller passed a participation
    mask or poison codes; `secure` enables the encrypted-path-only
    on_overflow="exclude" signal. `n_dev`: the client mesh's rank count (a
    count it does not divide pads, and pads run masked)."""
    sanitizing = cfg.max_update_norm > 0 or (secure and cfg.on_overflow == "exclude")
    return explicit or num_clients % n_dev != 0 or sanitizing


def _trivial_mask(participation, poison) -> bool:
    """True when the mask and poison cannot change the round: every client
    in and nobody poisoned, so the round takes the all-clients path."""
    ok = participation is None or bool(np.all(np.asarray(participation) != 0))
    return ok and (poison is None or not np.any(np.asarray(poison)))


def participation_mask(num_clients: int, participation=None) -> np.ndarray:
    """The round's external mask as int32[C] (all ones when none is given)."""
    if participation is None:
        return np.ones(num_clients, np.int32)
    return np.asarray(participation).astype(np.int32).reshape(num_clients)


def fedavg_round(
    model, cfg: TrainConfig, global_params: dict, xs, ys, gen: torch.Generator,
    streams=None, participation=None, poison=None, mesh=None,
    num_real_clients: int | None = None, resident_rows=None,
):
    """One synchronous plaintext FedAvg round: every client trains from the
    global weights (its generator drawn from `gen`, as the encrypted round
    draws its training generators, so both train the same weights), then
    the weights are averaged; `streams` (one (perms, aug) pair per client)
    replaces the drawn training streams.
    -> (new global params, metrics float32[C, E, 4]).

    A participation mask (int[C], 0 = scheduled out), poison codes
    (`faults.POISON_*`[C]) or `cfg.max_update_norm` > 0 route the round
    through the masked engine, which returns a third output, the round's
    `RoundMeta`: poison -> exclusion bits -> `masked_mean_tree`. An all-ones
    mask without poison or norm bound is the all-clients round bit for bit,
    with a full-participation meta.

    `mesh` (a `parallel.Mesh` of several ranks; every member rank calls
    this with the same arguments) trains this rank's block of clients and
    averages across the client axes; a count the mesh does not divide is
    padded (masked). `num_real_clients` marks xs/ys as padded by
    `pad_federated`, `resident_rows` (with `num_real_clients`) as holding
    those clients only (this rank's block: `client_block`'s index). The
    metrics come back for every client on every rank."""
    n_dev = 1 if mesh is None else client_mesh_size(mesh)
    num_clients, pad_idx, _ = _round_geometry(xs, n_dev, num_real_clients, resident_rows)
    explicit = participation is not None or poison is not None
    masked = masked_mode(cfg, num_clients, n_dev, explicit)
    trivial = not masked or (pad_idx is None and cfg.max_update_norm <= 0
                             and _trivial_mask(participation, poison))
    gidx, rows = client_block(mesh, num_clients, pad_idx)
    gens = client_generators(gen, num_clients, xs.device, gidx)
    if n_dev > 1 or resident_rows is not None:      # this rank's block of the registry
        idx = resident_index(gidx, resident_rows, xs.device)
        xs, ys = xs.index_select(0, idx), ys.index_select(0, idx)
    part = participation_mask(num_clients, participation)[gidx]
    part[rows:] = 0                          # padding: scheduled out
    p_out, mets = train_block(
        model, cfg, global_params, xs, ys,
        gens=None if streams is not None else gens,
        streams=None if streams is None else [streams[int(i)] for i in gidx],
        participation=None if trivial else part,
    )
    mets = gather_clients(mesh, mets, num_clients)
    if trivial:
        new = pmean_tree(plain_mean(p_out), mesh)
        return (new, mets) + ((RoundMeta.full_participation(num_clients),) if masked else ())
    with torch.profiler.record_function(scopes.SANITIZE):
        if poison is not None:
            codes = np.asarray(poison).astype(np.int32).reshape(num_clients)[gidx]
            codes[rows:] = 0
            p_out = [poison_tree(prm, int(code)) for prm, code in zip(p_out, codes)]
        bits = exclusion_bits(cfg, global_params, p_out, part)
    new, _ = masked_mean_tree(global_params, p_out, bits == 0, len(gidx) * n_dev, mesh=mesh)
    return new, mets, RoundMeta.from_bits(gather_clients(mesh, bits, num_clients))


@scoped(scopes.EVALUATE)
def evaluate(model, params: dict, x, y, batch_size: int = 32) -> dict:
    """Whole-dataset inference + weighted classification metrics.

    x: uint8[n, H, W, C] tensor (on the model's device), y: int labels.
    -> dict with accuracy / precision / recall / f1."""
    probs = []
    with torch.no_grad():
        for lo in range(0, int(x.shape[0]), batch_size):
            logits = functional_call(model, params, (rescale(x[lo: lo + batch_size]),))
            probs.append(torch.softmax(logits, dim=-1))
    probs = torch.cat(probs).cpu().numpy()
    return classification_metrics(np.asarray(y), probs.argmax(-1))
