"""Client training across a round, the plaintext FedAvg round, and
evaluation, on one device.

Counterpart of `hefl_tpu.fl.fedavg` for the all-clients-present round.
The JAX package lays clients out on a "clients" mesh axis; on one GPU a
round's clients train through `train_block`, the one training body of the
plaintext round, the encrypted round (`secure.client_uploads`) and the
streaming round, under the configured backend
(`TrainConfig.client_fusion`, `fl.fusion`): "vmap", the per-client loop
`train_clients` over the leading axis of the federated arrays, or "fused",
`fusion.fused_train`.

The participation-masked engine (`masked_mode`): a participation mask or
poison codes (`fl.faults`), or a `max_update_norm` bound, route a round
through poison -> `faults.exclusion_bits` -> `masked_mean_tree`, and the
round returns its `faults.RoundMeta` too. A clean schedule (every client
in, no poison, no sanitizing knob) takes the all-clients path bit for bit.
The JAX package also pads a client count that does not divide its mesh
with masked-out slots (`pad_index`, `pad_federated`); one GPU is one
device, so no count needs padding and those have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from hefl_tpu_torch.data.augment import rescale
from hefl_tpu_torch.fl.client import local_train
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.faults import RoundMeta, exclusion_bits, poison_tree
from hefl_tpu_torch.fl.fusion import fused_train, resolve_fusion_backend
from hefl_tpu_torch.fl.metrics import classification_metrics


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
    The port runs one device (n_dev = 1), so its buckets — and with them
    the shape of the fused-encrypt launch (bucket * n_ct rows) — are the
    JAX package's on one device. An oversized cohort fails loudly."""
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


def plain_mean(p_out: list[dict]) -> dict:
    """The plaintext FedAvg mean of the clients' trained weights (the JAX
    package's all-kept `masked_mean_tree`)."""
    return {k: torch.stack([prm[k] for prm in p_out]).mean(dim=0) for k in p_out[0]}


def masked_mean_tree(global_params: dict, p_out: list[dict], keep: torch.Tensor,
                     total: int) -> tuple[dict, torch.Tensor]:
    """Participation-masked FedAvg mean of the clients' weights, shared by
    the plaintext round and the encrypted round's plain reference.

    keep: bool[C]. The JAX op sequence: mean over clients of
    where(keep, t, 0), then * (total / count) — so an all-kept round is
    bitwise `plain_mean` (where(True, t, 0) selects t, total/count is
    exactly 1.0f). A round where nobody survives returns `global_params`.
    -> (aggregated params, surviving count float32)."""
    count = torch.sum(keep.to(torch.float32))
    scale = torch.where(count > 0, torch.tensor(np.float32(total), device=count.device) / count,
                        torch.zeros((), device=count.device))
    out = {}
    for k, g in global_params.items():
        t = torch.stack([prm[k] for prm in p_out])
        sel = keep.reshape((-1,) + (1,) * (t.dim() - 1))
        mean = torch.where(sel, t, torch.zeros((), dtype=t.dtype, device=t.device)).mean(dim=0)
        out[k] = torch.where(count > 0, (mean * scale).to(t.dtype), g)
    return out, count


def masked_mode(cfg: TrainConfig, num_clients: int, n_dev: int, explicit: bool,
                secure: bool = False) -> bool:
    """The masked-round routing predicate, shared by `fedavg_round`,
    `fl.secure.secure_fedavg_round` and the experiment driver (the rounds'
    return arity follows it). `explicit`: the caller passed a participation
    mask or poison codes; `secure` enables the encrypted-path-only
    on_overflow="exclude" signal. The port runs one device (n_dev = 1)."""
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
    streams=None, participation=None, poison=None,
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
    with a full-participation meta."""
    num_clients = int(xs.shape[0])
    explicit = participation is not None or poison is not None
    masked = masked_mode(cfg, num_clients, 1, explicit)
    gens = client_generators(gen, num_clients, xs.device)
    trivial = not masked or (cfg.max_update_norm <= 0 and _trivial_mask(participation, poison))
    part = participation_mask(num_clients, participation)
    p_out, mets = train_block(
        model, cfg, global_params, xs, ys,
        gens=None if streams is not None else gens, streams=streams,
        participation=None if trivial else part,
    )
    if not masked:
        return plain_mean(p_out), mets
    if trivial:
        return plain_mean(p_out), mets, RoundMeta.full_participation(num_clients)
    if poison is not None:
        p_out = [poison_tree(prm, int(code)) for prm, code in zip(p_out, np.asarray(poison))]
    bits = exclusion_bits(cfg, global_params, p_out, part)
    new, _ = masked_mean_tree(global_params, p_out, bits == 0, num_clients)
    return new, mets, RoundMeta.from_bits(bits)


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
