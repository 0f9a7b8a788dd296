"""Client training across a round, the plaintext FedAvg round, and
evaluation, on one device.

Counterpart of `hefl_tpu.fl.fedavg` for the all-clients-present round.
The JAX package lays clients out on a "clients" mesh axis; on one GPU a
round's clients train through `train_block`, the one training body of the
plaintext round, the encrypted round (`secure.client_uploads`) and the
streaming round, under the configured backend
(`TrainConfig.client_fusion`, `fl.fusion`): "vmap", the per-client loop
`train_clients` over the leading axis of the federated arrays, or "fused",
`fusion.fused_train`. The participation-masked engine (participation
masks, poisoning, padded client slots) is not ported (ROADMAP M10):
`fedavg_round` is the all-clients-present round only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from hefl_tpu_torch.data.augment import rescale
from hefl_tpu_torch.fl.client import local_train
from hefl_tpu_torch.fl.config import TrainConfig
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
    model, cfg: TrainConfig, global_params: dict, xs, ys, gens=None, streams=None
):
    """Train a round's clients under `cfg.client_fusion` (resolved on xs's
    device; a run resolves "auto" once and passes the pin): the fused
    backend (`fusion.fused_train`) or the per-client loop (`train_clients`).
    Same arguments and result as `train_clients`."""
    if resolve_fusion_backend(cfg.client_fusion, model, xs.device) == "fused":
        return fused_train(model, cfg, global_params, xs, ys, gens=gens, streams=streams)
    return train_clients(model, cfg, global_params, xs, ys, gens=gens, streams=streams)


def client_generators(gen: torch.Generator, count: int, device) -> list[torch.Generator]:
    """`count` generators on `device`, seeded by draws from `gen`."""
    seeds = torch.randint(0, 2**62, (count,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def plain_mean(p_out: list[dict]) -> dict:
    """The plaintext FedAvg mean of the clients' trained weights (the JAX
    package's all-kept `masked_mean_tree`)."""
    return {k: torch.stack([prm[k] for prm in p_out]).mean(dim=0) for k in p_out[0]}


def fedavg_round(
    model, cfg: TrainConfig, global_params: dict, xs, ys, gen: torch.Generator,
    streams=None,
):
    """One synchronous plaintext FedAvg round: every client trains from the
    global weights (its generator drawn from `gen`, as the encrypted round
    draws its training generators, so both train the same weights), then
    the weights are averaged; `streams` (one (perms, aug) pair per client)
    replaces the drawn training streams.
    -> (new global params, metrics float32[C, E, 4])."""
    gens = client_generators(gen, int(xs.shape[0]), xs.device)
    p_out, mets = train_block(
        model, cfg, global_params, xs, ys,
        gens=None if streams is not None else gens, streams=streams,
    )
    return plain_mean(p_out), mets


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
