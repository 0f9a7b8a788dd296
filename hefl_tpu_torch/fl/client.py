"""Client-local training with Keras-callback semantics.

Counterpart of `hefl_tpu.fl.client` in its flat-scan layout, written as a
Python loop: E*S SGD steps over precomputed shuffles and augment params,
and at the last step of each epoch the validation pass and the callback
transition (`_epoch_update`): early stopping on val loss, ReduceLROnPlateau,
and the best-val-loss restore, which the shipped weights take only when the
client actually stopped early (`client_shipped_params`). The loss carries
the FedProx term against the round's global weights when
`TrainConfig.prox_mu > 0`. `train_centralized` runs the same loop on the
whole training set and restores the best-by-accuracy weights (the
reference's `train_server` baseline).

Validation is the HEAD `val_fraction` of the client's samples (Keras
`validation_split`). Once a client has stopped, the JAX package still runs
its (discarded) steps in lockstep with the other clients; here the stopped
client skips them, which leaves every output unchanged.

Streams: `local_train` takes (perms int64[E*S, grp], aug) where aug is a
tuple (s, zx, zy, f) of float32[E*S, grp] or None when augmentation is off,
so a test can feed it the JAX package's `epoch_index_streams`; without
streams it draws its own from a `torch.Generator` (`epoch_index_streams`).

Chunks: `local_train_epochs` advances a `ClientState` by the epochs whose
streams it is given (`split_epoch_streams` of the streams drawn once for
all epochs), so a run checkpointed between chunks ends where the unchunked
`local_train` ends.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from hefl_tpu_torch.data.augment import apply_affine, draw_affine_params, rescale
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.loss import accuracy, cross_entropy, loss_fn
from hefl_tpu_torch.fl.optimizer import AdamState, adam_init, adam_update
from hefl_tpu_torch.obs import scopes


def train_batch_geometry(cfg: TrainConfig, n_samples: int) -> tuple[int, int, int]:
    """-> (n_tr, grp, steps): training samples, samples per step, steps per
    epoch; (n_tr, 0, 0) when the client is too small to train."""
    n_val = max(int(n_samples * cfg.val_fraction), 1) if cfg.val_fraction > 0 else 0
    n_tr = n_samples - n_val
    if n_tr < 1:
        return n_tr, 0, 0
    grp = min(cfg.batch_size, n_tr)
    return n_tr, grp, max(n_tr // grp, 1)


def epoch_index_streams(cfg: TrainConfig, gen: torch.Generator, n_samples: int):
    """One client's shuffle/augment streams for `cfg.epochs` epochs, on the
    generator's device: -> (perms int64[E*S, grp], aug or None)."""
    n_tr, grp, steps = train_batch_geometry(cfg, int(n_samples))
    dev = gen.device
    perms = torch.stack([
        torch.randperm(n_tr, generator=gen, device=dev)[: steps * grp].reshape(steps, grp)
        for _ in range(cfg.epochs)
    ]).reshape(cfg.epochs * steps, grp)
    if not cfg.augment:
        return perms, None
    draws = [
        draw_affine_params(gen, grp, cfg.aug_shear, cfg.aug_zoom, cfg.aug_flip)
        for _ in range(cfg.epochs * steps)
    ]
    aug = tuple(torch.stack([d[i] for d in draws]) for i in range(4))
    return perms, aug


@dataclasses.dataclass
class ClientState:
    params: dict
    opt: AdamState
    lr_scale: np.float32           # ReduceLROnPlateau multiplier
    best_params: dict              # ModelCheckpoint best-by-val-acc (centralized only)
    best_loss_params: dict         # EarlyStopping best-by-val-loss (restore target)
    best_val_acc: np.float32
    best_val_loss: np.float32
    wait_es: int                   # epochs since val-loss improvement (early stop)
    wait_plateau: int              # epochs since val-loss improvement (LR plateau)
    stopped: bool


def init_ef_residuals(template_params: dict, num_clients: int) -> torch.Tensor:
    """Fresh error-feedback residual state: one float32 row per REGISTERED
    client over the model's parameter count, all zeros, on the parameters'
    device — the first EF round quantizes the bare update, as the plain
    quantizer does. Not a `ClientState` field: that state lives one round,
    while the residual is the quantizer's memory across rounds, which
    `fl.stream.StreamEngine` owns."""
    total = sum(int(v.numel()) for v in template_params.values())
    dev = next(iter(template_params.values())).device
    return torch.zeros((int(num_clients), total), dtype=torch.float32, device=dev)


def init_client_state(global_params: dict) -> ClientState:
    return ClientState(
        params=global_params,
        opt=adam_init(global_params),
        lr_scale=np.float32(1.0),
        best_params=global_params,
        best_loss_params=global_params,
        best_val_acc=np.float32(-np.inf),
        best_val_loss=np.float32(np.inf),
        wait_es=0,
        wait_plateau=0,
        stopped=False,
    )


def _epoch_update(cfg: TrainConfig, state: ClientState, params, opt, val_loss, val_acc,
                  track_best_acc: bool = False):
    """The Keras-callback transition at an epoch boundary (the JAX package's
    `_epoch_update`, client.py:175-240; the best-by-accuracy copy only with
    `track_best_acc`, since clients never read it) -> (next state, metrics
    row [val_loss, val_acc, lr_scale, stopped])."""
    f32 = np.float32
    if state.stopped:                       # frozen: nothing moves
        row = [val_loss, val_acc, state.lr_scale, f32(1.0)]
        return state, np.array(row, dtype=np.float32)
    loss_improved = bool(val_loss < state.best_val_loss - f32(cfg.min_delta))
    acc_improved = bool(val_acc > state.best_val_acc)
    wait_es = 0 if loss_improved else state.wait_es + 1
    wait_pl = 0 if loss_improved else state.wait_plateau + 1
    lr_scale = state.lr_scale
    if wait_pl >= cfg.plateau_patience:
        lr_floor = f32(cfg.min_lr / cfg.lr if cfg.lr > 0 else 0.0)
        lr_scale = max(f32(state.lr_scale * f32(cfg.plateau_factor)), lr_floor)
        wait_pl = 0
    new = ClientState(
        params=params,
        opt=opt,
        lr_scale=f32(lr_scale),
        best_params=params if track_best_acc and acc_improved else state.best_params,
        best_loss_params=params if loss_improved else state.best_loss_params,
        best_val_acc=max(val_acc, state.best_val_acc),
        best_val_loss=min(val_loss, state.best_val_loss),
        wait_es=wait_es,
        wait_plateau=wait_pl,
        stopped=wait_es >= cfg.es_patience,
    )
    row = [val_loss, val_acc, new.lr_scale, f32(new.stopped)]
    return new, np.array(row, dtype=np.float32)


def client_shipped_params(state: ClientState) -> dict:
    """The weights a client uploads after fit: the best-val-loss weights only
    when it stopped early, else its final-epoch weights (the reference's
    EarlyStopping(restore_best_weights=True) under TF 2.x)."""
    return state.best_loss_params if state.stopped else state.params


def _eval_metrics(model, params, x_u8, onehot):
    with torch.no_grad():
        logits = functional_call(model, params, (rescale(x_u8),))
        return cross_entropy(logits, onehot), accuracy(logits, onehot)


def split_epoch_streams(streams, epochs: int) -> list:
    """(perms [E*S, grp], aug or None) -> E per-epoch (perms [S, grp], aug)
    pairs: views of the streams drawn once for all epochs, so a run that
    trains them in chunks consumes exactly the streams of an unchunked one."""
    perms, aug = streams
    steps = int(perms.shape[0]) // epochs if epochs else 0
    return [(perms[e * steps:(e + 1) * steps],
             None if aug is None else tuple(a[e * steps:(e + 1) * steps] for a in aug))
            for e in range(epochs)]


def _require_trainable(cfg: TrainConfig, n_samples: int) -> None:
    if train_batch_geometry(cfg, n_samples)[0] < 1:
        raise ValueError(
            f"client has {n_samples} sample(s); needs >= 2 to carve out a "
            "validation split (set val_fraction=0 to train on everything)"
        )


def train_step(model, cfg: TrainConfig, params: dict, opt: AdamState, lr_scale, x_u8,
               onehot, aug, anchor: dict) -> tuple[dict, AdamState]:
    """One SGD step: rescale the uint8 batch, warp it (`aug` = one step's
    (s, zx, zy, f), when `cfg.augment`), the loss gradient (FedProx against
    `anchor`) and the Adam update at `lr_scale` -> (params, opt)."""
    xb = rescale(x_u8)
    if cfg.augment:
        xb = apply_affine(xb, *aug)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = loss_fn(model, leaves, xb, onehot, anchor, cfg.prox_mu)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        return adam_update(grads, opt, {k: v.detach() for k, v in leaves.items()}, cfg.lr,
                           cfg.lr_decay, lr_scale, warmup_steps=cfg.warmup_steps)


def local_train_epochs(
    model: torch.nn.Module,
    cfg: TrainConfig,
    global_params: dict,
    x: torch.Tensor,
    y: torch.Tensor,
    state: ClientState,
    epoch_streams: list,
    track_best_acc: bool = True,
) -> tuple[ClientState, torch.Tensor]:
    """Advance one client by `len(epoch_streams)` epochs from `state`.

    The chunk-resume primitive (`hefl_tpu.fl.client.local_train_epochs`):
    a driver that trains in chunks draws the streams of all `cfg.epochs`
    epochs once (`epoch_index_streams`), slices `split_epoch_streams` of
    them, checkpoints the returned ClientState between chunks, and ends
    with exactly the state, and so the upload (`client_shipped_params`),
    of an unchunked `local_train`. `global_params` is the round's global
    weights (the FedProx anchor). -> (state, metrics float32[len, 4]
    with columns val_loss, val_acc, lr_scale, stopped)."""
    n_samples = int(x.shape[0])
    _require_trainable(cfg, n_samples)
    n_tr, _, steps = train_batch_geometry(cfg, n_samples)
    n_val = n_samples - n_tr
    x_tr, y_tr = x[n_val:], y[n_val:]
    x_va, y_va = (x[:n_val], y[:n_val]) if n_val else (x_tr, y_tr)
    oh_tr = F.one_hot(y_tr.to(torch.int64), cfg.num_classes).to(torch.float32)
    oh_va = F.one_hot(y_va.to(torch.int64), cfg.num_classes).to(torch.float32)
    global_params = {k: v.detach() for k, v in global_params.items()}
    params, opt = state.params, state.opt
    rows = []
    for perms, aug in epoch_streams:
        perms = perms.to(x.device)
        if cfg.augment:
            aug = tuple(a.to(x.device) for a in aug)
        for step in range(steps):
            if state.stopped:
                continue
            with torch.profiler.record_function(scopes.SGD_CORE):
                idx = perms[step]
                params, opt = train_step(
                    model, cfg, params, opt, state.lr_scale, x_tr[idx], oh_tr[idx],
                    tuple(a[step] for a in aug) if cfg.augment else None, global_params)
        with torch.profiler.record_function(scopes.VAL):
            # a stopped client evaluates the weights it keeps (its frozen ones)
            eval_params = state.params if state.stopped else params
            val_loss, val_acc = _eval_metrics(model, eval_params, x_va, oh_va)
            state, row = _epoch_update(
                cfg, state, params, opt,
                np.float32(val_loss.item()), np.float32(val_acc.item()), track_best_acc,
            )
            params, opt = state.params, state.opt
            rows.append(row)
    metrics = (torch.from_numpy(np.stack(rows)) if rows
               else torch.zeros((0, 4), dtype=torch.float32))
    return state, metrics


def _fit(model, cfg: TrainConfig, global_params: dict, x, y, gen, streams,
         track_best_acc: bool) -> tuple[ClientState, torch.Tensor]:
    """All `cfg.epochs` epochs from the global weights, as one chunk: the
    loop shared by `local_train` and `train_centralized` -> (final
    ClientState, metrics float32[E, 4])."""
    _require_trainable(cfg, int(x.shape[0]))
    if streams is None:
        if gen is None:
            raise TypeError("local_train needs a generator or precomputed streams")
        streams = epoch_index_streams(cfg, gen, int(x.shape[0]))
    global_params = {k: v.detach() for k, v in global_params.items()}
    return local_train_epochs(model, cfg, global_params, x, y, init_client_state(global_params),
                              split_epoch_streams(streams, cfg.epochs), track_best_acc)


def local_train(
    model: torch.nn.Module,
    cfg: TrainConfig,
    global_params: dict,
    x: torch.Tensor,
    y: torch.Tensor,
    gen: torch.Generator | None = None,
    streams=None,
):
    """Train one client from the global weights.

    x: uint8[m, H, W, C]; y: int[m] (both on the training device);
    `global_params` a parameter dict of `model` (`model.named_parameters()`
    names), also the FedProx anchor. -> (shipped params dict, metrics
    float32[E, 4] with columns val_loss, val_acc, lr_scale, stopped).
    """
    state, metrics = _fit(model, cfg, global_params, x, y, gen, streams, track_best_acc=False)
    return client_shipped_params(state), metrics


def train_centralized(
    model: torch.nn.Module,
    cfg: TrainConfig,
    params: dict,
    x: torch.Tensor,
    y: torch.Tensor,
    gen: torch.Generator | None = None,
    streams=None,
):
    """Centralized (non-federated) baseline trainer — `train_server`
    (FLPyfhelin.py:161-177): the whole dataset, one model, the same
    callback semantics, and after fit the best-by-ACCURACY weights (its
    ModelCheckpoint reload), unlike a client's upload.
    -> (best params dict, metrics float32[E, 4])."""
    state, metrics = _fit(model, cfg, params, x, y, gen, streams, track_best_acc=True)
    return state.best_params, metrics
