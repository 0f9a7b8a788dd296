"""Cross-client fused training: one forward and backward for a round's clients.

Counterpart of `hefl_tpu.fl.fusion`. The per-client loop
(`fl.fedavg.train_clients`, the "vmap" backend: the port's name for the JAX
package's vmapped reference, and the semantics reference) runs C*E*S
training steps a round, one client after another. This module is the
`TrainConfig.client_fusion="fused"` backend: the same local-training
program restructured so that the clients of a round share every step. The
batch is folded over the clients ([C*B, ...]) through `model.folded_apply`
(models.folded: grouped convs over the clients folded into channels,
client-batched dense GEMMs), the augment warp runs once on the folded
batch, and the per-epoch validation pass runs folded too: E*S steps a
round, each one forward and backward for all C clients.

Per-client semantics are kept (the JAX module's list):

  * per-client params, Adam moments and LR-plateau scale, stacked with a
    leading client axis; the Adam update is elementwise, with each client's
    `lr_scale` broadcast into it;
  * the same per-client streams as the loop: each client's
    `client.epoch_index_streams` drawn from that client's generator (or
    given), so the same generators give the same batches and affines;
  * the loss is the sum of the per-client mean cross-entropies plus
    0.5*mu*sum_c ||p_c - g||^2, so ONE backward gives every client its
    exact gradient (client c's parameters touch only client c's term);
  * the Keras-callback transition (`client._epoch_update`) per client at
    each epoch boundary, the validation pass evaluating a stopped client's
    frozen weights;
  * a stopped client's rows still flow through the step, but its update is
    discarded at the next boundary, where it takes its frozen weights back;
  * participation masks (the masked round engine): a scheduled-out client's
    rows also keep flowing through the folded step, but its parameter and
    Adam updates are selected away at every step, so it ships the round's
    global weights unchanged.

Backend selection (`resolve_fusion_backend`): "fused" and "vmap" pin a
backend; "auto" reads the HEFL_CLIENT_FUSION environment variable, then
the winner persisted for this device name (`utils.autoselect`, beside the
kernel libraries in `_build/`), and only on a miss micro-times one
gradient step of both backends on the live device (8 clients x batch 8 of
a 24x24 SmallCNN, best of 3) and persists the winner. The choice is also
cached in-process per device name. `fusion_report()` says what was chosen
and whether it came from the persisted file.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from hefl_tpu_torch.data.augment import apply_affine, rescale, resolve_shift_backend
from hefl_tpu_torch.fl.client import (
    _epoch_update,
    client_shipped_params,
    epoch_index_streams,
    init_client_state,
    train_batch_geometry,
)
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.loss import cross_entropy
from hefl_tpu_torch.fl.optimizer import AdamState, adam_init, adam_update
from hefl_tpu_torch.models.folded import fold_clients, stack_params, unfold_clients
from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.utils.autoselect import device_name as _device_name
from hefl_tpu_torch.utils.autoselect import time_backend as _time_backend

FUSION_BACKENDS = ("fused", "vmap")

# In-process auto-selection state, as the JAX module keeps it: the winner per
# device name, the timings of the last probe, and the last resolved backend.
_AUTO_CHOICE: dict[str, str] = {}
_AUTO_TIMINGS_MS: dict[str, float] | None = None
_AUTO_PERSISTED: bool = False
_LAST_RESOLVED: str | None = None


def supports_fusion(model) -> bool:
    """Does this model implement the client-folded forward?"""
    return hasattr(model, "folded_apply")


def _client_metrics(model, stacked: dict, xf: torch.Tensor, onehot: torch.Tensor):
    """Per-client (mean cross-entropy, accuracy) [C] of the folded batch xf
    under stacked params; onehot [C, b, K]."""
    c = onehot.shape[0]
    logits = unfold_clients(model.folded_apply(stacked, xf, c), c)
    ce = -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean(dim=-1)
    acc = (logits.argmax(-1) == onehot.argmax(-1)).to(torch.float32).mean(dim=-1)
    return ce, acc


def _client_view(params: dict, opt: AdamState, c: int) -> tuple[dict, AdamState]:
    """Client c's slice of the stacked params and Adam state (copies: the
    unmasked step updates the stacked tensors in place)."""
    return ({k: v[c].clone() for k, v in params.items()},
            AdamState(mu={k: v[c].clone() for k, v in opt.mu.items()},
                      nu={k: v[c].clone() for k, v in opt.nu.items()}, step=opt.step))


def _mask_select(keep: torch.Tensor, new: dict, old: dict) -> dict:
    """Per-client select over stacked leaves: keep[c] picks new over old
    for client c's slice."""
    return {k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)), v, old[k])
            for k, v in new.items()}


def fused_step(model, cfg: TrainConfig, params: dict, opt: AdamState, xb: torch.Tensor,
               onehot: torch.Tensor, lr_scale: np.ndarray, anchor: dict,
               keep: torch.Tensor | None = None) -> tuple[dict, AdamState]:
    """One client-folded SGD step over stacked params [C, ...]: the gradient
    of the summed per-client losses (FedProx against `anchor`) on the folded
    batch xb, and each client's Adam update at its `lr_scale` [C]. Without
    a participation mask the update is written into the tensors of `params`
    and `opt` (their storage is kept from step to step, the counterpart of
    the JAX round's donated state); with one, a masked client keeps its old
    rows, so the step is computed out of place. -> (params, opt)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    ce, _ = _client_metrics(model, leaves, xb, onehot)
    loss = ce.sum()
    if cfg.prox_mu > 0.0:
        loss = loss + 0.5 * cfg.prox_mu * torch.stack(
            [torch.sum((leaves[k] - anchor[k]) ** 2) for k in leaves]).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        new_params, new_opt = adam_update(
            grads, opt, {k: v.detach() for k, v in leaves.items()}, cfg.lr, cfg.lr_decay,
            lr_scale, warmup_steps=cfg.warmup_steps, inplace=keep is None,
        )
        if keep is None:
            return new_params, new_opt
        # Scheduled-out clients flow through the step but update nothing.
        return (_mask_select(keep, new_params, params),
                AdamState(mu=_mask_select(keep, new_opt.mu, opt.mu),
                          nu=_mask_select(keep, new_opt.nu, opt.nu), step=new_opt.step))


def fused_train(model, cfg: TrainConfig, global_params: dict, xs: torch.Tensor, ys: torch.Tensor,
                gens=None, streams=None, participation=None):
    """Train a round's clients through the client-folded path.

    The contract of `fedavg.train_clients`: xs uint8[C, m, H, W, ch], ys
    int[C, m] on the training device; `gens` one generator per client, or
    `streams` one (perms, aug) pair per client (`client.epoch_index_streams`).
    `participation` (int[C], 0 = scheduled out; the masked round's mask):
    a 0-masked client's rows still flow through every folded step, but its
    parameter and Adam updates are no-ops, so it ships the global weights
    bit for bit (its callback transitions run on them, as in the JAX
    package's fused backend).
    -> (list of C shipped parameter dicts, metrics float32[C, E, 4] with
    columns val_loss, val_acc, lr_scale, stopped)."""
    num_c, m = int(xs.shape[0]), int(xs.shape[1])
    n_tr, grp, steps = train_batch_geometry(cfg, m)
    if n_tr < 1:
        raise ValueError(
            f"client has {m} sample(s); needs >= 2 to carve out a validation "
            "split (set val_fraction=0 to train on everything)"
        )
    n_val = m - n_tr
    dev = xs.device
    x_tr, y_tr = xs[:, n_val:], ys[:, n_val:]
    x_va, y_va = (xs[:, :n_val], ys[:, :n_val]) if n_val else (x_tr, y_tr)
    oh_tr = F.one_hot(y_tr.to(torch.int64), cfg.num_classes).to(torch.float32)
    oh_va = F.one_hot(y_va.to(torch.int64), cfg.num_classes).to(torch.float32)
    xva = fold_clients(rescale(x_va))
    bk = resolve_shift_backend(cfg.aug_backend, dev) if cfg.augment else None
    if streams is None:
        if gens is None:
            raise TypeError("fused_train needs one generator or one stream pair per client")
        streams = [epoch_index_streams(cfg, g, m) for g in gens]
    perms = torch.stack([s[0].to(dev) for s in streams])                   # [C, T, grp]
    aug = (tuple(torch.stack([s[1][i].to(dev) for s in streams]) for i in range(4))
           if cfg.augment else None)                                         # each [C, T, grp]
    rows_c = torch.arange(num_c, device=dev)[:, None]

    gp = {k: v.detach() for k, v in global_params.items()}
    keep = (None if participation is None else
            torch.as_tensor(np.asarray(participation), device=dev) > 0)
    states = [init_client_state(gp) for _ in range(num_c)]
    params = stack_params(gp, num_c)
    opt = adam_init(params)
    rows = []
    for step in range(cfg.epochs * steps):
        with torch.profiler.record_function(scopes.SGD_CORE):
            idx = perms[:, step]                                             # [C, grp]
            xb = fold_clients(rescale(x_tr[rows_c, idx]))
            if cfg.augment:
                xb = apply_affine(xb, *(a[:, step].reshape(-1) for a in aug), backend=bk)
            lr_scale = np.array([s.lr_scale for s in states], dtype=np.float32)
            params, opt = fused_step(model, cfg, params, opt, xb, oh_tr[rows_c, idx], lr_scale,
                                     gp, keep)
        if step % steps != steps - 1:
            continue
        with torch.profiler.record_function(scopes.VAL):
            # Epoch boundary: validate (a stopped client its frozen weights),
            # then each client's callback transition; a stopped client takes its
            # frozen weights and moments back, discarding its phantom updates.
            frozen = [s.stopped for s in states]
            eval_params = params if not any(frozen) else {
                k: torch.stack([states[c].params[k] if frozen[c] else v[c]
                                for c in range(num_c)])
                for k, v in params.items()}
            with torch.no_grad():
                val_loss, val_acc = (t.cpu().numpy() for t in
                                     _client_metrics(model, eval_params, xva, oh_va))
            epoch_rows = []
            for c in range(num_c):
                p_c, o_c = _client_view(params, opt, c)
                states[c], row = _epoch_update(cfg, states[c], p_c, o_c,
                                               np.float32(val_loss[c]), np.float32(val_acc[c]))
                epoch_rows.append(row)
            rows.append(np.stack(epoch_rows))
            if any(s.stopped for s in states):
                params = {k: torch.stack([s.params[k] for s in states]) for k in params}
                opt = AdamState(
                    mu={k: torch.stack([s.opt.mu[k] for s in states]) for k in opt.mu},
                    nu={k: torch.stack([s.opt.nu[k] for s in states]) for k in opt.nu},
                    step=opt.step)
    metrics = torch.from_numpy(np.stack(rows, axis=1))                      # [C, E, 4]
    return [client_shipped_params(s) for s in states], metrics


# --------------------------------------------------------------- selection

# Micro-timing geometry (the JAX module's): a block of 8 clients of batch 8
# through a 2-conv CNN at 24x24, large enough that the two backends
# separate, small enough to cost well under a second each.
_PROBE_CLIENTS = 8
_PROBE_BATCH = 8
_PROBE_HW = 24


def _autoselect_backend(device: torch.device) -> str:
    """One-shot fused-vs-vmap choice on `device`: the winner persisted for
    its device name, else one gradient step of each backend timed on the
    probe geometry, the winner persisted; cached for the process per
    device name."""
    global _AUTO_TIMINGS_MS, _AUTO_PERSISTED
    name = _device_name(device)
    if name in _AUTO_CHOICE:
        return _AUTO_CHOICE[name]
    from hefl_tpu_torch.models.cnn import SmallCNN
    from hefl_tpu_torch.utils.autoselect import load_winner, store_winner

    hit = load_winner("client_fusion", name, allowed=FUSION_BACKENDS)
    if hit is not None:
        _AUTO_CHOICE[name] = hit["winner"]
        _AUTO_TIMINGS_MS = hit.get("timings_ms")
        _AUTO_PERSISTED = True
        return hit["winner"]

    c, b, hw = _PROBE_CLIENTS, _PROBE_BATCH, _PROBE_HW
    probe = SmallCNN(num_classes=10, input_shape=(hw, hw, 1))
    probe.reset_parameters(torch.Generator().manual_seed(0))
    probe = probe.to(device)
    stacked = stack_params({k: v.detach() for k, v in probe.named_parameters()}, c)
    x = torch.rand((c, b, hw, hw, 1), generator=torch.Generator().manual_seed(1)).to(device)
    oh = F.one_hot(torch.zeros((c, b), dtype=torch.int64), 10).to(torch.float32).to(device)

    def loop_step():
        for i in range(c):
            leaves = {k: v[i].detach().requires_grad_(True) for k, v in stacked.items()}
            ce = cross_entropy(functional_call(probe, leaves, (x[i],)), oh[i])
            torch.autograd.grad(ce, list(leaves.values()))

    def fused_step():
        leaves = {k: v.detach().requires_grad_(True) for k, v in stacked.items()}
        ce, _ = _client_metrics(probe, leaves, fold_clients(x), oh)
        torch.autograd.grad(ce.sum(), list(leaves.values()))

    timings = {"vmap": _time_backend(loop_step, device), "fused": _time_backend(fused_step, device)}
    _AUTO_TIMINGS_MS = {k: round(v * 1e3, 3) for k, v in timings.items()}
    _AUTO_CHOICE[name] = min(timings, key=timings.get)
    store_winner("client_fusion", name, _AUTO_CHOICE[name], _AUTO_TIMINGS_MS)
    return _AUTO_CHOICE[name]


def resolve_fusion_backend(setting: str | None, model, device=None) -> str:
    """The training backend a run trains with, on `device` (where "auto"
    times the two; the CPU by default).

    Priority: an explicit TrainConfig.client_fusion pin > the
    HEFL_CLIENT_FUSION environment variable (read only when the config says
    "auto") > the one-shot micro-timing. A model without `folded_apply`
    makes "auto" fall back to "vmap" and an explicit "fused" an error."""
    global _LAST_RESOLVED
    requested = setting or "auto"
    if requested == "auto":
        requested = os.environ.get("HEFL_CLIENT_FUSION") or "auto"
    if requested not in FUSION_BACKENDS + ("auto",):
        raise ValueError(
            f"client fusion backend {requested!r}: expected one of "
            f"{FUSION_BACKENDS + ('auto',)}"
        )
    if requested == "fused" and not supports_fusion(model):
        raise ValueError(
            f"client_fusion='fused' but {type(model).__name__} has no folded_apply — "
            "implement the client-folded forward (models.folded) or use 'vmap'/'auto'"
        )
    if requested == "auto":
        requested = (_autoselect_backend(torch.device(device or "cpu"))
                     if supports_fusion(model) else "vmap")
    _LAST_RESOLVED = requested
    return requested


def fusion_report() -> dict:
    """Which client-training backend the last resolution chose: the JAX
    record's keys (`auto_persisted`: "auto" took the winner from the
    persisted file instead of timing the backends in this process)."""
    return {
        "requested": os.environ.get("HEFL_CLIENT_FUSION") or "auto",
        "backend": _LAST_RESOLVED,
        "auto_timings_ms": _AUTO_TIMINGS_MS,
        "auto_persisted": _AUTO_PERSISTED,
    }
