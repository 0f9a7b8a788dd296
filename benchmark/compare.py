"""The numbers that decide `correct`, and their limits.

A round is federated averaging's training step: its state is the global
model, and the round moves it by the decrypted average of the clients'
trained weights. Two stages, each checked by itself:

  * training: the plain reference trains round 1's clients from the same
    inputs (the same weights, images, shuffles and affine draws). It does
    not follow later rounds: 50 Adam steps a client in bfloat16 and in
    float32 part like chaotic trajectories, and by the second round the
    gap is the gap between two trainings, whatever the precision (PERF.md).
  * aggregation (encode, encrypt, the sum mod p, all-reduced across ranks
    on a client mesh, and the owner's decrypt): the reference's plain mean
    of the weights the system's clients uploaded in round 1, which the
    harness reads as the system's training returns them (`harness`), so
    the reference follows this stage from the system's own state.

The numbers:

  * grad1_median_gap: every client's first-step gradient, each leaf
    stacked over the clients, by the median leaf: |‖g_sys‖ - ‖g_ref‖|
    over the larger of the reference leaf's norm and the median leaf's.
    The system's is worked out from its Adam state after that step (first
    moment over 1 - beta1), as the harness reads it. The median, not the
    worst leaf: the worst is whichever small leaf (a first conv, a
    GroupNorm affine) carries most of the backward's rounding on that
    seed, and it wanders from seed to seed;
  * update1_gap: round 1's change of the global model (the first
    "gradient" the server applies), by the worst leaf:
    |‖Δ_sys‖ - ‖Δ_ref‖| over the larger of the reference leaf's norm and
    the median leaf's;
  * agg_gap: the largest absolute difference between the system's
    decrypted round-1 average and the plain mean of its uploads;
  * eval_gap: the evaluation's accuracy as the system reports it, against
    the reference's accuracy of the system's own decrypted weights, in
    test images, worst of the run's rounds (set-up's and the window's).

Diagnostics beside them, never compared (PERF.md and the limits files
give their readings): grad1_gap (the worst leaf's first-gradient gap),
update1_median_gap (round 1's change by the median leaf), loss1_gap and loss1_first_gap (the clients' mean validation loss after
round 1's last and first epoch, as the system reports it, against the
reference's, over the reference's).

Leaves whose reference change is under a thousandth of the median leaf's
are left out of the leaf gaps (a change that small is rounding). Each
number that is compared has a limit in `limits/<workload>.json`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.models import param_spec


def leaf_norms(cfg: dict, flat: torch.Tensor) -> np.ndarray:
    """Each leaf's norm of flat weights [P], or of every row of [C, P]
    together (a leaf stacked over the clients)."""
    out, off = [], 0
    for _, shape, _, _ in param_spec(cfg):
        n = math.prod(shape)
        out.append(float(torch.linalg.vector_norm(flat[..., off: off + n].double())))
        off += n
    return np.array(out)


def leaf_gaps(cfg: dict, sys: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    """Per kept leaf: |‖sys‖ - ‖ref‖| / max(‖ref‖, the median leaf's)."""
    a, b = leaf_norms(cfg, sys), leaf_norms(cfg, ref)
    keep = b >= 1e-3 * np.median(b)
    denom = np.maximum(b, np.median(b[keep]))
    return (np.abs(a - b) / denom)[keep]


def worst_leaf(cfg: dict, sys: torch.Tensor, ref: torch.Tensor) -> str:
    """The name of the leaf whose `leaf_gaps` entry is the largest."""
    a, b = leaf_norms(cfg, sys), leaf_norms(cfg, ref)
    keep = b >= 1e-3 * np.median(b)
    gaps = np.where(keep, np.abs(a - b) / np.maximum(b, np.median(b[keep])), -1.0)
    return param_spec(cfg)[int(np.argmax(gaps))][0]


def numbers(cfg: dict, sys: dict, ref: dict, n_test: int) -> dict:
    """sys: what the system produced — "p0" the starting weights [P], "p1"
    its decrypted weights after round 1, "grad1" its clients' first-step
    gradients [C, P], "loss1" round 1's validation losses [C, E], "acc" its
    reported accuracy each checked round, "agg_ref" the reference's plain
    mean of its round-1 uploads [P]. ref: "finals" the reference's trained
    clients [C, P], "grad1", "loss1", and "acc_of_sys" its accuracy of the
    system's weights each checked round."""
    p0 = sys["p0"]
    d_sys, d_ref = sys["p1"] - p0, ref["finals"].mean(dim=0) - p0

    def loss_gap(epoch):
        a, b = float(np.mean(sys["loss1"][:, epoch])), float(np.mean(ref["loss1"][:, epoch]))
        return abs(a - b) / b

    g_gaps = leaf_gaps(cfg, sys["grad1"], ref["grad1"])
    u_gaps = leaf_gaps(cfg, d_sys, d_ref)
    return {
        "grad1_gap": float(np.max(g_gaps)),
        "grad1_median_gap": float(np.median(g_gaps)),
        "update1_gap": float(np.max(u_gaps)),
        "update1_median_gap": float(np.median(u_gaps)),
        "agg_gap": float((sys["p1"] - sys["agg_ref"]).abs().max()),
        "eval_gap": max(abs(a - b) * n_test for a, b in zip(sys["acc"], ref["acc_of_sys"])),
        "loss1_gap": loss_gap(-1),
        "loss1_first_gap": loss_gap(0),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}) over the numbers the limits
    file compares. A number that is not finite fails."""
    checks, ok = {}, True
    for name, lim in limits["compared"].items():
        v = float(values[name])
        checks[name] = {"value": v, "limit": float(lim["limit"])}
        ok = ok and math.isfinite(v) and v <= float(lim["limit"])
    return ok, checks
