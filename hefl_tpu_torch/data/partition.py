"""Federated client partitioning (`hefl_tpu.data.partition`).

`iid_contiguous` reproduces the reference partitioner exactly
(FLPyfhelin.py:75-78, SURVEY.md §2.2): after a single
global shuffle, client i gets the contiguous slice
`[i*ratio : (i+1)*ratio]` with `ratio = n // num_clients` — remainder rows
are DROPPED, a quirk we preserve because it sets the per-client
cardinalities the baseline numbers assume (1600 imgs / 2 clients -> 800).

`label_skew` is the non-IID split of the `medical-skew` preset:
Dirichlet(alpha) class proportions per client, with a guarantee that every
client gets at least one sample. It draws from numpy's
`default_rng(seed)` exactly as the JAX package does, so the same seed gives
the same index arrays.

`stack_federated` turns per-client index lists into one dense
[num_clients, per_client, ...] array — equal per-client length, static
shapes — which the round takes as its client batch axis.
"""

from __future__ import annotations

import numpy as np


def iid_contiguous(n: int, num_clients: int) -> list[np.ndarray]:
    """Contiguous equal slices, remainder dropped (FLPyfhelin.py:75-78)."""
    ratio = n // num_clients
    return [np.arange(i * ratio, (i + 1) * ratio) for i in range(num_clients)]


def client_slice(n: int, index: int, num_clients: int) -> np.ndarray:
    """Single client's slice — the direct `get_train_data(index)` analog."""
    return iid_contiguous(n, num_clients)[index]


def label_skew(
    labels: np.ndarray, num_clients: int, alpha: float = 0.5, seed: int = 0
) -> list[np.ndarray]:
    """Dirichlet label-skew non-IID partition.

    For each class, sample p ~ Dir(alpha * 1_K) and deal that class's
    samples to clients proportionally. Lower alpha = more skew. The round
    takes rectangular federated arrays, so short clients are padded UP to
    the longest client's size by resampling (with replacement) from their
    own pool — no sample is ever discarded.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    per_client: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
        for client, part in enumerate(np.split(idx, cuts)):
            per_client[client].extend(part.tolist())
    # guarantee non-empty: steal one sample for any empty client (the donor
    # must keep at least one — fewer samples than clients can't be repaired)
    for i, lst in enumerate(per_client):
        if not lst:
            donor = max(range(num_clients), key=lambda j: len(per_client[j]))
            if len(per_client[donor]) < 2:
                raise ValueError(
                    f"cannot partition {len(labels)} samples over {num_clients} clients"
                )
            lst.append(per_client[donor].pop())
    size = max(len(lst) for lst in per_client)
    out = []
    for lst in per_client:
        arr = np.asarray(lst)
        if len(arr) < size:
            arr = np.concatenate([arr, rng.choice(arr, size - len(arr), replace=True)])
        rng.shuffle(arr)
        out.append(arr)
    return out


def train_val_split(idx: np.ndarray, val_fraction: float = 0.1):
    """Head-held-out validation split, mirroring Keras
    `validation_split=0.1`: the FIRST `val_fraction` of rows validate, so
    val = idx[:n_val]."""
    n_val = int(len(idx) * val_fraction)
    return idx[n_val:], idx[:n_val]


def stack_federated(
    x: np.ndarray, y: np.ndarray, parts: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """-> (x[C, m, H, W, ch], y[C, m]) with m = min part length (rectangular)."""
    m = min(len(p) for p in parts)
    xs = np.stack([x[p[:m]] for p in parts])
    ys = np.stack([y[p[:m]] for p in parts])
    return xs, ys
