"""Federated client partitioning (the IID split of `hefl_tpu.data.partition`).

`iid_contiguous` reproduces the reference partitioner exactly
(FLPyfhelin.py:75-78, SURVEY.md §2.2): after a single
global shuffle, client i gets the contiguous slice
`[i*ratio : (i+1)*ratio]` with `ratio = n // num_clients` — remainder rows
are DROPPED, a quirk we preserve because it sets the per-client
cardinalities the baseline numbers assume (1600 imgs / 2 clients -> 800).

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


def stack_federated(
    x: np.ndarray, y: np.ndarray, parts: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """-> (x[C, m, H, W, ch], y[C, m]) with m = min part length (rectangular)."""
    m = min(len(p) for p in parts)
    xs = np.stack([x[p[:m]] for p in parts])
    ys = np.stack([y[p[:m]] for p in parts])
    return xs, ys
