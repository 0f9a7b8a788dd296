"""Seeded violation: a declared in-place accumulator that returns a copy.

The running sum is "updated" out of place, so every fold allocates a new
buffer and the declared storage is never reused. `--fixture` must exit 1
with a broken-donation finding.
"""

import torch

RULE = "broken-donation"
DONATE = (0,)


def build(device):
    def broken(state, x):
        return state + x          # not state.add_(x)

    return broken, (torch.zeros((16,), device=device), torch.ones((16,), device=device))
