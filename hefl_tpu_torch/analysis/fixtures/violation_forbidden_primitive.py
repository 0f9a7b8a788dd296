"""Seeded violation: a remainder inside a declared exact-integer region.

The regression the gate exists for: a refactor swapping the division-free
Barrett reduction back to an integer remainder (one divide per element).
`--fixture` must exit 1 with a forbidden-primitive finding.
"""

import torch

RULE = "forbidden-primitive"


def build(device):
    p = torch.full((8,), 2**27 - 39, dtype=torch.int64, device=device)

    def bad_mod(x):
        return x % p

    return bad_mod, (torch.zeros((8,), dtype=torch.int64, device=device),)
