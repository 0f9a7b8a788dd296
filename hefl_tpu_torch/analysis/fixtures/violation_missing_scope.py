"""Seeded violation: a matrix product outside every `hefl.*` range.

Its device time lands in the unattributed bucket of a trace.
`--fixture` must exit 1 with a missing-scope finding.
"""

import torch

RULE = "missing-scope"


def build(device):
    def unscoped_gemm(x, w):
        return torch.tanh(x @ w)

    return unscoped_gemm, (torch.zeros((4, 16), device=device),
                          torch.zeros((16, 8), device=device))
