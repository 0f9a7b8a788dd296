"""Seeded violation: a float32 round-trip inside an exact-integer region.

A packed 62-bit value pushed through float32 loses every bit past the
24-bit mantissa, the corruption `encode_packed` exists to avoid.
`--fixture` must exit 1 with a float-contamination finding.
"""

import torch

RULE = "float-contamination"


def build(device):
    def bad_roundtrip(hi, lo):
        # Recombine, then re-split through float: shears bits 24..62.
        v = hi.to(torch.float32) * 2.0**31 + lo.to(torch.float32)
        return (v * 2.0**-31).to(torch.int32)

    z = torch.zeros((8,), dtype=torch.int32, device=device)
    return bad_roundtrip, (z, z)
