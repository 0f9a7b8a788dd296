"""Seeded violation: a scan whose carried int32 accumulator overflows only
after enough iterations.

Every SINGLE step is in bounds (the carry grows by at most 2**16 a step, so
a check of one body evaluation stays green), but after ~2**15 of the
100,000 steps the running sum crosses 2**31 and wraps its int32 carrier:
the class of bug the loop fixpoint exists for. The widened carry invariant
exposes the escape, and `--fixture` must exit 1 with a loop-overflow
finding citing the carried `add`.
"""

import torch

RULE = "loop-overflow"


def build(device):
    from torch._higher_order_ops.scan import scan_op

    def creeping_sum(xs):
        # A per-round byte counter accumulated in int32 across a long scan.
        def body(acc, v):
            return [acc + v, acc.clone()]

        total, _ = scan_op(body, [torch.zeros((), dtype=torch.int32, device=xs.device)],
                           [xs], ())
        return total

    return creeping_sum, (torch.full((100000,), 2**16, dtype=torch.int32, device=device),)
