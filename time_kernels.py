#!/usr/bin/env python3
"""Time the kernels K1-K7 of any checkout of the port.

    python3 time_kernels.py [TREE] [--hoist-splits]

Holds K1 and K2 at every entry of this checkout's `chip_smoke.NTT_SHAPES`,
K3 at every entry of its `ENC_SHAPES`, K4 at every entry of `DEC_SHAPES`,
K7 at every entry of `TC_SHAPES`, K5 at every entry of `KS_SHAPES` and K6
at every entry of `HOIST_SHAPES`, bitwise against their plain versions
and times them with chip_smoke.py's timer (device time from torch.profiler
kernel events, median of 30 calls, L2 flushed; K5's split by launch; the
wrapper's call time), on the kernels of TREE (a directory
holding `hefl_tpu_torch/`, by default this checkout). So two trees, e.g. a
parent commit unpacked with `git archive` into an ignored directory and
this one, can be compared at the same shapes on one card, run in turns.
With --hoist-splits it also times K6 at every HOIST_SHAPES entry under
every split Q of `cuda_ntt.HOIST_SPLITS` (a tree whose `hoisted_products`
takes a plan), the sweep that `cuda_ntt.hoisted_plan`'s rule is read from.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def main() -> int:
    here = Path(__file__).resolve().parent
    args = [a for a in sys.argv[1:] if a != "--hoist-splits"]
    tree = Path(args[0]).resolve() if args else here
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from hefl_tpu_torch.ckks import cuda_ntt, ntt as ntt_mod

    smoke.log(f"kernels of {Path(cuda_ntt.__file__).parents[2]}")
    cuda_ntt.load_library()
    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = (smoke.ntt_shape_cases(cuda_ntt, ntt_mod, device, 500)
             + smoke.encdec_shape_cases(cuda_ntt, ntt_mod, device, 600)
             + smoke.serving_kernel_cases(cuda_ntt, ntt_mod, 4096, device, 400))
    for case in cases:
        smoke.kernel_record(case, flush, time_plain=False)
    if "--hoist-splits" in sys.argv[1:]:
        for name, _, shape, *_, extra in cases:
            if name != "hoisted_products":
                continue
            times = {q: smoke.device_ms(lambda: extra["at"](split=q), 30, flush)[0]
                     for q in cuda_ntt.HOIST_SPLITS}
            smoke.log(f"  hoisted_products {shape} device ms by split: "
                      + ", ".join(f"Q={q} {ms:.6f}" for q, ms in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
