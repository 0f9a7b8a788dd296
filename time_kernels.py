#!/usr/bin/env python3
"""Time the kernels K1-K7 of any checkout of the port.

    python3 time_kernels.py [TREE] [--hoist-splits]

Holds K1 and K2 at every entry of this checkout's `bench_ntt.NTT_SHAPES`,
K3 at every entry of its `ENC_SHAPES`, K4 at every entry of `DEC_SHAPES`,
K7 at every entry of `TC_SHAPES`, K5 at every entry of `KS_SHAPES` and K6
at every entry of `HOIST_SHAPES`, bitwise against their plain versions
and times them with this checkout's timer (`utils/roofline.py`: device
time from torch.profiler kernel events, median of 30 calls, L2 flushed;
K5's split by launch; the wrapper's call time), on the kernels of TREE (a
directory holding `hefl_tpu_torch/`, by default this checkout). So two
trees, e.g. a parent commit unpacked with `git archive` into an ignored
directory and this one, can be compared at the same shapes on one card,
run in turns. With --hoist-splits it also times K6 at every HOIST_SHAPES
entry under every split Q of `cuda_ntt.HOIST_SPLITS` (a tree whose
`hoisted_products` takes a plan), the sweep that `cuda_ntt.hoisted_plan`'s
rule is read from. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

# This checkout's timer and shape lists, loaded from their files and
# registered under their package names before TREE's package is imported,
# so the kernels of TREE are timed by this checkout's code.
_OWN = ("hefl_tpu_torch.utils.roofline", "hefl_tpu_torch.bench_ntt")


def _load_own(here: Path) -> dict:
    mods = {}
    for name in _OWN:
        path = here.joinpath(*name.split(".")).with_suffix(".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        mods[name.rsplit(".", 1)[1]] = mod
    return mods


def main() -> int:
    here = Path(__file__).resolve().parent
    args = [a for a in sys.argv[1:] if a != "--hoist-splits"]
    tree = Path(args[0]).resolve() if args else here
    sys.path.insert(0, str(tree))
    own = _load_own(here)
    roofline, bench = own["roofline"], own["bench_ntt"]

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from hefl_tpu_torch.ckks import cuda_ntt, ntt as ntt_mod

    roofline.log(f"kernels of {Path(cuda_ntt.__file__).parents[2]}")
    cuda_ntt.load_library()
    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = (bench.ntt_shape_cases(cuda_ntt, ntt_mod, device, 500)
             + bench.encdec_shape_cases(cuda_ntt, ntt_mod, device, 600)
             + bench.serving_kernel_cases(cuda_ntt, ntt_mod, 4096, device, 400))
    for case in cases:
        bench.kernel_record(case, flush, time_plain=False)
    if "--hoist-splits" in sys.argv[1:]:
        for name, _, shape, *_, extra in cases:
            if name != "hoisted_products":
                continue
            times = {q: roofline.device_ms(lambda: extra["at"](split=q), 30, flush)[0]
                     for q in cuda_ntt.HOIST_SPLITS}
            roofline.log(f"  hoisted_products {shape} device ms by split: "
                         + ", ".join(f"Q={q} {ms:.6f}" for q, ms in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
