"""Device milliseconds of the collectives on rank 0 in the profiled round:
the NCCL kernels (all-reduce of the ciphertext sums, the broadcast of the
new model, the gathers of the metrics). Nothing on one chip."""


def read(view):
    ops = [(s, e) for name, cat, s, e, _ in view.trace.in_window()
           if cat == "kernel" and "nccl" in name.lower()]
    if not ops:
        return None
    from benchmark.tracing import length
    return length(ops) / 1e3
