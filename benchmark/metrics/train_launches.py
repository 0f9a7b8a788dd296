"""Device kernels of the profiled round launched inside the client
training ranges (`hefl.sgd_core`, `hefl.augment`, `hefl.val`)."""

PHASES = ("hefl.sgd_core", "hefl.augment", "hefl.val")


def read(view):
    n = view.trace.kernels(PHASES)
    return n if n > 0 else None
