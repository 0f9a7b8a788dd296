"""Device seconds of the profiled round's client training: the kernels
launched inside `hefl.sgd_core`, `hefl.augment` and `hefl.val`."""

PHASES = ("hefl.sgd_core", "hefl.augment", "hefl.val")


def read(view):
    us = view.trace.busy_us(PHASES)
    return us / 1e6 if us > 0 else None
