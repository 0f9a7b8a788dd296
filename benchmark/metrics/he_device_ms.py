"""Device milliseconds of the profiled round's HE work: the ops launched
inside `hefl.encrypt`, `hefl.psum_aggregate` and `hefl.decrypt`."""

PHASES = ("hefl.encrypt", "hefl.psum_aggregate", "hefl.decrypt")


def read(view):
    us = view.trace.busy_us(PHASES)
    return us / 1e3 if us > 0 else None
