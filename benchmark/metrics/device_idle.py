"""Share of the profiled round's wall (its `bench.round` range on the
host) in which no device op ran, in percent."""


def read(view):
    lo, hi = view.trace.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - view.trace.busy_us() / (hi - lo))
