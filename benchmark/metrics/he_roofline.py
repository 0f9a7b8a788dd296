"""The round's HE work against its memory-bandwidth bound, in percent:
the least bytes it must move (`yardsticks.he_bytes`) over the card's HBM
rate, divided by the device time of the HE ranges. Nothing when the
trace holds no HE device time."""

from benchmark.yardsticks import HBM_BYTES_PER_S

PHASES = ("hefl.encrypt", "hefl.psum_aggregate", "hefl.decrypt")


def read(view):
    us = view.trace.busy_us(PHASES)
    if us <= 0:
        return None
    return 100.0 * (view.he_bytes / HBM_BYTES_PER_S) / (us / 1e6)
