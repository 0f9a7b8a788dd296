"""The round's training FLOPs (`yardsticks.train_flops`, counted from the
configuration's layer shapes) over the unprofiled window's round time,
the chips and the dense bf16 peak, in percent."""

from benchmark.yardsticks import PEAK_BF16_FLOPS


def read(view):
    return 100.0 * view.train_flops / (view.round_s * view.chips * PEAK_BF16_FLOPS)
