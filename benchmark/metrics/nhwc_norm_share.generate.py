"""Share of generation's GroupNorm calls on the card that took the NHWC
kernel: ``nhwc_norm_share.invert``'s reading of the profiled window (%)."""

from benchmark import harness


def read(run):
    return harness.metric_reader("nhwc_norm_share.invert").read(run)
