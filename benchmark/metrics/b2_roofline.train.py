"""The blend backward's frozen bound (pairs counted on the reference's binning
of the same inputs) over kernel B2's device time in the profiled window (%)."""

from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "b2_bound_s", "b2_kernel")
