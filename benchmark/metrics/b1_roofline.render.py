"""The blend forward's frozen bound (pairs counted on the reference's binning
of the same inputs) over kernel B1's device time in the profiled window (%)."""

from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "b1_bound_s", "b1_kernel")
