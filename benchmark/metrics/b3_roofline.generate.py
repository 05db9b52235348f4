"""Frozen bound of the profiled chunk's attention calls over kernel B3's device time (%)."""

from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "b3_bound_s", "b3_kernel")
