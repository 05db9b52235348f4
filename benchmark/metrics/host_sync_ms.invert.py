"""Host ms a view waits for the device: the program's sync spans (the
frame and depth, then z0, copied to the host; binning's size read-back)
per view inverted (the counter ``invert.views``)."""

from benchmark.program_trace import sync_ms_per


def read(run):
    return sync_ms_per("invert.views")
