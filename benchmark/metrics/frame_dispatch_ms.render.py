"""Mean host wall of a frame, the program's span ``render.frame``, less its
sync spans (binning's size read-back): SH, projection, binning and the
blend's dispatch on the host (ms)."""

from benchmark.program_trace import dispatch_ms


def read(run):
    return dispatch_ms("render.frame")
