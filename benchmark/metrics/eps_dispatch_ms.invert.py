"""Mean host wall of an inversion step, the program's span ``sd.eps``
(ControlNet + UNet at B = 1): the host's pace of dispatch (ms)."""

from benchmark.program_trace import mean_host_ms


def read(run):
    return mean_host_ms("sd.eps")
