"""Device ops (kernels, copies and sets) of the profiled window per view
inverted (the program's counter ``invert.views``)."""

from benchmark.program_trace import launches_per


def read(run):
    return launches_per(run, "invert.views")
