"""Device ops (kernels, copies and sets) of the profiled window per frame
(the program's counter ``render.frames``)."""

from benchmark.program_trace import launches_per


def read(run):
    return launches_per(run, "render.frames")
