"""Device ops (kernels, copies and sets) of the profiled window per chunk
generated (the program's counter ``edit.chunks``)."""

from benchmark.program_trace import launches_per


def read(run):
    return launches_per(run, "edit.chunks")
