"""Device ops (kernels, copies and sets) of the profiled call per DDIM step
(the program's counter ``mvgen.steps``): the call's depth renders and
``prepare`` are spread over its steps."""

from benchmark.program_trace import launches_per


def read(run):
    return launches_per(run, "mvgen.steps")
