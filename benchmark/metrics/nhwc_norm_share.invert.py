"""Share of the inversion's GroupNorm calls on the card that took the NHWC
kernel: the program's counter ``sd.norm.nhwc`` over it and ``sd.norm.nchw``
in the profiled window, a graph replay counting what its capture counted
(%). A program without the counters reads None."""

from benchmark.program_trace import window


def read(run):
    w = window()
    if not w:
        return None
    nhwc, nchw = w[1].get("sd.norm.nhwc", 0), w[1].get("sd.norm.nchw", 0)
    return 100.0 * nhwc / (nhwc + nchw) if nhwc + nchw else None
