"""Mean device-stream time from the start of a frame (a step) to the program's
call of the blend: SH, projection and binning (CUDA events, ms)."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "project")
