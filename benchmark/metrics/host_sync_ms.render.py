"""Host ms a frame waits at binning's size read-back (the program's span
``render.bin.sync``) per frame (the counter ``render.frames``)."""

from benchmark.program_trace import sync_ms_per


def read(run):
    return sync_ms_per("render.frames", "render.bin.sync")
