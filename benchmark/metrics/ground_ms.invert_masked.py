"""Mean host wall of the program's span ``seg.ground``: CLIP ViT-L/14's
patch embeddings of a frame, their copy to the host and the boxes (ms)."""

from benchmark.program_trace import mean_host_ms


def read(run):
    return mean_host_ms("seg.ground")
