"""Mean device time of one SAM ViT-H encode at 1024² (CUDA events around
each ``encode_image`` call on the SAM instance; the program's span
``seg.sam.encode`` covers the same call)."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "sam_encode")
