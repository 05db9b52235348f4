"""Mean device time of a inversion step (ControlNet + UNet at B = 1, CUDA events)."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "unet_step")
