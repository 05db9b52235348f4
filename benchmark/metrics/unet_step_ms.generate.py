"""Mean device time of a denoising step (ControlNet + UNet at B = 18, CUDA events)."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "unet_step")
