"""Mean device time of an inversion step (ControlNet + UNet at B = 1, CUDA
events) with LangSAM run between views."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "unet_step")
