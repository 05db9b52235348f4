"""Mean device-stream time of a step's loss (L1, SSIM, patch LPIPS) and its
Adam update, between the train step's stage marks (CUDA events, ms)."""

from benchmark.readers import mean_ms


def read(run):
    loss, opt = mean_ms(run, "loss"), mean_ms(run, "optimizer")
    return None if loss is None or opt is None else loss + opt
