"""Mean device time of the generator's ε call (the program's span
``mvgen.eps``: the UNet at CFG batch 8 with the epipolar processor) over the
window's steps (ms)."""


def read(run):
    return run["state"].get("span_readings", {}).get("unet_step_ms")
