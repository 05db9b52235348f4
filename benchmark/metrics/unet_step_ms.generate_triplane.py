"""Mean device time of the edit's ε call with the triplane processor (the
program's span ``sd.eps``: the ControlNet and the UNet at B = 18, 7 of
their self-attentions mixing the triplane term) over the window's steps
(ms)."""


def read(run):
    return run["state"].get("span_readings", {}).get("unet_step_ms")
