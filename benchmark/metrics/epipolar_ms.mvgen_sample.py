"""Device time of the epipolar cross-view term (the program's spans
``attn.epipolar``: the rows' 9-tap attention to their partners, the stack
and the mix, in every mixing self-attention) per step of the window (ms)."""


def read(run):
    return run["state"].get("span_readings", {}).get("epipolar_ms_per_step")
