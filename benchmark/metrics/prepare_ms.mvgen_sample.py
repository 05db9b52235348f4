"""Mean host wall of the program's span ``mvgen.prepare`` over the window's
calls: the depths copied to the host, the epipolar tables at every attention
grid, the pair mask read on the host and the depth latents (ms)."""


def read(run):
    return run["state"].get("span_readings", {}).get("prepare_ms")
