"""The window's counted work at each part's own peak (the SD stack at bf16's
989 TFLOP/s, SAM and CLIP at the exact float32 rate of 3×TF32) over the
window's length (%)."""


def read(run):
    c = run["counts"]
    return 100.0 * c["peak_s"] / c["window_s"] if c.get("peak_s") else None
