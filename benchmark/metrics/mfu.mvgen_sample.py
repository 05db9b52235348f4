"""The window's counted work at each part's own peak (the UNet's products
and the epipolar term at float32's 67 TFLOP/s, attention at 3×TF32's 164.9)
over the window's length (%)."""


def read(run):
    c = run["counts"]
    return 100.0 * c["peak_s"] / c["window_s"] if c.get("peak_s") else None
