"""SAM's encode floor (``counts/sam.py``: its operations at the exact
float32 rate of 3×TF32, or its bytes at HBM's rate, whichever is larger)
over the mean device time of an encode (%)."""

from benchmark.readers import mean_ms


def read(run):
    ms = mean_ms(run, "sam_encode")
    return 100.0 * run["counts"]["sam_bound_s"] / (ms / 1e3) if ms else None
