"""The profiled call's attention floor (every self- and cross-attention of
its steps at 3×TF32, ``counts/mvgen.py``) over the device time of the
float32 kernel B3 in the profiled window (%)."""

from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "b3_bound_s", "b3_kernel")
