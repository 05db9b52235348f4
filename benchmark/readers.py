"""Arithmetic the per-layer metric readers share. A reader takes ``run``:
dict(spans, window, profile, counts, state) and returns a number, or None
where the run has nothing for it to read."""

from __future__ import annotations

import statistics

from .counts.peaks import PEAK_BF16_OPS_S, PEAK_F32_OPS_S
from .trace import kernel_s

PEAKS = dict(bf16=PEAK_BF16_OPS_S, f32=PEAK_F32_OPS_S)


def mean_ms(run: dict, span: str):
    """Mean of the CUDA-event spans called ``span``, in ms."""
    ms = run["spans"].ms(span)
    return statistics.fmean(ms) if ms else None


def device_idle(run: dict):
    """1 − the device's busy time over the profiled window."""
    p = run["profile"]
    return 1.0 - p["busy_s"] / p["window_s"]


def roofline_pct(run: dict, bound: str, kernel: str):
    """The frozen bound ``counts[bound]`` over the device time of the ops
    named like ``counts[kernel]`` in the profiled window, in %."""
    c = run["counts"]
    t = kernel_s(run["profile"], c[kernel])
    return 100.0 * c[bound] / t if t > 0 and c.get(bound) else None


def mfu_pct(run: dict):
    """The window's counted operations over its length × the peak, in %."""
    c = run["counts"]
    return 100.0 * c["ops"] / (c["window_s"] * PEAKS[c["peak"]]) if c.get("ops") else None
