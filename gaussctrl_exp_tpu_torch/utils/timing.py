"""Timing on the card: slope timing, and a kernel's device time.

The benchmark scripts of the JAX package time a stage by running it K times
inside one jitted loop for two values of K and taking the slope
(``scripts/bench_blend_variants.py:251-270``): the difference cancels what a
batch costs once (dispatch, the final transfer). Here a batch is K eager
calls between two CUDA events, with one synchronize after it.
"""

from __future__ import annotations

from typing import Callable

import torch


def slope_time_ms(fn: Callable[[], object], k_lo: int, k_hi: int, repeats: int) -> float:
    """Per-call device time of ``fn`` in ms: the best of ``repeats`` batches
    of ``k_hi`` calls, less the best of batches of ``k_lo``, over
    ``k_hi − k_lo``. Each batch size is run once first, unmeasured. Needs a
    card: this is a device measurement, with no CPU counterpart."""
    if not torch.cuda.is_available():
        raise RuntimeError("slope_time_ms times the card; no CUDA device is available")
    if not 0 < k_lo < k_hi:
        raise ValueError(f"need 0 < k_lo < k_hi, got {k_lo}, {k_hi}")
    best = {}
    for k in (k_lo, k_hi):
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        best[k] = float("inf")
        for _ in range(repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            torch.cuda.synchronize()
            best[k] = min(best[k], start.elapsed_time(end))
    return (best[k_hi] - best[k_lo]) / (k_hi - k_lo)


def kernel_time_ms(fn: Callable[[], object], match: str, launches: int = 20) -> float:
    """Device time per call (ms) of the kernels whose name holds ``match``,
    from torch.profiler over ``launches`` calls of ``fn`` after one warm-up
    call. CUDA events around back-to-back calls measure a wrapper's host time
    where the kernel is shorter than it; this measures the kernel. Needs a
    card."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_time_ms times the card; no CUDA device is available")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_time_total for e in prof.events() if e.device_type == cuda and match in e.name) / 1e3 / launches
