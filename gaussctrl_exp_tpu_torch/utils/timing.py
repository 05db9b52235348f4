"""Timing on the card: slope timing, a kernel's device time, the SM clock
beside it, and the attention kernels' bounds (forward and backward).

The benchmark scripts of the JAX package time a stage by running it K times
inside one jitted loop for two values of K and taking the slope
(``scripts/bench_blend_variants.py:251-270``): the difference cancels what a
batch costs once (dispatch, the final transfer). Here a batch is K eager
calls between two CUDA events, with one synchronize after it.
"""

from __future__ import annotations

import subprocess
import time
from collections import Counter
from typing import Callable

import torch

from . import trace

# H100 SXM (NVIDIA data sheet, dense rates): HBM3 bytes/s; bf16 on the
# tensor cores and fp32 outside them, each with the SM clock it is rated at
# (989e12 = 132 SMs × 4,096 operations a clock × 1.83 GHz, 67e12 = 132 ×
# 256 × 1.98 GHz); SMs; ex2 per SM per clock on the special-function unit
PEAK_BYTES_S = 3.35e12
PEAK_BF16_OPS_S, BF16_RATED_HZ = 989e12, 1.83e9
PEAK_F32_OPS_S, F32_RATED_HZ = 67e12, 1.98e9
# TF32 on the tensor cores (132 × 2,048 a clock × 1.83 GHz); fp32-accurate
# products as 3×TF32 (hi·hi + hi·lo + lo·hi) run at a third of it
PEAK_TF32_OPS_S, TF32_RATED_HZ = 494.7e12, 1.83e9
TF32_PASSES = 3
# products per (b, h, s, t, d) of the attention backward kernels, 2
# operations each: B4 Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q; B5 Q·Kᵀ, dO·Vᵀ, dS·K
BWD_PRODUCTS = {"B4": 4, "B5": 3}
SMS = 132
EX2_PER_SM_CLOCK = 16


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


WINDOW = "timing_window"
PAD_S = 0.05  # idle host time at each edge of a profiled window
SPARE = "spin_kernel"  # the kernel of torch.cuda._sleep, the spare launch
# Late in a long process on the H100 the profiler lost the first records of
# a recorded cycle: one B3 launch of ten, whatever the idle time before it
# (up to 1.6 s), and once four 21.6 ms B4 launches after three spare ones.
# So each cycle opens with spare launches: while one of them is kept, the
# loss stopped short of the window. A cycle that keeps none doubles the
# spares, for it and every later window.
_spares = [16]
calls_made = 0  # calls of timed functions that profile_window made, warm-ups included, since the caller set it to 0


def device_ops(events) -> list:
    """The profiler's device ops among ``events``: kernels, copies and sets,
    and not the device-side marks of ``record_function`` ranges (the
    window's, the profiler's steps, the tracer's spans)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
            and e.name != WINDOW and not e.name.startswith(("ProfilerStep", trace.PREFIX))]


def profile_window(fn: Callable, calls: int = 1, prepare: Callable | None = None):
    """The device ops of ``calls`` calls of ``fn`` in one torch.profiler
    window that ends with a synchronize, after a warm-up cycle of the
    profiler that runs one call untimed (on the H100, a profile with no
    warm-up cycle kept 4-8 of 10 kernel records). The recorded cycle opens
    with the spare launches and ``PAD_S`` of idle time, and ends with
    ``PAD_S`` of it. With ``prepare``, each call is ``fn(prepare())``, its
    argument made before the window (for a call that can run once on what
    it is given, as a backward pass). Returns the device events (the
    spares left out), the window's host interval (µs) and the number of
    spare launches the profiler kept. Needs a card."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs the card; no CUDA device is available")
    global calls_made
    calls_made += 1 + calls
    run = fn if prepare else (lambda _: fn())
    make = prepare or (lambda: None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run(make())
        args = [make() for _ in range(calls)]
        torch.cuda.synchronize()
        prof.step()
        for _ in range(_spares[0]):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        with record_function(WINDOW):
            for a in args:
                run(a)
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW and e.device_type != torch.autograd.DeviceType.CUDA)
    dev = device_ops(events)
    return ([e for e in dev if SPARE not in e.name], (win.time_range.start, win.time_range.end),
            sum(SPARE in e.name for e in dev))


def record_mismatch(first: Counter, second: Counter, calls: int) -> dict[str, tuple[int, int]]:
    """The device ops whose records betray a drop, given the records by op
    name of two windows of ``calls`` calls each: an op whose count differs
    between them or is not a whole number per call, → (records in the
    first, in the second); two windows with no record at all give
    ``{"(no device record)": (0, 0)}``."""
    if not first and not second:
        return {"(no device record)": (0, 0)}
    return {n: (first[n], second[n]) for n in sorted(set(first) | set(second))
            if first[n] != second[n] or first[n] % calls}


def checked_window(fn: Callable, calls: int = 1, prepare: Callable | None = None, attempts: int = 12):
    """``profile_window`` held to a count: two windows of ``calls`` calls
    are profiled; each must keep at least one of its spare launches, and
    each device op must have the same records in both, a whole number per
    call, so that a record the profiler dropped fails the pair. (A window
    of one call is no reference: late in a long process, one-call windows
    kept none of their records while ten-call windows kept all.) A pair
    that fails is profiled again, with the spares doubled if one of its
    windows kept none, up to ``attempts`` pairs in all; then this raises.
    Returns the second window's events and interval. Needs a card."""
    tried = []  # (spares opening each window, kept in the first, in the second, ops that betray a drop)
    for _ in range(attempts):
        first, _, spares_1 = profile_window(fn, calls, prepare)
        dev, win, spares_2 = profile_window(fn, calls, prepare)
        bad = record_mismatch(Counter(e.name for e in first), Counter(e.name for e in dev), calls)
        if spares_1 and spares_2 and not bad:
            return dev, win
        tried.append((_spares[0], spares_1, spares_2, len(bad)))
        if not (spares_1 and spares_2):
            _spares[0] *= 2
    kept = {n: [f"{(e.time_range.start - win[0]) / 1e3:.3f}-{(e.time_range.end - win[0]) / 1e3:.3f}"
                for e in dev if e.name == n] for n in bad}
    raise RuntimeError(f"torch.profiler dropped device records of {calls} calls in {attempts} pairs of windows "
                       f"(spares kept in the last pair: {spares_1}, {spares_2} of {_spares[0]}; name: records in "
                       f"the first window, in the second): {bad}; the second window's records of these, ms from "
                       f"its opening (it lasted {(win[1] - win[0]) / 1e3:.3f} ms): {kept}; every pair (spares, kept "
                       f"in the first, in the second, ops betraying a drop): {tried}")


def spare_launches() -> int:
    """The spare launches that open each profiled cycle now."""
    return _spares[0]


def device_ops_ms(fn: Callable[[], object], launches: int = 20) -> dict[str, float]:
    """Device time per call (ms) of each device op that ``fn`` runs, by op
    name, over ``launches`` calls in one ``checked_window``. Needs a card."""
    ops: dict[str, float] = {}
    for e in checked_window(fn, launches)[0]:
        ops[e.name] = ops.get(e.name, 0.0) + e.device_time_total / 1e3 / launches
    return ops


def kernel_time_ms(fn: Callable[[], object], match: str, launches: int = 20) -> float:
    """Device time per call (ms) of the kernels whose name holds ``match``
    (every device op of ``fn`` for ``match=""``), as ``device_ops_ms``. CUDA
    events around back-to-back calls measure a wrapper's host time where the
    kernel is shorter than it; this measures the kernel. Needs a card."""
    ms = [t for name, t in device_ops_ms(fn, launches).items() if match in name]
    if not ms:
        raise RuntimeError(f"no device op named like {match!r} ran")
    return sum(ms)


def device_window(fn: Callable, match: str = "", calls: int = 1, prepare: Callable | None = None) -> dict:
    """``calls`` calls of ``fn`` in one ``checked_window``. Returns the
    window's wall (ms, as the profiler records the window on the host), the
    union of the device ops' intervals inside it (ms), the busy share (that
    union over the wall, so it cannot pass 1), and per call the device ops'
    summed time (ms), the part in kernels whose name holds ``match`` (ms) and
    the number of device ops; with the device time the profiler put outside
    the window (ms, 0 when the two clocks agree). Needs a card."""
    dev, (w0, w1) = checked_window(fn, calls, prepare)
    busy, end, inside = 0.0, w0, 0.0
    for s, e in sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev):
        inside += max(e - s, 0.0)
        s = max(s, end)
        if e > s:
            busy, end = busy + e - s, e
    total = sum(e.device_time_total for e in dev)
    share = busy / (w1 - w0)
    if share > 1.0:
        raise RuntimeError(f"a busy share of {share} is not a share")
    return dict(wall_ms=(w1 - w0) / 1e3, busy_ms=busy / 1e3, busy=share, device_ms=total / 1e3 / calls,
                part_ms=sum(e.device_time_total for e in dev if match and match in e.name) / 1e3 / calls,
                ops=len(dev) / calls, calls=calls, outside_ms=max(total - inside, 0.0) / 1e3)


def gpu_clocks() -> dict[str, float]:
    """The card's SM clock, its maximum (MHz), power draw (W) and temperature
    (°C) now, from nvidia-smi; read it before and after a kernel-alone
    measurement, since a card may run below its maximum clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True, timeout=60)
    sm, sm_max, power, temp = (float(x) for x in out.stdout.strip().splitlines()[0].split(","))
    return dict(sm_mhz=sm, max_sm_mhz=sm_max, power_w=power, temp_c=temp)


def attention_bound(shape: tuple[int, int, int, int, int], dtype: torch.dtype,
                    sm_clock_hz: float | None = None) -> dict:
    """What bounds non-causal attention of (B, H, S, T, D) in ``dtype`` on the
    card. ``ops_ms``: the two products, 4·B·H·S·T·D operations at the tensor
    cores' bf16 peak (the fp32 FMA peak for fp32); ``tf32x3_ms``: the same
    operations at a third of the TF32 tensor-core peak (fp32-accurate
    products as 3×TF32, the design of B3 in fp32); ``bytes_ms``: q, k, v
    read once and o written once; ``exp_ms``: one exponential per score,
    B·H·S·T, on the special-function unit (16 per SM per clock, 132 SMs).
    Every rate is taken at the SM clock ``sm_clock_hz``, each peak scaled
    from the clock it is rated at; with no clock, each at its rated clock
    (bf16 and TF32 1.83 GHz, fp32 1.98 GHz), which gives the data sheet's
    peaks. The memory rate does not follow the SM clock. ``bound_ms`` is the
    larger of the operations of the design the kernel runs (bf16 on the
    tensor cores, fp32 as 3×TF32) and the bytes, ``bound_by`` which of the
    two."""
    B, H, S, T, D = shape
    bf16 = dtype == torch.bfloat16
    peak, rated = (PEAK_BF16_OPS_S, BF16_RATED_HZ) if bf16 else (PEAK_F32_OPS_S, F32_RATED_HZ)
    clock = sm_clock_hz or rated
    ops = 4 * B * H * S * T * D
    ops_ms = ops / (peak * clock / rated) * 1e3
    tf32x3_ms = ops / (PEAK_TF32_OPS_S / TF32_PASSES * (sm_clock_hz or TF32_RATED_HZ) / TF32_RATED_HZ) * 1e3
    bytes_ms = (2 if bf16 else 4) * B * H * D * (2 * S + 2 * T) / PEAK_BYTES_S * 1e3
    exp_ms = B * H * S * T / (EX2_PER_SM_CLOCK * SMS * clock) * 1e3
    design = ops_ms if bf16 else tf32x3_ms
    return dict(ops_ms=ops_ms, tf32x3_ms=tf32x3_ms, bytes_ms=bytes_ms, exp_ms=exp_ms,
                bound_ms=max(design, bytes_ms), bound_by="operations" if design >= bytes_ms else "bytes",
                clock_hz=clock)


def attention_bwd_bound(shape: tuple[int, int, int, int, int], dtype: torch.dtype, kernel: str,
                        sm_clock_hz: float | None = None) -> dict:
    """What bounds backward kernel ``kernel`` ("B4": dK and dV, "B5": dQ) of
    non-causal attention of (B, H, S, T, D) in ``dtype`` on the card. Its
    operations, 2 per product per (b, h, s, t, d) (``BWD_PRODUCTS``), over:
    ``fp32_ms`` the fp32 FMA peak, ``tf32x3_ms`` a third of the TF32
    tensor-core peak (fp32-accurate products as 3×TF32), ``bf16_ms`` the
    bf16 tensor-core peak. ``bytes_ms``: q, k, v, dO read once, lse and
    delta (fp32) read once, its gradients written once. ``exp_ms``: one
    exponential per score, B·H·S·T, on the special-function unit. Every
    rate is taken at the SM clock ``sm_clock_hz``, scaled from the clock it
    is rated at; with no clock each at its rated clock (the data sheet's
    peaks) and the exponentials at 1.83 GHz. ``bound_ms`` is the larger of
    the operations of the design the kernel runs (3×TF32 for fp32, bf16 on
    the tensor cores) and the bytes, ``bound_by`` which of the two."""
    B, H, S, T, D = shape
    if kernel not in BWD_PRODUCTS:
        raise ValueError(f"kernel {kernel!r} is not one of {sorted(BWD_PRODUCTS)}")
    bf16 = dtype == torch.bfloat16
    ops = 2 * BWD_PRODUCTS[kernel] * B * H * S * T * D

    def at(peak, rated):
        return ops / (peak * (sm_clock_hz or rated) / rated) * 1e3

    size = 2 if bf16 else 4
    n_bytes = size * B * H * D * (2 * S + 2 * T) + 8 * B * H * S + size * B * H * D * (2 * T if kernel == "B4" else S)
    r = dict(fp32_ms=at(PEAK_F32_OPS_S, F32_RATED_HZ), tf32x3_ms=at(PEAK_TF32_OPS_S / TF32_PASSES, TF32_RATED_HZ),
             bf16_ms=at(PEAK_BF16_OPS_S, BF16_RATED_HZ), bytes_ms=n_bytes / PEAK_BYTES_S * 1e3,
             exp_ms=B * H * S * T / (EX2_PER_SM_CLOCK * SMS * (sm_clock_hz or TF32_RATED_HZ)) * 1e3,
             clock_hz=sm_clock_hz or TF32_RATED_HZ)
    design = r["bf16_ms"] if bf16 else r["tf32x3_ms"]
    r.update(bound_ms=max(design, r["bytes_ms"]), bound_by="operations" if design >= r["bytes_ms"] else "bytes")
    return r
