"""Spans and the profiled window of a traced run.

``Spans`` records, from the benchmark's own wrappers around calls into the
program, CUDA-event pairs (device time between two points of the stream)
and host-clock spans. ``profile`` runs a callable under
torch.profiler and reduces the trace to what the readers and the result
line need: the device's busy time inside the window (the union of its ops'
intervals), the window's length, device time by op name, and the longest
idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "bench.window"
NAME_CHARS = 120  # op and host names in the breakdown are cut to this length
GAPS = 20  # the longest idle gaps named by host activity
SPARES, PAD_S = 16, 0.05  # spare launches and idle seconds that open the recorded cycle


class Spans:
    def __init__(self):
        self._pairs: dict[str, list] = defaultdict(list)
        self.host_s: dict[str, list[float]] = defaultdict(list)
        self._ms: dict[str, list[float]] | None = None

    def reset(self) -> None:
        """Forget what was recorded (the warm-up's spans are not the window's)."""
        self.__init__()

    def event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pair(self, name: str, start: torch.cuda.Event, end: torch.cuda.Event) -> None:
        self._pairs[name].append((start, end))

    @contextlib.contextmanager
    def cuda(self, name: str):
        """Device time of the stream between entering and leaving the block."""
        with torch.profiler.record_function(f"bench.{name}"):
            s = self.event()
            yield
            self.pair(name, s, self.event())

    def ms(self, name: str) -> list[float]:
        """The CUDA-event spans called ``name``, in ms (after a synchronize)."""
        if self._ms is None:
            torch.cuda.synchronize()
            self._ms = {n: [s.elapsed_time(e) for s, e in v] for n, v in self._pairs.items()}
        return self._ms.get(name, [])


def _union(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi],
    and the gaps between them as (start, end)."""
    busy, end, gaps = 0.0, lo, []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        busy += e - max(s, end) if e > end else 0.0
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def profile(fn) -> dict:
    """Run ``fn`` under torch.profiler → dict(busy_s, window_s, ops_s {name:
    seconds}, launches {name: count}, device_ops [[name, s]], idle_gaps
    [[host activity, s]]). The profiler first runs a warm-up cycle (without
    one it has kept only some of a window's kernel records on the H100), and
    the recorded cycle opens with spare launches and a pause before the
    window, as ``utils/timing.profile_window`` of the program does."""
    from torch.profiler import ProfilerActivity, record_function, schedule

    def spares():
        for _ in range(SPARES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAD_S)

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        spares()
        prof.step()
        spares()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    win = next(e for e in events if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    # device ops: kernels, copies and sets; not the device-side marks of
    # record_function ranges (the optimizer's, the benchmark's, the profiler's)
    dev = [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(("bench.", "ProfilerStep", "Optimizer.")) and "spin_kernel" not in e.name]
    dev = [e for e in dev if e.time_range.end > lo and e.time_range.start < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device op in the traced window")
    busy, gaps = _union(((e.time_range.start, e.time_range.end) for e in dev), lo, hi)
    ops_s, launches = defaultdict(float), defaultdict(int)
    for e in dev:
        ops_s[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        launches[e.name] += 1
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and not e.name.startswith(("bench.", "ProfilerStep"))]
    by_activity = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS]:
        mid = 0.5 * (s + e)
        inner = [h for h in host if h.time_range.start <= mid <= h.time_range.end]
        name = min(inner, key=lambda h: h.time_range.end - h.time_range.start).name if inner else "(Python, no op)"
        by_activity[name[:NAME_CHARS]] += (e - s) / 1e6
    top = sorted(ops_s.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        busy_s=busy / 1e6,
        window_s=(hi - lo) / 1e6,
        ops_s=dict(ops_s),
        launches=dict(launches),
        device_ops=[[n[:NAME_CHARS], s] for n, s in top],
        idle_gaps=[[n, s] for n, s in sorted(by_activity.items(), key=lambda kv: -kv[1])[:10]],
    )


def kernel_s(prof: dict, match: str) -> float:
    """Device seconds of the ops whose name holds ``match``."""
    return sum(s for n, s in prof["ops_s"].items() if match in n)
