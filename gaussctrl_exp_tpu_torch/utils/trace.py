"""The port's tracer: named spans and counters at its layer boundaries.

``span(name)`` goes around a layer's call; ``count(name)`` where a unit of
work is handed over. Spans are named ``<layer>.<what>`` ("render.frame",
"sd.eps", "train.step"); a span's ``unit`` is the chunk, view, frame or step
it works on.

Off, the default, a span is one check of a module flag and of torch's own
flag that a profiler is recording, then a shared no-op context: no clock
read, no ``record_function``, no allocation. On, after ``enable()`` or while
a torch profiler records (its active cycle; not its warm-up cycle, in which
torch's flag is False), a span keeps its name, unit, parent span, thread,
host start and end (``time.perf_counter_ns``) and whether it ended in an
exception. Under a recording profiler it also opens
``record_function("gc.<name>")``, so that it lies in the profiler's trace on
the profiler's clock. After ``enable()``, with ``device`` a CUDA device, it
also records a CUDA event pair on that device's current stream, resolved
only when read; a profiler alone times the device itself, so under it a
span records no events. ``sync=True`` marks a span whose body makes the
host wait for the device.

The spans are kept in memory, the newest ``capacity`` of them (``dropped()``
counts the others), safe under several threads: each thread nests its own
spans. ``records()``, ``counters()``, ``summary()`` and ``dump(path)`` read
them out; ``reset()`` forgets them. Inside ``tally()`` a thread's counts go
to the block's own dict instead, recording or not: what a CUDA graph's
capture counts, for each replay to count again.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gc."  # of the record_function ranges in a profiler's trace
CAPACITY = 1 << 17

_enabled = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()  # the buffer, the counters and the drop count
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_appended = 0
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while a profiler records."""
    global _enabled
    _enabled = False


def recording() -> bool:
    return _enabled or _profiler._is_profiler_enabled


def reset(capacity: int | None = None) -> None:
    """Forget every span and counter; keep the newest ``capacity`` spans from now on."""
    global _buffer, _appended
    with _lock:
        _buffer = collections.deque(maxlen=capacity or _buffer.maxlen)
        _appended = 0
        _counters.clear()


class Span:
    """One span: the context manager while it runs, the record after."""

    __slots__ = ("id", "name", "unit", "parent", "thread", "start_ns", "end_ns", "error", "sync", "events",
                 "_device", "_stream", "_range", "_device_ms")

    def __init__(self, name: str, unit, device, sync: bool):
        self.name, self.unit, self.sync = name, unit, sync
        self.id = next(_ids)
        self.parent = None
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.error = False
        self.events = None  # (start, end) CUDA events
        self._device = device if _enabled and getattr(device, "type", None) == "cuda" else None
        self._stream = None
        self._range = None
        self._device_ms = None

    def __enter__(self) -> Span:
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        if self._device is not None:
            self._stream = torch.cuda.current_stream(self._device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self.events = (start, None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _appended
        self.end_ns = time.perf_counter_ns()
        self.error = exc_type is not None
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self.events, self._stream = (self.events[0], end), None
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        _stack().pop()
        with _lock:
            _buffer.append(self)
            _appended += 1

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Stream time between the span's two CUDA events (waits for the
        second); None for a host-only span."""
        if self.events is None:
            return None
        if self._device_ms is None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms

    def as_dict(self) -> dict:
        return dict(id=self.id, name=self.name, unit=self.unit, parent=self.parent, thread=self.thread,
                    start_ns=self.start_ns, end_ns=self.end_ns, host_ms=self.host_ms, device_ms=self.device_ms,
                    sync=self.sync, error=self.error)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, unit=None, device: torch.device | None = None, sync: bool = False):
    """A span called ``name`` around the ``with`` block. ``device``: the
    device the block's work runs on; after ``enable()`` a CUDA device's
    stream is timed with events. ``sync``: the block waits for the device."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, unit, device, sync)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (while recording), or to the
    innermost ``tally()`` of this thread."""
    tallied = getattr(_local, "tally", None)
    if tallied is not None:
        tallied[name] = tallied.get(name, 0) + n
        return
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def tally():
    """The counts this thread makes inside the block, as the dict it yields,
    whether or not recording; they do not reach the counters."""
    outer = getattr(_local, "tally", None)
    _local.tally = counts = {}
    try:
        yield counts
    finally:
        _local.tally = outer


def records() -> list[Span]:
    """The kept spans, in the order they ended."""
    with _lock:
        return list(_buffer)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans recorded but no longer kept (the oldest beyond the capacity)."""
    with _lock:
        return _appended - len(_buffer)


def _children_ms(spans: list[Span]) -> dict[int, float]:
    """Host ms of each span's direct children, by the parent's id."""
    out: dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            out[s.parent] += s.host_ms
    return out


def _mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


def summary(spans: list[Span] | None = None) -> dict[str, dict]:
    """Per span name: the spans that ended normally (``count``) and in an
    exception (``errors``, left out of the rest), their mean and 95th
    percentile host ms, mean self ms (host ms less their children's) and
    mean device ms (None for a host-only span)."""
    spans = records() if spans is None else spans
    kids = _children_ms(spans)
    by_name: dict[str, list[Span]] = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    out = {}
    for name, group in sorted(by_name.items()):
        ok = [s for s in group if not s.error]
        host = sorted(s.host_ms for s in ok)
        device = [s.device_ms for s in ok if s.events is not None]
        out[name] = dict(count=len(ok), errors=len(group) - len(ok), host_ms_mean=_mean(host),
                         host_ms_p95=host[max(math.ceil(0.95 * len(host)) - 1, 0)] if host else None,
                         self_ms_mean=_mean([s.host_ms - kids.get(s.id, 0.0) for s in ok]),
                         device_ms_mean=_mean(device))
    return out


def dump(path: str | Path) -> None:
    """The kept spans as JSON lines, one a span, in the order they ended."""
    with open(path, "w") as f:
        for s in records():
            f.write(json.dumps(s.as_dict(), default=str) + "\n")
