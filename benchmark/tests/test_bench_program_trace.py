"""The readers of the program's own spans and counters, on a fabricated
buffer and profile: each reads what its docstring says, leaves out spans
that ended in an exception, and reads nothing from a program without the
tracer or a window without its counter."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace

NEW = ["eps_dispatch_ms.invert", "host_sync_ms.invert", "launches.invert", "frame_dispatch_ms.render",
       "host_sync_ms.render", "launches.render", "launches.generate"]


class Buffer:
    """Spans as the tracer keeps them: ``add`` returns the new span's id."""

    def __init__(self):
        self.spans, self.counts = [], {}

    def add(self, name, host_ms, parent=None, sync=False, error=False):
        sid = len(self.spans) + 1
        self.spans.append(SimpleNamespace(id=sid, name=name, parent=parent, host_ms=host_ms, sync=sync,
                                          error=error))
        return sid

    def records(self):
        return list(self.spans)

    def counters(self):
        return dict(self.counts)


def _frame(b, parent, ms, sync_ms, error=False):
    f = b.add("render.frame", ms, parent, error=error)
    binned = b.add("render.bin", sync_ms + 1.0, f)
    b.add("render.bin.sync", sync_ms, binned, sync=True, error=error)
    return f


def invert_window() -> Buffer:
    b = Buffer()
    for ms, eps in ((1000.0, (50.0, 60.0)), (1100.0, (70.0, 80.0))):
        view = b.add("invert.view", ms)
        _frame(b, view, 7.0, 1.0)
        b.add("invert.to_host", 3.0, view, sync=True)
        inv = b.add("sd.invert", sum(eps) + 5.0, view)
        for e in eps:
            b.add("sd.unet", e - 10.0, b.add("sd.eps", e, inv))
        b.add("invert.z0_to_host", 2.0, view, sync=True)
    # the view the window ended in: started, never counted
    view = b.add("invert.view", 40.0, error=True)
    b.add("sd.eps", 999.0, b.add("sd.invert", 999.0, view, error=True), error=True)
    b.counts = {"invert.views": 2, "render.frames": 2}
    return b


def render_window() -> Buffer:
    b = Buffer()
    _frame(b, None, 10.0, 1.5)
    _frame(b, None, 12.0, 2.5)
    _frame(b, None, 99.0, 50.0, error=True)
    b.counts = {"render.frames": 2}
    return b


def generate_window() -> Buffer:
    b = Buffer()
    for _ in range(3):
        chunk = b.add("edit.chunk", 3000.0)
        b.add("edit.to_host", 4.0, chunk, sync=True)
    b.counts = {"edit.chunks": 3}
    return b


def _read(monkeypatch, name, buffer, launches=None):
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    run = dict(profile=dict(launches=launches or {}), spans=None, counts=None, window=None, state=None)
    return harness.metric_reader(name).read(run)


@pytest.mark.parametrize("name,window,launches,want", [
    ("eps_dispatch_ms.invert", invert_window, None, 65.0),  # (50 + 60 + 70 + 80) / 4
    ("host_sync_ms.invert", invert_window, None, 6.0),  # 2 × (1 + 3 + 2) / 2 views
    ("launches.invert", invert_window, {"gemm": 900, "memcpy": 60}, 480.0),
    ("frame_dispatch_ms.render", render_window, None, 9.0),  # (10 − 1.5 + 12 − 2.5) / 2
    ("host_sync_ms.render", render_window, None, 2.0),  # (1.5 + 2.5) / 2 frames
    ("launches.render", render_window, {"blend_fwd_kernel": 2, "gather": 1058}, 530.0),
    ("launches.generate", generate_window, {"gctorch_attn_fwd_b3": 2760, "conv": 9240}, 4000.0),
])
def test_reader_value(monkeypatch, name, window, launches, want):
    assert _read(monkeypatch, name, window(), launches) == pytest.approx(want)


def test_host_sync_counts_a_sync_span_inside_another_once(monkeypatch):
    b = invert_window()
    outer = next(s for s in b.spans if s.name == "invert.to_host")
    b.add("inner.copy", 2.5, outer.id, sync=True)
    assert _read(monkeypatch, "host_sync_ms.invert", b) == pytest.approx(6.0)


@pytest.mark.parametrize("name", NEW)
def test_no_tracer_reads_nothing(monkeypatch, name):
    """The parent commit's program has no tracer: its traced runs leave the metric out."""
    assert _read(monkeypatch, name, None, {"k": 1}) is None


@pytest.mark.parametrize("name", NEW)
def test_an_empty_window_reads_nothing(monkeypatch, name):
    assert _read(monkeypatch, name, Buffer(), {"k": 1}) is None


def test_the_program_has_the_tracer():
    from gaussctrl_exp_tpu_torch.utils import trace

    assert program_trace._tracer() is trace
    assert program_trace.window() == (trace.records(), trace.counters())
