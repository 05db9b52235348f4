"""``eps_graph_share.invert`` on fabricated counters: replays over replays
and eager calls, captures left out; nothing from a program without the
tracer or a window with neither counter (the parent commit's program)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace


def _read(monkeypatch, counters):
    buffer = None if counters is None else SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    run = dict(profile=dict(launches={}), spans=None, counts=None, window=None, state=None)
    return harness.metric_reader("eps_graph_share.invert").read(run)


@pytest.mark.parametrize("counters,want", [
    ({"sd.eps.graph_replay": 40, "invert.views": 2}, 100.0),
    ({"sd.eps.graph_replay": 30, "sd.eps.eager": 10, "sd.eps.graph_capture": 1}, 75.0),
    ({"sd.eps.eager": 40}, 0.0),
    ({"invert.views": 2}, None),  # the parent's program counts neither
    ({"sd.eps.graph_capture": 1}, None),
    (None, None),  # no tracer
])
def test_eps_graph_share(monkeypatch, counters, want):
    got = _read(monkeypatch, counters)
    assert got == (pytest.approx(want) if want is not None else None)
