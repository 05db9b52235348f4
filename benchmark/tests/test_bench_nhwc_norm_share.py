"""``nhwc_norm_share.invert`` and ``.generate`` on fabricated counters: the
NHWC GroupNorm calls over them and the NCHW ones; nothing from a program
without the tracer or a window with neither counter (the parent commit's
program)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace


@pytest.mark.parametrize("name", ["nhwc_norm_share.invert", "nhwc_norm_share.generate"])
@pytest.mark.parametrize("counters,want", [
    ({"sd.norm.nhwc": 1760, "sd.norm.nchw": 44, "sd.eps.graph_replay": 40}, 100.0 * 1760 / 1804),
    ({"sd.norm.nhwc": 88}, 100.0),
    ({"sd.norm.nchw": 30}, 0.0),
    ({"sd.eps.graph_replay": 40, "invert.views": 2}, None),  # the parent's program counts neither
    (None, None),  # no tracer
])
def test_nhwc_norm_share(monkeypatch, name, counters, want):
    buffer = None if counters is None else SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    run = dict(profile=dict(launches={}), spans=None, counts=None, window=None, state=None)
    got = harness.metric_reader(name).read(run)
    assert got == (pytest.approx(want) if want is not None else None)
