"""``align_fused_share.generate`` on fabricated counters: the B3a
self-attentions over them and the five-call compositions; nothing from a
program without the tracer or a window with neither counter (the parent
commit's program)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace


@pytest.mark.parametrize("counters,want", [
    ({"attn.align.fused": 460, "sd.norm.nhwc": 1760, "edit.chunks": 1}, 100.0),
    ({"attn.align.fused": 30, "attn.align.split": 10}, 75.0),
    ({"attn.align.split": 460}, 0.0),
    ({"sd.norm.nhwc": 1760, "edit.chunks": 1}, None),  # the parent's program counts neither
    (None, None),  # no tracer
])
def test_align_fused_share(monkeypatch, counters, want):
    buffer = None if counters is None else SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    run = dict(profile=dict(launches={}), spans=None, counts=None, window=None, state=None)
    got = harness.metric_reader("align_fused_share.generate").read(run)
    assert got == (pytest.approx(want) if want is not None else None)
