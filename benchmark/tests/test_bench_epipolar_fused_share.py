"""``epipolar_fused_share.mvgen_sample`` on fabricated counters: the mixing
self-attentions whose epipolar term took kernel E1 over them and the plain
compositions; nothing from a program without the tracer or a window with
neither counter (the parent commit's program)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace


@pytest.mark.parametrize("counters,want", [
    ({"attn.epipolar.fused": 160, "attn.epipolar.pairs": 3840, "mvgen.steps": 10}, 100.0),
    ({"attn.epipolar.fused": 12, "attn.epipolar.split": 4}, 75.0),
    ({"attn.epipolar.split": 160}, 0.0),
    ({"attn.epipolar.pairs": 3840, "mvgen.steps": 10}, None),  # the parent's program counts neither
    (None, None),  # no tracer
])
def test_epipolar_fused_share(monkeypatch, counters, want):
    buffer = None if counters is None else SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))
    monkeypatch.setattr(program_trace, "_tracer", lambda: buffer)
    run = dict(profile=dict(launches={}), spans=None, counts=None, window=None, state=None)
    got = harness.metric_reader("epipolar_fused_share.mvgen_sample").read(run)
    assert got == (pytest.approx(want) if want is not None else None)
