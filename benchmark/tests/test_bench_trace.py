"""The reduction of a traced window and the readers' arithmetic."""

from __future__ import annotations

import pytest

from benchmark import harness, readers, trace


def test_union_and_gaps():
    busy, gaps = trace._union([(1, 3), (2, 4), (6, 7), (9, 12)], 0, 10)
    assert busy == 5 and gaps == [(0, 1), (4, 6), (7, 9)]
    assert trace._union([], 0, 5) == (0.0, [(0, 5)])


def run(**counts):
    prof = dict(busy_s=0.25, window_s=1.0, ops_s={"blend_fwd_kernel<4>": 0.002, "other": 0.5})
    return dict(profile=prof, counts=counts, spans=None)


def test_readers():
    r = run(ops=67e12 * 0.5, window_s=1.0, peak="f32", b1_bound_s=0.001, b1_kernel="blend_fwd_kernel")
    assert readers.device_idle(r) == 0.75
    assert readers.mfu_pct(r) == pytest.approx(50.0)
    assert readers.roofline_pct(r, "b1_bound_s", "b1_kernel") == pytest.approx(50.0)
    # no kernel time: the metric is left out, never read as 0
    r["counts"]["b1_kernel"] = "blend_bwd_kernel"
    assert readers.roofline_pct(r, "b1_bound_s", "b1_kernel") is None


@pytest.mark.parametrize("name", harness.parts()["metrics"])
def test_every_reader_loads(name):
    assert callable(harness.metric_reader(name).read)


def test_judge():
    assert harness.judge([("a", 0.1, 0.2), ("b", 0.0, 0.0)])
    assert not harness.judge([("a", 0.3, 0.2)])
    assert not harness.judge([("a", float("nan"), 0.2)])
    assert not harness.judge([])
