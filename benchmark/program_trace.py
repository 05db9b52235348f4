"""The program's own spans and counters, as the per-layer readers see them.

The program's tracer (``gaussctrl_exp_tpu_torch/utils/trace.py``) records
while a torch profiler records, so in a traced run its buffer holds the
profiled window and nothing else. A span that ended in an exception (a
window ended by ``StopWindow`` inside it) is left out. A program without
the tracer has nothing to read: every reader then returns None.
"""

from __future__ import annotations

import statistics


def _tracer():
    try:
        from gaussctrl_exp_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def window():
    """(the profiled window's spans, its counters), or None without a tracer."""
    t = _tracer()
    return None if t is None else (t.records(), t.counters())


def _outer_sync(spans: list) -> list:
    """The sync spans that no other sync span holds."""
    by_id = {s.id: s for s in spans}

    def held(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.sync:
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in spans if s.sync and not s.error and not held(s)]


def mean_host_ms(name: str):
    """Mean host wall of the complete spans called ``name`` (ms)."""
    w = window()
    ms = [s.host_ms for s in w[0] if s.name == name and not s.error] if w else []
    return statistics.fmean(ms) if ms else None


def sync_ms_per(counter: str, name: str | None = None):
    """Host ms in sync spans (those called ``name``, else every outermost
    one) per unit of the counter ``counter``."""
    w = window()
    if not w or not w[1].get(counter):
        return None
    spans, counts = w
    sync = [s for s in spans if s.name == name and not s.error] if name else _outer_sync(spans)
    return sum(s.host_ms for s in sync) / counts[counter]


def dispatch_ms(name: str):
    """Mean host wall of the complete spans called ``name`` less the host
    time of the outermost sync spans inside each: the host's own time."""
    w = window()
    if not w:
        return None
    spans = w[0]
    by_id = {s.id: s for s in spans}
    tops = {s.id: s.host_ms for s in spans if s.name == name and not s.error}
    for s in _outer_sync(spans):
        p = by_id.get(s.parent)
        while p is not None and p.id not in tops:
            p = by_id.get(p.parent)
        if p is not None:
            tops[p.id] -= s.host_ms
    return statistics.fmean(tops.values()) if tops else None


def launches_per(run: dict, counter: str):
    """Device ops of the profiled window (kernels, copies and sets) per unit
    of the counter ``counter``."""
    w = window()
    if not w or not w[1].get(counter):
        return None
    return sum(run["profile"]["launches"].values()) / w[1][counter]
