"""Share of the depth generator's mixing self-attentions whose epipolar term
took kernel E1: the program's counter ``attn.epipolar.fused`` over it and
``attn.epipolar.split`` (the plain per-pair composition) in the profiled
window (%). A program without the counters reads None."""

from benchmark.program_trace import window


def read(run):
    w = window()
    if not w:
        return None
    fused, split = w[1].get("attn.epipolar.fused", 0), w[1].get("attn.epipolar.split", 0)
    return 100.0 * fused / (fused + split) if fused + split else None
