"""Share of generation's AttnAlign self-attentions on the card that took
kernel B3a: the program's counter ``attn.align.fused`` over it and
``attn.align.split`` (the five-call composition) in the profiled window (%).
A program without the counters reads None."""

from benchmark.program_trace import window


def read(run):
    w = window()
    if not w:
        return None
    fused, split = w[1].get("attn.align.fused", 0), w[1].get("attn.align.split", 0)
    return 100.0 * fused / (fused + split) if fused + split else None
