"""Host ms of a view's mask (the program's span ``invert.mask``) less the
outermost sync spans inside it (the CLIP embeddings' and the mask's copies
to the host): the host's own time in LangSAM, per view (ms)."""

from benchmark.program_trace import dispatch_ms


def read(run):
    return dispatch_ms("invert.mask")
