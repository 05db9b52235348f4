"""Share of the inversion's ControlNet + UNet evaluations that replayed a
CUDA graph: the program's counter ``sd.eps.graph_replay`` over it and
``sd.eps.eager`` in the profiled window; captures count in neither (%)."""

from benchmark.program_trace import window


def read(run):
    w = window()
    if not w:
        return None
    replays, eager = w[1].get("sd.eps.graph_replay", 0), w[1].get("sd.eps.eager", 0)
    return 100.0 * replays / (replays + eager) if replays + eager else None
