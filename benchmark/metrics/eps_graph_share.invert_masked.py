"""Share of the inversion's ControlNet + UNet evaluations that replayed a
CUDA graph with LangSAM run between views: ``eps_graph_share.invert``'s
reading of the profiled window (%)."""

from benchmark import harness


def read(run):
    return harness.metric_reader("eps_graph_share.invert").read(run)
