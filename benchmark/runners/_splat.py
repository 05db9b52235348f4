"""What the splat cells (and the inversion's renders) share: the scene and
cameras from the seed, the program's state and cameras built on them, the
traced runs' span at the blend, and the blend's counted work."""

from __future__ import annotations

import contextlib

import torch

from .. import scene
from ..counts import blend as blend_counts
from ..counts.peaks import PEAK_F32_OPS_S, roofline_s
from ..reference import splat as ref

B1, B2 = "blend_fwd_kernel", "blend_bwd_kernel"


def build(ctx: dict, cfg: dict) -> dict:
    """The scene of configuration ``cfg`` for the run in ``ctx``."""
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig

    seed, dev = ctx["seed"], ctx["device"]
    g = scene.make_gaussians(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed)
    return dict(cfg=cfg, g=g, cams=cams, pcams=[scene.port_camera(c, dev) for c in cams],
                gs=scene.port_state(g),
                mcfg=SplatModelConfig(sh_degree=cfg["sh_degree"], sh_degree_interval=cfg["sh_degree_interval"]))


@contextlib.contextmanager
def blend_span(spans, starts: list):
    """Traced runs: the program's call of the blend (``ops.renderer.rasterize_tiles``)
    wrapped so that the span "project" runs from the event in ``starts[-1]``
    (the frame's or step's start) to the blend's call, and "blend" covers it."""
    import gaussctrl_exp_tpu_torch.ops.renderer as renderer

    orig = renderer.rasterize_tiles

    def wrapped(*a, **k):
        spans.pair("project", starts[-1], spans.event())
        with spans.cuda("blend"):
            return orig(*a, **k)

    renderer.rasterize_tiles = wrapped
    try:
        yield
    finally:
        renderer.rasterize_tiles = orig


@torch.no_grad()
def frame_work(g: dict, cam: dict, step: int, C: int) -> dict:
    """The reference's projection and binning of ``g`` at ``cam`` → the
    blend's bound (s) and operations, forward (``fwd_*``) and backward
    (``bwd_*``), and the visible gaussians."""
    out = ref.render(g, cam, step, torch.ones(3, device=g["means"].device), depth=False)
    p = out["proj"]
    pairs = blend_counts.pairs(p["xys"], p["conic"], out["opac"], out["bins"], cam["W"], cam["H"])
    work = dict(visible=int(p["visible"].sum()), pairs=pairs)
    for way, backward in (("fwd", False), ("bwd", True)):
        ops = blend_counts.blend_ops(C, pairs["evaluated"], pairs["composited"], backward)
        nbytes = blend_counts.blend_bytes(p["xys"].shape[0], C, int(out["bins"][0].numel()), cam["W"], cam["H"],
                                          backward)
        work[f"{way}_ops"], work[f"{way}_bound_s"] = ops, roofline_s(ops, nbytes, PEAK_F32_OPS_S)
    return work
