"""The splat model: parameter transforms, SH schedule and render outputs.

Port of ``gaussctrl_exp_tpu/models/splat_model.py``: exp(scales),
sigmoid(opacities), SH colours with the degree schedule
``min(step // sh_degree_interval, sh_degree)``, the background choice
(random in training if configured), and the render through ``ops``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cameras import Camera, projection_matrix_ogl, view_matrix
from ..ops.renderer import RenderConfig, RenderOutputs, render
from ..ops.sh import eval_sh
from ..utils import trace
from .gaussians import GaussianParams, GaussianState


@dataclasses.dataclass(frozen=True)
class SplatModelConfig:
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    background_color: str = "random"  # random | white | black
    render: RenderConfig = RenderConfig()


@dataclasses.dataclass
class ModelOutputs:
    rgb: torch.Tensor
    alpha: torch.Tensor
    depth: Optional[torch.Tensor]
    render: RenderOutputs
    mat_view: torch.Tensor  # un-flipped view matrix
    mat_proj: torch.Tensor  # OpenGL projection
    mat_c2w: torch.Tensor


def pick_background(
    cfg: SplatModelConfig,
    training: bool,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Random (from ``generator``) in training when configured, else the
    configured colour; white at eval and black in training by default."""
    if training and cfg.background_color == "random" and generator is not None:
        return torch.rand(3, generator=generator, device=generator.device).to(device)
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    if cfg.background_color == "black":
        return torch.zeros(3, device=device)
    return torch.ones(3, device=device) if not training else torch.zeros(3, device=device)


def model_colors(params: GaussianParams, camera: Camera, step, cfg: SplatModelConfig) -> torch.Tensor:
    """Per-gaussian RGB from SH with the degree schedule."""
    coeffs = torch.cat([params.features_dc[:, None, :], params.features_rest], dim=1)
    if cfg.sh_degree > 0:
        viewdirs = params.means.detach() - camera.c2w[:3, 3].detach()
        viewdirs = viewdirs / torch.clamp(torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
        n = min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)
        rgbs = eval_sh(n, viewdirs, coeffs)
        # maximum, not clamp: at a tie (a black seed point gives exactly 0)
        # it passes half the gradient, as jnp.maximum does
        return torch.maximum(rgbs + 0.5, rgbs.new_zeros(()))
    return torch.sigmoid(params.features_dc)


def render_model(
    state: GaussianState,
    camera: Camera,
    step,
    cfg: SplatModelConfig,
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
    background_override: Optional[torch.Tensor] = None,
    crop_mask: Optional[torch.Tensor] = None,
    xys_offset: Optional[torch.Tensor] = None,
) -> ModelOutputs:
    params = state.params
    dev = params.means.device
    with trace.span("render.frame", device=dev):
        background = (
            background_override
            if background_override is not None
            else pick_background(cfg, training, generator, dev)
        )
        with trace.span("render.sh"):
            colors = model_colors(params, camera, step, cfg)
        extra_mask = state.alive if crop_mask is None else (state.alive & crop_mask)
        # the training loss reads only rgb, so training drops the depth channel
        rcfg = dataclasses.replace(cfg.render, render_depth=False) if training else cfg.render
        out = render(
            params.means,
            torch.exp(params.scales),
            params.quats,
            colors,
            torch.sigmoid(params.opacities[:, 0]),
            camera,
            background,
            rcfg,
            extra_mask=extra_mask,
            xys_offset=xys_offset,
        )
    trace.count("render.frames")
    return ModelOutputs(
        rgb=out.rgb,
        alpha=out.alpha,
        depth=out.depth,
        render=out,
        mat_view=view_matrix(camera.c2w, gsplat_flip=False),
        mat_proj=projection_matrix_ogl(0.001, 1000.0, camera.fovx, camera.fovy),
        mat_c2w=camera.c2w,
    )
