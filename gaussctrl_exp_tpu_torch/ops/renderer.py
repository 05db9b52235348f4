"""Render: project → bin → blend → background composite.

Port of ``gaussctrl_exp_tpu/ops/renderer.py``: rgb with the background
composited and clamped at 1, alpha = 1 − T, and depth divided by alpha with
1000 where alpha is 0. Depth is rendered as one more blend channel in the
same pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cameras import Camera, camera_matrices
from .binning import TileBins, bin_gaussians
from .blend_cuda import rasterize_tiles
from .projection import BLOCK, ProjectedGaussians, project_gaussians

DEPTH_EMPTY = 1000.0  # depth at pixels no gaussian covers


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    clip_thresh: float = 0.01
    render_depth: bool = True


@dataclasses.dataclass
class RenderOutputs:
    rgb: torch.Tensor  # (H, W, 3) in [0, 1]
    alpha: torch.Tensor  # (H, W, 1)
    depth: Optional[torch.Tensor]  # (H, W, 1) alpha-normalized, 1000 where empty
    proj: ProjectedGaussians
    bins: TileBins


def render(
    means: torch.Tensor,
    scales: torch.Tensor,  # already exp()ed
    quats: torch.Tensor,
    colors: torch.Tensor,  # (N, 3) post-SH rgb in [0, inf)
    opacities: torch.Tensor,  # (N,) already sigmoid()ed
    camera: Camera,
    background: torch.Tensor,  # (3,)
    cfg: RenderConfig = RenderConfig(),
    extra_mask: Optional[torch.Tensor] = None,
    xys_offset: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """``xys_offset``: optional (N, 2) zeros added to the projected centres
    after binning, whose gradient is the densification statistic."""
    H, W = camera.height, camera.width
    tiles_x = (W + BLOCK - 1) // BLOCK
    tiles_y = (H + BLOCK - 1) // BLOCK

    viewmat, _, fullmat = camera_matrices(camera)
    opacs = opacities.reshape(-1)
    proj = project_gaussians(
        means, scales, 1.0, quats, viewmat, fullmat,
        camera.fx, camera.fy, camera.cx, camera.cy, H, W,
        clip_thresh=cfg.clip_thresh, extra_mask=extra_mask, opacities=opacs,
    )
    bins = bin_gaussians(proj, tiles_x, tiles_y)

    xys = proj.xys if xys_offset is None else proj.xys + xys_offset
    chan = [colors]
    if cfg.render_depth:
        chan.append(proj.depths[:, None])
    chan = torch.cat(chan, dim=-1)
    out = rasterize_tiles(xys, proj.conics, chan, opacs.contiguous(), bins, H, W)

    final_T = out.final_T
    alpha = (1.0 - final_T)[..., None]
    rgb = out.img[..., :3] + final_T[..., None] * background.reshape(1, 1, 3)
    # minimum, not clamp: a pixel no gaussian reaches is exactly 1 on a white
    # background, and at that tie jnp.minimum passes half the gradient
    rgb = torch.minimum(rgb, rgb.new_ones(()))

    depth = None
    if cfg.render_depth:
        draw = out.img[..., 3:4]
        covered = alpha > 0.0
        depth = torch.where(covered, draw / torch.where(covered, alpha, 1.0), DEPTH_EMPTY)
    return RenderOutputs(rgb=rgb, alpha=alpha, depth=depth, proj=proj, bins=bins)
