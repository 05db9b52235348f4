"""TriPlane attention processor.

Port of ``gaussctrl_exp_tpu/diffusion/triplane_attention.py``. Per
self-attention layer, each view's per-token values are scattered
(mean-pooled) onto three axis-aligned feature planes at the world points
obtained by depth back-projection, re-sampled per token bilinearly, and
attended: out = mix·self_attn + (1−mix)·attn(q → triplane features). World
points are normalised by ``bbox_length`` (8.0, as the reference's
gc_pipeline.py:330). The JAX package pools with ``jax.ops.segment_sum``, the
port with ``index_add_``: the two add in different orders (fp32, ~1e-6
relative).
"""

from __future__ import annotations

import torch

from .attention import _sdpa
from .geometry import bilinear_sample


def scatter_mean_plane(feats: torch.Tensor, uv: torch.Tensor, res: int) -> torch.Tensor:
    """feats (S, C), uv (S, 2) in [0, 1) → (res·res, C) mean-pooled plane."""
    idx = ((uv[:, 1] * res).long().clamp(0, res - 1) * res
           + (uv[:, 0] * res).long().clamp(0, res - 1))
    summed = feats.new_zeros((res * res, feats.shape[1])).index_add_(0, idx, feats)
    counts = torch.zeros(res * res, dtype=torch.float32, device=feats.device).index_add_(
        0, idx, torch.ones(feats.shape[0], dtype=torch.float32, device=feats.device))
    return summed / torch.clamp(counts, min=1.0)[:, None]


def sample_plane(plane: torch.Tensor, uv: torch.Tensor, res: int) -> torch.Tensor:
    """(res·res, C) plane, uv (S, 2) in [0, 1) → (S, C) bilinear samples."""
    return bilinear_sample(plane.reshape(res, res, -1), uv * res - 0.5)


def make_triplane_processor(
    pts_world: torch.Tensor,  # (V, S, 3) per-view per-token world points
    mix: float = 0.5,
    bbox_length: float = 8.0,
    plane_res: int = 32,
    unet_chunk_size: int = 2,
):
    """Attention processor: queries also attend to triplane-pooled features.
    Layers whose sequence length is not ``pts_world``'s run plain attention
    (the reference applies it at one resolution)."""
    norm_pts = torch.clamp(pts_world / bbox_length + 0.5, 0.0, 1.0 - 1e-6)  # (V, S, 3)

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        B, Hh, S, D = q.shape
        if is_cross or S != norm_pts.shape[1]:
            return _sdpa(q, k, v)
        V = norm_pts.shape[0]
        out_self = _sdpa(q, k, v)

        # the three planes from all views' values (heads flattened)
        flat_feats = v.transpose(1, 2).reshape(B * S, Hh * D)
        pts = norm_pts.repeat(B // V, 1, 1)  # (B, S, 3): the CFG groups share the geometry
        tri_feats = 0.0
        for axes in ((0, 1), (0, 2), (1, 2)):  # xy, xz, yz
            uv = pts[..., list(axes)].reshape(B * S, 2)
            plane = scatter_mean_plane(flat_feats, uv, plane_res)
            tri_feats = tri_feats + sample_plane(plane, uv, plane_res)
        tri_feats = (tri_feats / 3.0).reshape(B, S, Hh, D).transpose(1, 2).to(q.dtype)

        # queries attend to the triplane features (keys = values = them)
        out_tri = _sdpa(q, tri_feats, tri_feats)
        return mix * out_self + (1.0 - mix) * out_tri

    return processor
