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

The planes are pooled into float32 sums and counts and sampled in float32,
whatever the values' type: on the bf16 edit path a plane cell sums tens to
hundreds of tokens, and bf16 sums would round at every add. The features
are cast to the compute type once, before the attention to them.

The geometry is fixed for the processor's life (a chunk of the edit loop,
7 mixing layers × 20 steps), so what depends on it alone is built once,
when the processor is: each token's cell on each plane, each plane cell's
token count, and each token's 12 bilinear taps (4 on each plane) into one
table of the three planes, with their weights over 3. A mixing layer then
pools with three ``index_add_`` (``pool_planes``) and samples with one
``embedding_bag`` (each token's 12 taps summed with their weights), ~15
device ops. The CFG groups share the geometry and the planes pool every
row, so the features are sampled once per view and repeated for each group.

Each mixing self-attention's term (the planes, the resample, the attention
to the features and the mix) is the span ``attn.triplane``, the pooling and
the resample inside it ``attn.triplane.planes``; the counters
``attn.triplane`` (mixing self-attentions) and ``attn.triplane.tokens``
(tokens pooled, B·S a plane) count them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from .attention import _sdpa
from .geometry import bilinear_sample, bilinear_taps

PLANES = ((0, 1), (0, 2), (1, 2))  # xy, xz, yz


def plane_cell(uv: torch.Tensor, res: int) -> torch.Tensor:
    """uv (S, 2) in [0, 1) → (S,) the row-major cell of a res × res plane
    each point falls in, clamped to the plane."""
    return (uv[:, 1] * res).long().clamp(0, res - 1) * res + (uv[:, 0] * res).long().clamp(0, res - 1)


def pool_planes(feats: torch.Tensor, cells: torch.Tensor, inv_counts: torch.Tensor) -> torch.Tensor:
    """feats (S, C) of any type, cells (P, S) each token's row on each of P
    planes of one table, inv_counts (T, 1) each row's 1 / max(count, 1) →
    (T, C) float32 cell means: float32 sums, scaled once."""
    f = feats.float()
    table = torch.zeros((inv_counts.shape[0], f.shape[1]), dtype=torch.float32, device=f.device)
    for row in cells:
        table.index_add_(0, row, f)
    return table.mul_(inv_counts)


def scatter_mean_plane(feats: torch.Tensor, uv: torch.Tensor, res: int) -> torch.Tensor:
    """feats (S, C), uv (S, 2) in [0, 1) → (res·res, C) float32 mean-pooled
    plane: sums and counts in float32."""
    idx = plane_cell(uv, res)
    counts = torch.zeros(res * res, dtype=torch.float32, device=feats.device).index_add_(
        0, idx, torch.ones(feats.shape[0], dtype=torch.float32, device=feats.device))
    return pool_planes(feats, idx[None], (1.0 / torch.clamp(counts, min=1.0))[:, None])


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
    norm_pts = torch.clamp(pts_world.float() / bbox_length + 0.5, 0.0, 1.0 - 1e-6)  # (V, S, 3)
    V, S = norm_pts.shape[:2]
    R2 = plane_res * plane_res
    # plane p's cells sit at rows p·R² .. (p + 1)·R² − 1 of one table of the three planes
    uvs = [norm_pts[..., list(axes)].reshape(V * S, 2) for axes in PLANES]
    cells = torch.stack([plane_cell(uv, plane_res) + p * R2 for p, uv in enumerate(uvs)])  # (3, V·S)
    view_counts = torch.zeros(len(PLANES) * R2, device=norm_pts.device).index_add_(
        0, cells.reshape(-1), torch.ones(cells.numel(), device=norm_pts.device))
    taps = [bilinear_taps(uv * plane_res - 0.5, plane_res, plane_res) for uv in uvs]
    # each token's bag of 12 taps (V·S, 12) and their weights, the planes' mean folded in
    tap_idx = torch.cat([idx + p * R2 for p, (idx, _) in enumerate(taps)]).T.contiguous()
    tap_w = (torch.cat([w for _, w in taps]) / len(PLANES)).T.contiguous()
    per_groups: dict[int, tuple] = {}

    def pooling(G: int):
        """The cells of every row of G CFG groups (3, G·V·S) and each table
        row's 1 / max(count, 1) (3·R², 1)."""
        if G not in per_groups:
            per_groups[G] = (cells.repeat(1, G), (1.0 / torch.clamp(G * view_counts, min=1.0))[:, None])
        return per_groups[G]

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        B, Hh, L, D = q.shape
        if is_cross or L != S:
            return _sdpa(q, k, v)
        out_self = _sdpa(q, k, v)
        G = B // V
        with trace.span("attn.triplane", unit=S, device=q.device):
            with trace.span("attn.triplane.planes", unit=S, device=q.device):
                # the three planes from all rows' values (heads flattened), in float32
                table = pool_planes(v.transpose(1, 2).reshape(B * S, Hh * D), *pooling(G))
                # each view's tokens sample the planes; the CFG groups share them
                tri = F.embedding_bag(tap_idx, table, per_sample_weights=tap_w, mode="sum")
                tri = tri.to(q.dtype).view(V, S, Hh, D).repeat(G, 1, 1, 1).transpose(1, 2)
            # queries attend to the triplane features (keys = values = them)
            out_tri = _sdpa(q, tri, tri)
            out = mix * out_self + (1.0 - mix) * out_tri
        trace.count("attn.triplane")
        trace.count("attn.triplane.tokens", B * S * len(PLANES))
        return out

    return processor
