"""Correspondence-aware (epipolar) cross-view attention.

Port of ``gaussctrl_exp_tpu/diffusion/correspondence.py``. For each pixel of
view a, its depth is unprojected to a world point and reprojected into view
b, and the pixel attends only to the 3×3 neighbourhood around the hit, with a
depth-consistency weight exp(−|z_reproj − depth_b|/σ) added to the logits as
its log. The 9-tap gather and the small softmax are plain torch (gather +
einsum), as the JAX package leaves them to XLA; the self-attention beside
them is ``_sdpa`` (kernel B3 on the card, B4 and B5 under autograd).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cameras import Camera
from ..utils import trace
from .attention import _sdpa
from .geometry import depth_to_world_points, project_points, scaled_camera

_OFFSETS = [(-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)]


def correspondence_weights(
    depth_a: torch.Tensor,  # (H, W) view a depth
    cam_a: Camera,
    depth_b: torch.Tensor,  # (H, W) view b depth
    cam_b: Camera,
    feat_hw: int,  # attention feature resolution (latent grid, e.g. 64)
    sigma: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (S_a, 9) neighbour indices into view b's S_b tokens (int64) and
    (S_a, 9) weights, S = feat_hw². Indices are clamped; out-of-frustum or
    depth-inconsistent taps get ~0 weight. ``torch.round`` rounds half to
    even, as ``jnp.round``."""
    H, _ = depth_a.shape
    stride = H // feat_hw
    d_a = depth_a[stride // 2 :: stride, stride // 2 :: stride][:feat_hw, :feat_hw]
    pts = depth_to_world_points(d_a, scaled_camera(cam_a, stride, feat_hw))  # (f, f, 3)
    xy_b, z_b = project_points(pts, scaled_camera(cam_b, stride, feat_hw))
    d_b = depth_b[stride // 2 :: stride, stride // 2 :: stride][:feat_hw, :feat_hw]

    xr, yr = torch.round(xy_b[..., 0]).long(), torch.round(xy_b[..., 1]).long()
    idxs, ws = [], []
    for ox, oy in _OFFSETS:
        xb, yb = xr + ox, yr + oy
        inside = (xb >= 0) & (xb < feat_hw) & (yb >= 0) & (yb < feat_hw) & (z_b > 0)
        xb, yb = xb.clamp(0, feat_hw - 1), yb.clamp(0, feat_hw - 1)
        # depth consistency against view b's own depth at the tap
        w = torch.exp(-(z_b - d_b[yb, xb]).abs() / sigma) * inside
        idxs.append((yb * feat_hw + xb).reshape(-1))
        ws.append(w.reshape(-1))
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def epipolar_attention(
    q: torch.Tensor,  # (Hh, S, D) view-a queries
    k_b: torch.Tensor,  # (Hh, S, D) view-b keys
    v_b: torch.Tensor,  # (Hh, S, D) view-b values
    nbr_idx: torch.Tensor,  # (S, 9)
    nbr_w: torch.Tensor,  # (S, 9)
) -> torch.Tensor:
    """Attend each view-a token to its 9 epipolar taps in view b."""
    kg = k_b[:, nbr_idx]  # (Hh, S, 9, D)
    vg = v_b[:, nbr_idx]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("hsd,hsnd->hsn", q, kg) * scale
    logits = logits + torch.log(torch.clamp(nbr_w, min=1e-12))[None]
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("hsn,hsnd->hsd", probs, vg)


def make_epipolar_processor(
    nbr_idx: torch.Tensor,  # (V, V, S, 9) pairwise neighbour indices
    nbr_w: torch.Tensor,  # (V, V, S, 9) pairwise weights
    mix: float = 0.5,
    unet_chunk_size: int = 2,
):
    """Self-attention processor mixing in epipolar attention to every OTHER
    view. Batch layout: ``unet_chunk_size`` CFG groups × V views. Layers
    whose sequence length is not the tables' run plain attention."""
    V = nbr_idx.shape[0]
    S_tab = nbr_idx.shape[2]

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        B, Hh, S, D = q.shape
        if is_cross or S != S_tab or B % V != 0:
            return _sdpa(q, k, v)
        out_self = _sdpa(q, k, v)
        outs = []
        for bi in range(B):
            g, a = divmod(bi, V)  # CFG group, view index
            acc = torch.zeros((Hh, S, D), dtype=q.dtype, device=q.device)
            for b in range(V):
                if b != a:
                    acc = acc + epipolar_attention(q[bi], k[g * V + b], v[g * V + b], nbr_idx[a, b], nbr_w[a, b])
            outs.append(acc / max(V - 1, 1))
        return mix * out_self + (1.0 - mix) * torch.stack(outs)

    return processor


def overlap_ratio(nbr_w: torch.Tensor, thresh: float = 0.05) -> torch.Tensor:
    """(V, V, S, 9) tap weights → (V, V) fraction of view-a tokens with at
    least one valid epipolar tap in view b: view pairs that barely see the
    same surface should not exchange attention."""
    return (nbr_w.amax(dim=-1) > thresh).float().mean(dim=-1)


def make_multires_epipolar_processor(
    tables: dict,  # {S: (nbr_idx (V, V, S, 9), nbr_w (V, V, S, 9))}
    mix: float = 0.5,
    pair_mask=None,  # (V, V) 1 = exchange attention; numpy or a tensor
    unet_chunk_size: int = 2,
):
    """Epipolar cross-view attention at every UNet attention resolution: one
    processor holding a table per sequence length. Self-attention layers
    whose S has a table mix in epipolar attention to every other
    (sufficiently overlapping, ``pair_mask``) view; other layers run plain
    attention. ``pair_mask`` is host-static: it selects which view pairs run
    at all, and a view with no partner keeps its self-attention."""
    some = next(iter(tables.values()))
    V = some[0].shape[0]
    if pair_mask is None:
        pair_mask = np.ones((V, V), np.float32)
    if torch.is_tensor(pair_mask):
        pair_mask = pair_mask.detach().cpu().numpy()
    pm = np.asarray(pair_mask) * (1.0 - np.eye(V))  # never "self" pairs
    pairs, isolated = int((pm != 0).sum()), int((pm.sum(1) == 0).sum())  # per CFG group

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        B, Hh, S, D = q.shape
        if is_cross or S not in tables or B % V != 0:
            return _sdpa(q, k, v)
        nbr_idx, nbr_w = tables[S]
        out_self = _sdpa(q, k, v)
        with trace.span("attn.epipolar", unit=S, device=q.device):
            outs = []
            for bi in range(B):
                g, a = divmod(bi, V)
                total = float(pm[a].sum())
                if total == 0.0:
                    outs.append(out_self[bi])  # isolated view: pure self-attention
                    continue
                acc = torch.zeros((Hh, S, D), dtype=q.dtype, device=q.device)
                for b in range(V):
                    if pm[a, b] != 0.0:
                        o = epipolar_attention(q[bi], k[g * V + b], v[g * V + b], nbr_idx[a, b], nbr_w[a, b])
                        acc = acc + o * float(pm[a, b])
                outs.append(acc / max(total, 1.0))
            out = mix * out_self + (1.0 - mix) * torch.stack(outs)
        trace.count("attn.epipolar.pairs", pairs * (B // V))
        trace.count("attn.epipolar.isolated", isolated * (B // V))
        return out

    return processor


def build_correspondence_tables(depths, cameras, feat_hw: int, sigma: float = 0.1):
    """depths: list of (H, W) tensors; cameras: list of Camera → (V, V, S, 9)
    indices and weights, on the depths' device."""
    rows_i, rows_w = [], []
    for da, ca in zip(depths, cameras):
        pairs = [correspondence_weights(da, ca, db, cb, feat_hw, sigma) for db, cb in zip(depths, cameras)]
        rows_i.append(torch.stack([p[0] for p in pairs]))
        rows_w.append(torch.stack([p[1] for p in pairs]))
    return torch.stack(rows_i), torch.stack(rows_w)
