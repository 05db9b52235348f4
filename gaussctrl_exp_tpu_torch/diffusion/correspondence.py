"""Correspondence-aware (epipolar) cross-view attention.

Port of ``gaussctrl_exp_tpu/diffusion/correspondence.py``. For each pixel of
view a, its depth is unprojected to a world point and reprojected into view
b, and the pixel attends only to the 3×3 neighbourhood around the hit, with a
depth-consistency weight exp(−|z_reproj − depth_b|/σ) added to the logits as
its log. The self-attention beside the term is ``_sdpa`` (kernel B3 on the
card, B4 and B5 under autograd).

Which path runs the term (``make_multires_epipolar_processor``) follows what
the processor observes in its input. CUDA tensors in float32 or bf16 that
autograd does not record (sampling, and the edit loop's "correspondence"
processor) take kernel E1 (``ops/epipolar_cuda.py``): one launch a mixing
self-attention, counted ``attn.epipolar.fused``. CPU tensors, and every call
that autograd records (the generator's training: E1 has no backward), take
the plain version ``epipolar_mix_plain``, the JAX package's composition of
a 9-tap gather, two einsums and a softmax per ordered view pair, counted
``attn.epipolar.split``. The processor converts its tables and pair mask to
E1's form once, when it is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cameras import Camera
from ..ops import epipolar_cuda
from ..utils import trace
from .attention import _sdpa
from .geometry import depth_to_world_points, project_points, scaled_camera


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
    # tap t at (t % 3 − 1, t // 3 − 1): the 3×3 neighbourhood row by row, the JAX package's _OFFSETS
    tap = torch.arange(9, device=xr.device)
    xb, yb = xr[..., None] + (tap % 3 - 1), yr[..., None] + (tap // 3 - 1)
    inside = (xb >= 0) & (xb < feat_hw) & (yb >= 0) & (yb < feat_hw) & (z_b > 0)[..., None]
    xb, yb = xb.clamp(0, feat_hw - 1), yb.clamp(0, feat_hw - 1)
    # depth consistency against view b's own depth at the tap
    w = torch.exp(-(z_b[..., None] - d_b[yb, xb]).abs() / sigma) * inside
    return (yb * feat_hw + xb).reshape(-1, 9), w.reshape(-1, 9)


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
    fused = {S: epipolar_cuda.convert_tables(i, w) for S, (i, w) in tables.items()}
    plan = epipolar_cuda.partner_plan(pm, some[0].device)

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        B, _, S, _ = q.shape
        if is_cross or S not in tables or B % V != 0:
            return _sdpa(q, k, v)
        out_self = _sdpa(q, k, v)
        with trace.span("attn.epipolar", unit=S, device=q.device):
            if epipolar_cuda.takes(q, k, v):
                trace.count("attn.epipolar.fused")
                out = epipolar_cuda.epipolar_attn(q, k, v, out_self, *fused[S], *plan, mix)
            else:
                trace.count("attn.epipolar.split")
                out = epipolar_mix_plain(q, k, v, out_self, *tables[S], pm, mix)
        trace.count("attn.epipolar.pairs", pairs * (B // V))
        trace.count("attn.epipolar.isolated", isolated * (B // V))
        return out

    return processor


def epipolar_mix_plain(q, k, v, out_self, nbr_idx, nbr_w, pm: np.ndarray, mix: float) -> torch.Tensor:
    """The epipolar term mixed into the self-attention ``out_self`` of q, k, v
    (B, H, S, D), B = CFG groups × V views, with the (V, V, S, 9) tables and
    the (V, V) pair mask ``pm`` (its diagonal 0): for each row (g, a),
    ``mix · out_self + (1 − mix) · Σ_b pm[a, b] · epipolar_attention(a → g·V +
    b) / max(Σ_b pm[a, b], 1)``, a row with no partner keeping its
    self-attention. Kernel E1's plain version, one pair at a time."""
    B, Hh, S, D = q.shape
    V = pm.shape[0]
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
    return mix * out_self + (1.0 - mix) * torch.stack(outs)


def build_correspondence_tables(depths, cameras, feat_hw: int, sigma: float = 0.1):
    """depths: list of (H, W) tensors; cameras: list of Camera → (V, V, S, 9)
    indices and weights, on the depths' device."""
    rows_i, rows_w = [], []
    for da, ca in zip(depths, cameras):
        pairs = [correspondence_weights(da, ca, db, cb, feat_hw, sigma) for db, cb in zip(depths, cameras)]
        rows_i.append(torch.stack([p[0] for p in pairs]))
        rows_w.append(torch.stack([p[1] for p in pairs]))
    return torch.stack(rows_i), torch.stack(rows_w)
