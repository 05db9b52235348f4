"""Plain reference of the depth-conditioned multi-view generator: the SD 1.x
UNet with a 5-channel ``conv_in``, the inverse-depth latent, the epipolar
correspondence tables and pair mask, the multi-resolution epipolar
processor, and CFG DDIM sampling.

Written from the equations of the multi-view generator that GaussCtrl's
experimental fork (Ubinya/gaussctrl_exp, ``mv_generator.py``,
``mv_model.py``, ``mv_depth_utils.py``) takes from MVDiffusion (Tang et al.,
arXiv:2307.01097, correspondence-aware attention), as functions over a flat
dict of float32 tensors named as the measured program's parameters. The UNet
is ``sd.py``'s blocks (every product through ``precision.q``; norms, softmax,
the geometry and the scheduler in float32) with its own trunk: ``conv_in``
takes 4 + 1 channels and the time embedding is ``block_out[-1]`` wide (1,280
at SD 1.x's widths, SD's own 4 × 320).

* Depth latent: 1 / (d + 1e-5) over its maximum, resized to the latent grid
  by the antialiased triangle filter (``jax.image.resize``'s "bilinear",
  which is PIL's and torch's antialiased bilinear).
* Tables, at each attention grid f × f: the depth sampled at the centre of
  each stride × stride cell, unprojected through the pinhole camera (OpenGL,
  pixel centres at +0.5, intrinsics divided by the stride) and reprojected
  into every view; the 3 × 3 taps around the rounded hit (half to even),
  each weighted exp(−|z_reproj − d_b(tap)| / σ), 0 outside the frustum or
  behind the camera, indices clamped to the grid.
* Pair mask: view a attends to b ≠ a where at least ``min_overlap`` of a's
  finest-grid tokens have a tap above ``overlap_thresh``.
* Attention: every self-attention whose grid has a table returns
  mix · softmax(q·kᵀ/√D)·v + (1 − mix) · the mean over a's masked partners b
  of softmax(q·k_b[taps]/√D + log max(w, 1e-12))·v_b[taps], within each CFG
  group; a view with no partner keeps its self-attention alone.
  Cross-attention is plain.
* Sampling: DDIM (η = 0, ε-prediction, SD's leading spacing with offset 1,
  the final step to ᾱ₀) with CFG over the group-major [uncond; cond] batch,
  float32 carry.

Departures, from MVDiffusion: its correspondence-aware attention is a block
of its own, fed by the homography (panorama) or depth warp of every other
view at a learned positional encoding of the offsets, added as a residual
after each UNet block; here the term is mixed into each self-attention at a
fixed weight, with the depth-consistency weight as a log-bias and no learned
part. From the fork's ``CPBlock``: the fork inserts separate correspondence
blocks after every down, mid and up block; the rebuild this reference
follows mixes the epipolar term into the 16 self-attentions instead, at the
four attention grids (64², 32², 16², 8²), and masks pairs by overlap.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import q
from .sd import Params, _time, alphas_cumprod, conv, ddim_timesteps, group_norm, resnet, sdpa, transformer

# the 3 × 3 taps around the hit, (dx, dy), in the tables' order
OFFSETS = [(-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)]
W_FLOOR = 1e-12  # a tap's weight is floored here before its log


def model_cfg(config: dict) -> dict:
    """The configuration file's widths and generator settings in the reference's terms."""
    u, g = config["unet"], config["generator"]
    return dict(block_out=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
                heads=u["attention_head_dim"], cross_dim=u["cross_attention_dim"], in_channels=u["in_channels"],
                latent=g["latent_size"], sigma=g["depth_sigma"], mix=g["mix"], overlap_thresh=g["overlap_thresh"],
                min_overlap=g["min_overlap"], guidance=g["guidance_scale"], steps=g["num_steps"])


# ------------------------------------------------------------------ UNet
def unet(P, cfg, x, t, ctx, processor):
    """ε for ``x`` (B, 4 + 1, h, w) (latents and the depth channel),
    timesteps ``t`` (B,) and text states ``ctx`` (B, 77, cross_dim)."""
    bo, lpb, heads, cdim = cfg["block_out"], cfg["layers_per_block"], cfg["heads"], cfg["cross_dim"]
    tdim, n = bo[-1], len(bo)
    temb = _time(P, t, bo[0], tdim)
    h = conv(P, "conv_in", x, cfg["in_channels"], bo[0], 3)
    ch, skips = bo[0], [h]
    for bi, cout in enumerate(bo):
        for li in range(lpb):
            h = resnet(P, f"down_{bi}_resnet_{li}", h, temb, ch, cout, tdim)
            ch = cout
            if bi < n - 1:
                h = transformer(P, f"down_{bi}_attn_{li}", h, ctx, ch, heads, cdim, processor)
            skips.append(h)
        if bi < n - 1:
            h = conv(P, f"down_{bi}_downsample.conv", h, ch, ch, 3, stride=2)
            skips.append(h)
    h = resnet(P, "mid_resnet_0", h, temb, ch, ch, tdim)
    h = transformer(P, "mid_attn_0", h, ctx, ch, heads, cdim, processor)
    h = resnet(P, "mid_resnet_1", h, temb, ch, ch, tdim)
    for bi, cout in enumerate(reversed(bo)):
        for li in range(lpb + 1):
            skip = skips.pop()
            h = resnet(P, f"up_{bi}_resnet_{li}", torch.cat([h, skip], 1), temb, ch + skip.shape[1], cout, tdim)
            ch = cout
            if bi > 0:
                h = transformer(P, f"up_{bi}_attn_{li}", h, ctx, ch, heads, cdim, processor)
        if bi < n - 1:
            h = conv(P, f"up_{bi}_upsample.conv", F.interpolate(h, scale_factor=2, mode="nearest"), ch, ch, 3)
    return conv(P, "conv_out", F.silu(group_norm(P, "conv_norm_out", h, ch, 1e-5)), ch, 4, 3)


def param_spec(cfg: dict) -> dict:
    """{name: (shape, initialiser)} of the UNet, recorded on the meta device."""
    P = Params()
    m = torch.empty((2, cfg["in_channels"], 8, 8), device="meta")
    unet(P, cfg, m, torch.zeros(2, dtype=torch.long, device="meta"),
         torch.empty((2, 7, cfg["cross_dim"]), device="meta"), lambda qh, kh, vh, c: sdpa(qh, kh, vh))
    return P.spec


def attention_grids(cfg: dict) -> list[int]:
    """The grid sizes f of the UNet's self-attentions: the latent halved per block."""
    L, out = cfg["latent"], []
    for i in range(len(cfg["block_out"])):
        f = L >> i
        if f >= 2 and f not in out:
            out.append(f)
    return out


# -------------------------------------------------------------- geometry
def depth_latent(depth: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W) depth → (size, size) inverse depth over its maximum, antialiased."""
    disp = 1.0 / (depth.float() + 1e-5)
    disp = disp / disp.max().clamp(min=1e-8)
    return F.interpolate(disp[None, None], size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def _intrinsics(cam: dict, stride: int):
    return cam["fx"] / stride, cam["fy"] / stride, cam["cx"] / stride, cam["cy"] / stride


def unproject(depth: torch.Tensor, cam: dict, f: int) -> torch.Tensor:
    """The f × f grid's world points (f·f, 3) from (H, W) ``depth``."""
    stride = depth.shape[0] // f
    d = depth[stride // 2 :: stride, stride // 2 :: stride][:f, :f].reshape(-1)
    fx, fy, cx, cy = _intrinsics(cam, stride)
    c = torch.arange(f, dtype=torch.float32, device=depth.device) + 0.5
    py, px = c[:, None].expand(f, f).reshape(-1), c[None, :].expand(f, f).reshape(-1)
    cam_pts = torch.stack([(px - cx) / fx, -(py - cy) / fy, -torch.ones_like(px)], -1) * d[:, None]
    R, t = cam["c2w"][:, :3], cam["c2w"][:, 3]
    return cam_pts @ R.T + t


def project(pts: torch.Tensor, cam: dict, f: int, stride: int):
    """World points (N, 3) → (u, v) on view ``cam``'s f × f grid, pixel
    centres at integers, and the depth along its view direction."""
    fx, fy, cx, cy = _intrinsics(cam, stride)
    R, t = cam["c2w"][:, :3], cam["c2w"][:, 3]
    pc = (pts - t) @ R
    z = -pc[:, 2]
    zs = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    return fx * (pc[:, 0] / zs) + cx - 0.5, -fy * (pc[:, 1] / zs) + cy - 0.5, z


def tables(depths: torch.Tensor, cams: list[dict], f: int, sigma: float, margin: float = 0.0):
    """(V, H, W) depths → tap indices (V, V, f·f, 9) int64, weights
    (V, V, f·f, 9) float32, and the taps whose hit lies within ``margin``
    pixels of a rounding tie on either axis (V, V, f·f) bool."""
    V, H = depths.shape[0], depths.shape[1]
    stride = H // f
    dsub = depths[:, stride // 2 :: stride, stride // 2 :: stride][:, :f, :f].reshape(V, -1)
    idx = torch.empty((V, V, f * f, 9), dtype=torch.long, device=depths.device)
    w = torch.empty((V, V, f * f, 9), dtype=torch.float32, device=depths.device)
    tie = torch.empty((V, V, f * f), dtype=torch.bool, device=depths.device)
    for a in range(V):
        pts = unproject(depths[a], cams[a], f)
        for b in range(V):
            u, v, z = project(pts, cams[b], f, stride)
            xr, yr = torch.round(u).long(), torch.round(v).long()
            tie[a, b] = ((u - u.floor() - 0.5).abs() < margin) | ((v - v.floor() - 0.5).abs() < margin)
            for n, (ox, oy) in enumerate(OFFSETS):
                xb, yb = xr + ox, yr + oy
                inside = (xb >= 0) & (xb < f) & (yb >= 0) & (yb < f) & (z > 0)
                xb, yb = xb.clamp(0, f - 1), yb.clamp(0, f - 1)
                idx[a, b, :, n] = yb * f + xb
                w[a, b, :, n] = torch.exp(-(z - dsub[b][yb * f + xb]).abs() / sigma) * inside
    return idx, w, tie


def overlap(w: torch.Tensor, thresh: float) -> torch.Tensor:
    """(V, V) share of view a's tokens with a tap above ``thresh`` in view b."""
    return (w.amax(-1) > thresh).float().mean(-1)


def pair_mask(ratio: torch.Tensor, min_overlap: float) -> torch.Tensor:
    """(V, V) 1 where a attends to b: enough overlap, never a itself."""
    V = ratio.shape[0]
    return ((ratio >= min_overlap) & ~torch.eye(V, dtype=torch.bool, device=ratio.device)).float()


# ------------------------------------------------------------- attention
def epipolar(qh, kh, vh, idx, w, pm, groups: int = 2):
    """The cross-view term (B, H, S, D) of a self-attention: per row (g, a),
    the mean over a's masked partners b of b's 9-tap attention; the plain
    self-attention's rows are not part of it (zeros where a has no partner)."""
    B, H, S, D = qh.shape
    V = idx.shape[0]
    qg = qh.reshape(groups, V, H, S, D)
    # per view b: its keys and values token-major, (S, groups, H, D)
    kb, vb = (t.reshape(groups, V, H, S, D).permute(1, 3, 0, 2, 4) for t in (kh, vh))
    vi = torch.arange(V, device=qh.device)[:, None, None]
    out = torch.zeros_like(qg)
    for a in range(V):
        n = pm[a].sum()
        if n == 0:
            continue
        kt, vt = kb[vi, idx[a]], vb[vi, idx[a]]  # (V_b, S, 9, groups, H, D)
        logits = torch.einsum("ghsd,bsnghd->ghbsn", q(qg[:, a]), q(kt)) * D**-0.5
        p = torch.softmax(logits + torch.log(w[a].clamp(min=W_FLOOR))[None, None], -1)
        o = torch.einsum("ghbsn,bsnghd->ghbsd", q(p), q(vt))
        out[:, a] = torch.einsum("ghbsd,b->ghsd", o, pm[a] / n)
    return out.reshape(B, H, S, D)


def processor(tabs: dict, pm: torch.Tensor, mix: float, groups: int = 2):
    """The multi-resolution epipolar processor over ``tabs`` {S: (idx, w)}."""
    alone = pm.sum(1) == 0  # rows with no partner keep their self-attention

    def proc(qh, kh, vh, is_cross):
        out = sdpa(qh, kh, vh)
        S = qh.shape[2]
        if is_cross or S not in tabs:
            return out
        cross = epipolar(qh, kh, vh, *tabs[S], pm, groups)
        keep = alone.repeat(groups)[:, None, None, None]
        return mix * out + (1.0 - mix) * torch.where(keep, out, cross)

    return proc


# -------------------------------------------------------------- sampling
def prepare(cfg: dict, depths: torch.Tensor, cams: list[dict], margin: float = 0.0) -> dict:
    """Tables at every attention grid, the overlap ratio of the finest, the
    pair mask and the depth latents (V, 1, L, L) of (V, H, W) ``depths``."""
    tabs, ties = {}, {}
    for f in attention_grids(cfg):
        idx, w, tie = tables(depths, cams, f, cfg["sigma"], margin)
        tabs[f * f], ties[f * f] = (idx, w), tie
    ratio = overlap(tabs[cfg["latent"] ** 2][1], cfg["overlap_thresh"])
    lat = torch.stack([depth_latent(d, cfg["latent"]) for d in depths])[:, None]
    return dict(tables=tabs, ties=ties, ratio=ratio, pair_mask=pair_mask(ratio, cfg["min_overlap"]), depth_lat=lat)


def eps(P, cfg, lat2, depth_lat, t: int, ctx2, proc):
    """ε (2V, 4, L, L) of the CFG-doubled latents ``lat2`` at timestep ``t``."""
    x = torch.cat([lat2, depth_lat.repeat(2, 1, 1, 1)], 1)
    tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    return unet(P, cfg, x, tt, ctx2, proc).float()


def sample(P, cfg, lat, depth_lat, ctx_c, ctx_u, proc, steps: int | None = None):
    """DDIM with CFG from latents ``lat`` (V, 4, L, L) → (V, 4, L, L)."""
    steps = steps or cfg["steps"]
    ac, dt = alphas_cumprod(), 1000 // steps
    lat = lat.float()
    ctx2 = torch.cat([ctx_u, ctx_c])
    for t in reversed(ddim_timesteps(steps)):
        eu, ec = eps(P, cfg, torch.cat([lat, lat]), depth_lat, t, ctx2, proc).chunk(2)
        e = eu + cfg["guidance"] * (ec - eu)
        a_t, a_p = ac[t], ac[t - dt] if t - dt >= 0 else ac[0]
        x0 = (lat - math.sqrt(1 - a_t) * e) / math.sqrt(a_t)
        lat = math.sqrt(a_p) * x0 + math.sqrt(1 - a_p) * e
    return lat
