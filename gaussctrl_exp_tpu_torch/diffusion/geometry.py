"""Depth ↔ world geometry for the multi-view attention experiments.

Port of ``gaussctrl_exp_tpu/diffusion/geometry.py``:
  * ``depth_to_world_points`` unprojects a depth map through the pinhole
    camera to world points (pixel centres at +0.5);
  * ``project_points`` maps world points into another view's pixel
    coordinates and depths;
  * ``bilinear_sample`` samples an (H, W, C) grid with zero padding;
  * ``resize_bilinear`` resizes a map as ``jax.image.resize(...,
    "bilinear")`` does, which antialiases when it downsamples (the depth
    latent of ``mv_generator.py`` and the inpaint mask).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cameras import Camera


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along
    one axis: a triangle kernel widened by the scale when downsampling
    (antialiasing), each column normalised to sum to 1, in float32."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W) float32 → (height, width), as ``jax.image.resize(image,
    (height, width), "bilinear")`` computes it (antialiased when it
    downsamples; an axis of unchanged size is left alone)."""
    H, W = image.shape
    out = image.float()
    if H != height:
        out = torch.as_tensor(_triangle_weights(H, height), device=image.device).T @ out
    if W != width:
        out = out @ torch.as_tensor(_triangle_weights(W, width), device=image.device)
    return out


def scaled_camera(camera: Camera, stride: int, size: int) -> Camera:
    """``camera`` with its intrinsics divided by ``stride``, as a
    ``size``×``size`` feature grid sees it."""
    return Camera(c2w=camera.c2w, fx=camera.fx / stride, fy=camera.fy / stride,
                  cx=camera.cx / stride, cy=camera.cy / stride, width=size, height=size)


def depth_to_world_points(depth: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(H, W) depth (camera z, OpenGL-style camera looking down −z) → (H, W, 3)
    world points."""
    H, W = depth.shape
    xs = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    # camera-space ray directions (OpenGL: x right, y up, looking down -z)
    dx = (px - camera.cx) / camera.fx
    dy = -(py - camera.cy) / camera.fy
    dirs_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    pts_cam = dirs_cam * depth[..., None]
    R = camera.c2w[:3, :3]
    t = camera.c2w[:3, 3]
    return pts_cam @ R.T + t


def project_points(pts_world: torch.Tensor, camera: Camera) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) world points → ((..., 2) pixel xy, (...,) camera depth).

    Depth is the positive distance along the viewing direction; points behind
    the camera get negative depth."""
    R = camera.c2w[:3, :3]
    t = camera.c2w[:3, 3]
    pts_cam = (pts_world - t) @ R  # Rᵀ applied from the right
    z = -pts_cam[..., 2]
    z_safe = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    u = camera.fx * (pts_cam[..., 0] / z_safe) + camera.cx
    v = -camera.fy * (pts_cam[..., 1] / z_safe) + camera.cy
    return torch.stack([u - 0.5, v - 0.5], dim=-1), z


def bilinear_sample(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """grid (H, W, C), xy (..., 2) in pixel coords → (..., C) bilinear samples
    (zero padding outside)."""
    H, W, _ = grid.shape
    x, y = xy[..., 0], xy[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()

    def tap(xi, yi, w):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return grid[yi.clamp(0, H - 1), xi.clamp(0, W - 1)] * (w * inside)[..., None]

    return (
        tap(x0, y0, (1 - fx) * (1 - fy))
        + tap(x0 + 1, y0, fx * (1 - fy))
        + tap(x0, y0 + 1, (1 - fx) * fy)
        + tap(x0 + 1, y0 + 1, fx * fy)
    )
