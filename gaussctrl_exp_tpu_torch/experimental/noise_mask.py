"""Multi-view-consistent 3D noise masks.

Port of ``gaussctrl_exp_tpu/experimental/noise_mask.py``. The reference's
OpenGL ``MultiVeiwNoiseRenderer`` thresholds a Perlin field on a 100³ grid in
a 2-unit cube (threshold 0.8), draws the surviving points as spheres
(radius 0.015) and keeps the fragments whose depth is within 0.016 of the
3DGS depth map. Here each surviving point is an isotropic Gaussian splat,
the depth test is a gather from the rendered depth at the projected centres,
and the render is the port's ``ops/renderer.render`` (kernel B1 on the
card). The Perlin field is the JAX package's numpy gradient noise, copied
here so that the port imports nothing of that package; it gives the same
field for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cameras import Camera, camera_matrices
from ..ops.projection import project_gaussians
from ..ops.renderer import RenderConfig, render


def _fade(t: np.ndarray) -> np.ndarray:
    return t * t * t * (t * (t * 6 - 15) + 10)


def perlin_noise_3d(
    shape: tuple[int, int, int],
    scale: float = 0.2,
    octaves: int = 1,
    persistence: float = 1.0,
    lacunarity: float = 2.0,
    seed: int = 99,
    normalize: bool = True,
) -> np.ndarray:
    """Classic 3D Perlin gradient noise on a grid, vectorised numpy; the
    reference renderer's operating point is scale 0.2, seed 99."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.float64)
    amp, freq = 1.0, scale
    for _ in range(max(octaves, 1)):
        out += amp * _perlin_octave(shape, freq, rng)
        amp *= persistence
        freq *= lacunarity
    if normalize:
        lo, hi = out.min(), out.max()
        out = (out - lo) / max(hi - lo, 1e-12)
    return out


def _perlin_octave(shape, freq: float, rng) -> np.ndarray:
    # sample coordinates in lattice space
    coords = [np.arange(n) * freq for n in shape]
    X, Y, Z = np.meshgrid(*coords, indexing="ij")
    xi, yi, zi = (np.floor(v).astype(int) for v in (X, Y, Z))
    xf, yf, zf = X - xi, Y - yi, Z - zi

    # gradients at lattice corners via a permutation hash (classic Perlin)
    perm = rng.permutation(256)
    perm = np.concatenate([perm, perm])
    grads = rng.normal(size=(256, 3))
    grads /= np.linalg.norm(grads, axis=1, keepdims=True)

    def dot(ix, iy, iz, dx, dy, dz):
        gr = grads[perm[perm[perm[ix & 255] + (iy & 255)] + (iz & 255)]]
        return gr[..., 0] * dx + gr[..., 1] * dy + gr[..., 2] * dz

    u, v, w = _fade(xf), _fade(yf), _fade(zf)
    n000 = dot(xi, yi, zi, xf, yf, zf)
    n100 = dot(xi + 1, yi, zi, xf - 1, yf, zf)
    n010 = dot(xi, yi + 1, zi, xf, yf - 1, zf)
    n110 = dot(xi + 1, yi + 1, zi, xf - 1, yf - 1, zf)
    n001 = dot(xi, yi, zi + 1, xf, yf, zf - 1)
    n101 = dot(xi + 1, yi, zi + 1, xf - 1, yf, zf - 1)
    n011 = dot(xi, yi + 1, zi + 1, xf, yf - 1, zf - 1)
    n111 = dot(xi + 1, yi + 1, zi + 1, xf - 1, yf - 1, zf - 1)
    nx00 = n000 * (1 - u) + n100 * u
    nx10 = n010 * (1 - u) + n110 * u
    nx01 = n001 * (1 - u) + n101 * u
    nx11 = n011 * (1 - u) + n111 * u
    nxy0 = nx00 * (1 - v) + nx10 * v
    nxy1 = nx01 * (1 - v) + nx11 * v
    return nxy0 * (1 - w) + nxy1 * w


@dataclasses.dataclass(frozen=True)
class NoiseMaskConfig:
    """Operating point of the reference renderer."""

    cube_size: float = 2.0
    resolution: int = 100
    noise_threshold: float = 0.8
    noise_seed: int = 99
    noise_scale: float = 0.2
    noise_unit_size: float = 0.015  # sphere radius
    frag_depth_threshold: float = 0.016  # depth visibility window


def noise_points(cfg: NoiseMaskConfig = NoiseMaskConfig()) -> np.ndarray:
    """Perlin-thresholded point cloud in the centred cube, (N, 3) float32."""
    r = cfg.resolution
    axis = np.linspace(-cfg.cube_size / 2, cfg.cube_size / 2, r)
    xx, yy, zz = np.meshgrid(axis, axis, axis)
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    field = perlin_noise_3d((r, r, r), scale=cfg.noise_scale, seed=cfg.noise_seed)
    return pts[field.ravel() > cfg.noise_threshold].astype(np.float32)


def render_noise_mask(
    points: np.ndarray,
    scene_depth,  # (H, W) or (H, W, 1) view-space depth from the 3DGS render
    camera: Camera,
    cfg: NoiseMaskConfig = NoiseMaskConfig(),
    render_cfg: RenderConfig | None = None,
) -> torch.Tensor:
    """(H, W) float mask in [0, 1] on the camera's device: the noise spheres
    visible at the scene surface. Visibility is |point depth − scene depth at
    its pixel| < window, tested per point before splatting."""
    H, W = camera.height, camera.width
    dev = camera.c2w.device
    depth2d = torch.as_tensor(scene_depth, dtype=torch.float32, device=dev).reshape(H, W)
    n = points.shape[0]
    means = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    scales = torch.full((n, 3), cfg.noise_unit_size, dtype=torch.float32, device=dev)
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n, 1)
    opacs = torch.ones(n, dtype=torch.float32, device=dev)

    # depth test at the projected centres: one projection pass
    vm, _, fm = camera_matrices(camera)
    proj = project_gaussians(means, scales, 1.0, quats, vm, fm, camera.fx, camera.fy,
                             camera.cx, camera.cy, H, W)
    px = torch.round(proj.xys[:, 0]).long().clamp(0, W - 1)
    py = torch.round(proj.xys[:, 1]).long().clamp(0, H - 1)
    visible = proj.mask & ((proj.depths - depth2d[py, px]).abs() < cfg.frag_depth_threshold)

    out = render(means, scales, quats, torch.ones((n, 3), device=dev), opacs, camera,
                 background=torch.zeros(3, device=dev),
                 cfg=render_cfg or RenderConfig(render_depth=False), extra_mask=visible)
    return out.alpha[..., 0]
