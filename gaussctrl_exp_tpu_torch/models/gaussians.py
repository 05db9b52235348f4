"""Gaussian scene parameters at a fixed capacity, with an alive mask.

Port of ``gaussctrl_exp_tpu/models/gaussians.py``: splatfacto's six
parameter groups (raw/log/logit space) as a small dataclass of tensors, plus
the alive mask that marks which slots hold a gaussian.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sh import SH_C0, num_sh_bases

PARAM_NAMES = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


@dataclasses.dataclass
class GaussianParams:
    """Optimizable parameters (raw/log/logit space, like splatfacto)."""

    means: torch.Tensor  # (C, 3)
    scales: torch.Tensor  # (C, 3) log-space
    quats: torch.Tensor  # (C, 4) wxyz, unnormalized
    features_dc: torch.Tensor  # (C, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    opacities: torch.Tensor  # (C, 1) logit-space

    @property
    def capacity(self) -> int:
        return self.means.shape[0]


@dataclasses.dataclass
class GaussianState:
    """Parameters plus the non-optimized alive mask."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool


def rgb_to_sh_dc(rgb):
    """Inverse of the DC SH band: colour = SH_C0 * dc + 0.5."""
    return (rgb - 0.5) / SH_C0


def params_from_numpy(
    arrays: Mapping[str, np.ndarray], device: str | torch.device = "cuda"
) -> GaussianParams:
    """The JAX package's parameters as numpy arrays
    (``jax.device_get(params)._asdict()``) → the port's, as float32 on ``device``."""
    device = resolve_device(device)
    return GaussianParams(
        **{
            name: torch.as_tensor(np.asarray(arrays[name], np.float32), device=device)
            for name in PARAM_NAMES
        }
    )


def _mean_knn_distance(points: np.ndarray, k: int = 3, rows: int = 4096) -> np.ndarray:
    """Mean distance to the k nearest neighbours (splatfacto's scale init),
    brute force in float64, ``rows`` query points at a time."""
    n = points.shape[0]
    if n <= k:
        return np.full(n, 0.01, np.float32)
    pts = torch.as_tensor(points, dtype=torch.float64)
    out = []
    for i in range(0, n, rows):
        d = torch.cdist(pts[i : i + rows], pts)
        nearest = torch.topk(d, k + 1, dim=1, largest=False).values  # self at 0
        out.append(nearest[:, 1:].mean(dim=1))
    return torch.cat(out).numpy().astype(np.float32)


def init_random(
    num: int,
    capacity: Optional[int] = None,
    sh_degree: int = 3,
    extent: float = 1.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> GaussianState:
    """Random init inside a ±extent box (splatfacto's no-seed-points
    fallback), drawing the same numpy numbers as the JAX package's
    ``init_random`` for the same seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(num, 3)).astype(np.float32) - 0.5) * 2 * extent
    rgb = (rng.uniform(size=(num, 3)) * 255).astype(np.uint8)
    return init_from_points(pts, rgb, capacity=capacity, sh_degree=sh_degree, seed=seed, device=device)


def init_from_points(
    points_xyz: np.ndarray,
    points_rgb: Optional[np.ndarray],
    capacity: Optional[int] = None,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> GaussianState:
    """Splatfacto's init from a seed point cloud: means at the points,
    log scales of the mean 3-NN distance, random unit quats, DC features
    from the points' RGB (0..255, or uniform draws without colours),
    opacity logit(init_opacity); slots past the points are dead. Draws the
    same numpy numbers as the JAX package's ``init_from_points``."""
    device = resolve_device(device)
    n = points_xyz.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} seed points")
    K = num_sh_bases(sh_degree)
    rng = np.random.default_rng(seed)

    means = np.zeros((capacity, 3), np.float32)
    means[:n] = points_xyz
    dist = _mean_knn_distance(np.asarray(points_xyz, np.float32))
    scales = np.full((capacity, 3), -10.0, np.float32)
    scales[:n] = np.log(np.maximum(dist, 1e-7))[:, None]
    quats = rng.normal(size=(capacity, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    fdc = np.zeros((capacity, 3), np.float32)
    if points_rgb is not None:
        fdc[:n] = rgb_to_sh_dc(points_rgb.astype(np.float32) / 255.0)
    else:
        fdc[:n] = rng.uniform(size=(n, 3)).astype(np.float32)
    frest = np.zeros((capacity, K - 1, 3), np.float32)
    opac = np.full((capacity, 1), np.log(init_opacity / (1 - init_opacity)), np.float32)

    params = params_from_numpy(
        dict(means=means, scales=scales, quats=quats, features_dc=fdc,
             features_rest=frest, opacities=opac),
        device,
    )
    return GaussianState(params, torch.arange(capacity, device=device) < n)
