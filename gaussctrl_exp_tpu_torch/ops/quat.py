"""Quaternion → rotation and 3D covariance construction.

Port of ``gaussctrl_exp_tpu/ops/quat.py`` (gsplat v0.1.2's
``quat_to_rotmat`` / ``scale_rot_to_cov3d``): quaternions are (w, x, y, z),
Σ = (R S)(R S)ᵀ with S = diag(scale) · glob_scale.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions (not necessarily normalized) → (..., 3, 3)."""
    q = normalize(quats)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def scale_rot_to_cov3d(
    scales: torch.Tensor, quats: torch.Tensor, glob_scale: float = 1.0
) -> torch.Tensor:
    """(N, 3) scales (already exponentiated), (N, 4) wxyz quats → (N, 3, 3) Σ."""
    R = quat_to_rotmat(quats)
    M = R * (scales * glob_scale)[..., None, :]
    return M @ M.transpose(-1, -2)
