"""Camera pose optimization (the ``camera_opt`` parameter group).

Port of ``gaussctrl_exp_tpu/models/camera_opt.py``: per-view 6-vector
tangent deltas ``(ω, t)`` applied to the camera-to-world pose by the SO3
exponential map and a translation, differentiable through the renderer.
"""

from __future__ import annotations

import dataclasses

import torch

from ..cameras import Camera


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """(…, 3) axis-angle → (…, 3, 3) rotation.

    Rodrigues without axis normalization, R = I + sinc(θ)·Ω + c2(θ)·Ω² with
    Ω = skew(ω), so the gradient is finite at ω = 0: both branches are
    evaluated on safe inputs."""
    ox, oy, oz = omega.unbind(-1)
    zero = torch.zeros_like(ox)
    Om = torch.stack(
        [
            torch.stack([zero, -oz, oy], -1),
            torch.stack([oz, zero, -ox], -1),
            torch.stack([-oy, ox, zero], -1),
        ],
        dim=-2,
    )
    th2 = (omega * omega).sum(-1)
    small = th2 < 1e-8
    th2_safe = torch.where(small, 1.0, th2)
    th = torch.sqrt(th2_safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)  # sinc
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(Om.shape)
    return eye + a[..., None, None] * Om + b[..., None, None] * (Om @ Om)


def apply_pose_delta(camera: Camera, delta6: torch.Tensor) -> Camera:
    """Adjust a camera's pose by a tangent-space delta (ω[3], t[3])."""
    R = exp_so3(delta6[:3]) @ camera.c2w[:3, :3]
    t = camera.c2w[:3, 3] + delta6[3:]
    return dataclasses.replace(camera, c2w=torch.cat([R, t[:, None]], dim=1))
