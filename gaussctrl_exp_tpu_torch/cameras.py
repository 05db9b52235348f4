"""Camera model: intrinsics, pose → view/projection matrices.

Port of ``gaussctrl_exp_tpu/cameras.py``. Conventions are the reference's
(nerfstudio OpenGL camera-to-world with the gsplat y/z flip):

  * ``c2w`` is 3×4 OpenGL-style (camera looks down −z, y up).
  * gsplat flips y/z: R ← R · diag(1, −1, −1); viewmat = [R|t]⁻¹.
  * the projection matrix maps +z-forward view space with near 0.001 and
    far 1000 (w = +z).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device

NEAR_PLANE = 0.001
FAR_PLANE = 1000.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera: a (3, 4) pose and 0-d intrinsics tensors on one device."""

    c2w: torch.Tensor  # (3, 4) camera-to-world, OpenGL convention
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 512
    height: int = 512

    @property
    def fovx(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.width / (2.0 * self.fx))

    @property
    def fovy(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.height / (2.0 * self.fy))


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def projection_matrix(znear: float, zfar: float, fovx, fovy) -> torch.Tensor:
    """nerfstudio splatfacto-style projection (w = +z)."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=fovx.device)
    t = znear * torch.tan(0.5 * fovy)
    r = znear * torch.tan(0.5 * fovx)
    n, f = znear, zfar
    zero = torch.zeros_like(fovx)
    one = torch.ones_like(zero)
    return _matrix(
        [
            [n / r, zero, zero, zero],
            [zero, n / t, zero, zero],
            [zero, zero, (f + n) / (f - n) * one, -f * n / (f - n) * one],
            [zero, zero, one, zero],
        ]
    )


def projection_matrix_ogl(znear: float, zfar: float, fovx, fovy) -> torch.Tensor:
    """OpenGL projection (−n→−1, −f→1), the model's ``mat_proj`` output."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=fovx.device)
    t = znear * torch.tan(0.5 * fovy)
    r = znear * torch.tan(0.5 * fovx)
    n, f = znear, zfar
    zero = torch.zeros_like(fovx)
    one = torch.ones_like(zero)
    return _matrix(
        [
            [n / r, zero, zero, zero],
            [zero, n / t, zero, zero],
            [zero, zero, -(f + n) / (f - n) * one, -2.0 * f * n / (f - n) * one],
            [zero, zero, -one, zero],
        ]
    )


def view_matrix(c2w: torch.Tensor, gsplat_flip: bool = True) -> torch.Tensor:
    """(3|4, 4) camera-to-world → (4, 4) world→camera view matrix.

    With ``gsplat_flip`` the y/z axes are negated first, so view space has +z
    forward and +y down, the convention the projection and EWA math expect.
    """
    dtype = torch.promote_types(c2w.dtype, torch.float32)
    R = c2w[:3, :3].to(dtype)
    t = c2w[:3, 3].to(dtype)
    if gsplat_flip:
        R = torch.cat([R[:, :1], -R[:, 1:]], dim=1)
    R_inv = R.T
    vm = torch.eye(4, dtype=dtype, device=c2w.device)
    vm[:3, :3] = R_inv
    vm[:3, 3] = -R_inv @ t
    return vm


def camera_matrices(cam: Camera) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (viewmat, projmat, fullmat = projmat @ viewmat)."""
    vm = view_matrix(cam.c2w)
    pm = projection_matrix(NEAR_PLANE, FAR_PLANE, cam.fovx, cam.fovy)
    return vm, pm, pm @ vm


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL c2w (3, 4) looking from ``eye`` at ``target`` (host-side numpy)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, np.float32)
    right = np.cross(forward, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, forward)
    # OpenGL: the camera looks down -z, so the z axis is -forward
    R = np.stack([right, true_up, -forward], axis=1)
    return np.concatenate([R, eye[:, None]], axis=1).astype(np.float32)


def make_camera(
    c2w, fx: float, fy: float, cx: float, cy: float, width: int, height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """Build a :class:`Camera` on ``device`` from a 3×4 or 4×4 pose."""
    device = resolve_device(device)
    c2w = np.asarray(c2w, np.float32)
    c2w = c2w.reshape(3, 4) if c2w.size == 12 else c2w.reshape(4, 4)[:3, :4]

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    return Camera(
        c2w=torch.as_tensor(np.ascontiguousarray(c2w), device=device),
        fx=scalar(fx),
        fy=scalar(fy),
        cx=scalar(cx),
        cy=scalar(cy),
        width=int(width),
        height=int(height),
    )


def stack_cameras(cams: list) -> Camera:
    """One :class:`Camera` whose fields stack those of ``cams``: ``c2w``
    (V, 3, 4), intrinsics (V,); width and height are the first camera's."""
    return Camera(
        c2w=torch.stack([c.c2w for c in cams]),
        fx=torch.stack([c.fx for c in cams]),
        fy=torch.stack([c.fy for c in cams]),
        cx=torch.stack([c.cx for c in cams]),
        cy=torch.stack([c.cy for c in cams]),
        width=cams[0].width,
        height=cams[0].height,
    )
