"""Real spherical-harmonics colour evaluation (degrees 0–4).

Port of ``gaussctrl_exp_tpu/ops/sh.py`` (gsplat v0.1.2's
``spherical_harmonics``): coefficients are laid out ``[dc, rest]`` along
axis 1, and bases above the active degree
``min(step // interval, sh_degree)`` are masked out.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit view directions → (N, (degree+1)²) SH basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(active_degree, dirs: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH colours with a runtime active degree.

    Args:
      active_degree: int or 0-d tensor in [0, max_degree]; bases of degree
        above it are masked to zero.
      dirs: (N, 3) unit directions.
      coeffs: (N, K, 3) with K = (max_degree+1)², ordered [dc, rest].

    Returns (N, 3) colours without the model's ``+0.5`` shift.
    """
    K = coeffs.shape[-2]
    max_degree = math.isqrt(K) - 1
    basis = sh_basis(max_degree, dirs)  # (N, K)
    # degree of each basis index: l such that l² <= idx < (l+1)²
    idx = torch.arange(K, device=dirs.device, dtype=torch.float32)
    lvl = torch.floor(torch.sqrt(idx + 1e-6))
    mask = (lvl <= active_degree).to(basis.dtype)
    return torch.sum((basis * mask)[..., :, None] * coeffs, dim=-2)
