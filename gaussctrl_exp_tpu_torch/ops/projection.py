"""3D→2D EWA Gaussian projection (frustum cull, covariance splat, tile extent).

Port of ``gaussctrl_exp_tpu/ops/projection.py`` (gsplat v0.1.2's
``project_gaussians``), as plain tensor code over the (N, …) arrays:

  * world→camera transform with near-plane clip (``clip_thresh``),
  * Σ3D = (R S)(R S)ᵀ from quats/scales,
  * EWA: cov2d = J W Σ Wᵀ Jᵀ with the Jacobian clamped to 1.3× the field of
    view, +0.3 px low-pass on the diagonal,
  * conic (inverse cov2d), 3σ radius from the larger eigenvalue,
  * pixel-space centre via the full projection matrix and
    ``ndc2pix(x, S, c) = 0.5·S·x + c − 0.5``,
  * 16×16 tile bbox, tightened to the α ≥ 1/255 level set when opacities are
    given, and the per-gaussian tile-hit count.
"""

from __future__ import annotations

import dataclasses

import torch

BLOCK = 16  # rasterizer tile size


@dataclasses.dataclass
class ProjectedGaussians:
    """Dense per-gaussian projection results."""

    xys: torch.Tensor  # (N, 2) pixel-space centres
    depths: torch.Tensor  # (N,) camera-space z
    radii: torch.Tensor  # (N,) int32 pixel radius (0 = culled)
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (upper triangle)
    num_tiles_hit: torch.Tensor  # (N,) int32
    cov3d: torch.Tensor  # (N, 3, 3)
    mask: torch.Tensor  # (N,) bool visibility
    tile_bbox: torch.Tensor  # (N, 4) int32 [tx0, ty0, tx1, ty1)


def _tile_index(v: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Tile coordinate truncated toward zero (a C int cast, not a floor) and
    clamped to [0, n_tiles]. The float is clamped first because casting an
    out-of-range float to int is undefined; in-range values are unchanged."""
    v = torch.clamp(v, -1.0, n_tiles + 1.0)
    return torch.clamp(v.to(torch.int32), 0, n_tiles)


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    glob_scale: float,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fullmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    img_height: int,
    img_width: int,
    clip_thresh: float = 0.01,
    extra_mask: torch.Tensor | None = None,
    opacities: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project N gaussians to screen space.

    Args:
      means: (N, 3) world positions.
      scales: (N, 3), already exponentiated.
      quats: (N, 4) wxyz, normalized or not.
      viewmat: (4, 4) world→camera.
      fullmat: (4, 4) projmat @ viewmat.
      extra_mask: optional (N,) bool pre-cull (alive mask / crop box).
      opacities: optional (N,) post-sigmoid opacities. When given, the tile
        bbox is cut to the axis-aligned extent of the level set α ≥ 1/255,
        the only region the blend composites, inside gsplat's 3σ square.

    Computes in the promoted type of ``means`` and float32, so float64 inputs
    stay float64.
    """
    dt = torch.promote_types(means.dtype, torch.float32)
    means = means.to(dt)
    Rv = viewmat[:3, :3].to(dt)
    tv = viewmat[:3, 3].to(dt)

    p_view = means @ Rv.T + tv  # (N, 3)
    tz = p_view[:, 2]
    in_front = tz > clip_thresh

    # 3D covariance Σ = R diag(s²) Rᵀ, written out per component
    q = quats.to(dt)
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    qw, qx, qy, qz = q.unbind(-1)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s = scales.to(dt) * glob_scale
    s0sq, s1sq, s2sq = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    c00 = r00 * r00 * s0sq + r01 * r01 * s1sq + r02 * r02 * s2sq
    c01 = r00 * r10 * s0sq + r01 * r11 * s1sq + r02 * r12 * s2sq
    c02 = r00 * r20 * s0sq + r01 * r21 * s1sq + r02 * r22 * s2sq
    c11 = r10 * r10 * s0sq + r11 * r11 * s1sq + r12 * r12 * s2sq
    c12 = r10 * r20 * s0sq + r11 * r21 * s1sq + r12 * r22 * s2sq
    c22 = r20 * r20 * s0sq + r21 * r21 * s1sq + r22 * r22 * s2sq
    cov3d = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c01, c11, c12], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        dim=-2,
    )

    # EWA 2D covariance with the FOV-limited Jacobian
    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tz_safe = torch.where(in_front, tz, 1.0)
    tx = torch.clamp(p_view[:, 0] / tz_safe, -lim_x, lim_x) * tz_safe
    ty = torch.clamp(p_view[:, 1] / tz_safe, -lim_y, lim_y) * tz_safe
    rz = 1.0 / tz_safe
    rz2 = rz * rz
    # J rows: (fx·rz, 0, −fx·tx·rz²), (0, fy·rz, −fy·ty·rz²); T = J @ Rv
    j02 = -fx * tx * rz2
    j12 = -fy * ty * rz2
    t00 = fx * rz * Rv[0, 0] + j02 * Rv[2, 0]
    t01 = fx * rz * Rv[0, 1] + j02 * Rv[2, 1]
    t02 = fx * rz * Rv[0, 2] + j02 * Rv[2, 2]
    t10 = fy * rz * Rv[1, 0] + j12 * Rv[2, 0]
    t11 = fy * rz * Rv[1, 1] + j12 * Rv[2, 1]
    t12 = fy * rz * Rv[1, 2] + j12 * Rv[2, 2]
    # cov2d = T Σ Tᵀ (2×2 symmetric, expanded)
    w00 = t00 * c00 + t01 * c01 + t02 * c02
    w01 = t00 * c01 + t01 * c11 + t02 * c12
    w02 = t00 * c02 + t01 * c12 + t02 * c22
    w10 = t10 * c00 + t11 * c01 + t12 * c02
    w11 = t10 * c01 + t11 * c11 + t12 * c12
    w12 = t10 * c02 + t11 * c12 + t12 * c22
    # low-pass: a splat is at least ~1 px wide (gsplat adds 0.3 to the diagonal)
    a = w00 * t00 + w01 * t01 + w02 * t02 + 0.3
    b_ = w00 * t10 + w01 * t11 + w02 * t12
    c = w10 * t10 + w11 * t11 + w12 * t12 + 0.3

    det = a * c - b_ * b_
    det_valid = det != 0.0
    det_safe = torch.where(det_valid, det, 1.0)
    conics = torch.stack([c / det_safe, -b_ / det_safe, a / det_safe], dim=-1)

    half_tr = 0.5 * (a + c)
    v1 = half_tr + torch.sqrt(torch.clamp(half_tr * half_tr - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(v1, min=0.0)))

    # centre via the full projection matrix
    fm = fullmat.to(dt)
    p_hom = means @ fm[:3, :3].T + fm[:3, 3]
    w_hom = means @ fm[3, :3] + fm[3, 3]
    rw = 1.0 / (w_hom + 1e-6)
    xys = torch.stack(
        [
            0.5 * img_width * (p_hom[:, 0] * rw) + cx - 0.5,
            0.5 * img_height * (p_hom[:, 1] * rw) + cy - 0.5,
        ],
        dim=-1,
    )

    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    if opacities is not None:
        # α(d) = min(0.999, op·e^{−σ(d)}) with σ = ½ dᵀ cov2d⁻¹ d; the blend
        # skips α < 1/255, so only σ ≤ ln(255·op) can contribute. That level
        # set's axis-aligned half-extents are √(2σ·cov2d_ii).
        s_lvl = torch.log(torch.clamp(255.0 * opacities.reshape(-1), min=1e-12)) + 1e-6
        s_pos = torch.clamp(s_lvl, min=0.0)
        hx = torch.minimum(torch.sqrt(2.0 * s_pos * torch.clamp(a, min=0.0)), radius_f)
        hy = torch.minimum(torch.sqrt(2.0 * s_pos * torch.clamp(c, min=0.0)), radius_f)
        opac_visible = s_lvl > 0.0  # op ≤ 1/255 ⇒ α < 1/255 everywhere ⇒ cull
    else:
        hx = hy = radius_f
        opac_visible = torch.ones_like(in_front)
    tile_cx = xys[:, 0] / BLOCK
    tile_cy = xys[:, 1] / BLOCK
    tx0 = _tile_index(tile_cx - hx / BLOCK, tiles_x)
    tx1 = _tile_index(tile_cx + hx / BLOCK + 1.0, tiles_x)
    ty0 = _tile_index(tile_cy - hy / BLOCK, tiles_y)
    ty1 = _tile_index(tile_cy + hy / BLOCK + 1.0, tiles_y)
    area = (tx1 - tx0) * (ty1 - ty0) * opac_visible

    mask = in_front & det_valid & (area > 0)
    if extra_mask is not None:
        mask = mask & extra_mask

    radii = torch.where(mask, radius_f, 0.0).to(torch.int32)
    num_tiles_hit = torch.where(mask, area, 0).to(torch.int32)
    tile_bbox = torch.stack([tx0, ty0, tx1, ty1], dim=-1)
    # culled gaussians get an empty bbox, so expansion sees area 0
    tile_bbox = torch.where(mask[:, None], tile_bbox, 0).to(torch.int32)

    return ProjectedGaussians(
        xys=xys,
        depths=tz,
        radii=radii,
        conics=conics,
        num_tiles_hit=num_tiles_hit,
        cov3d=cov3d,
        mask=mask,
        tile_bbox=tile_bbox,
    )
