"""Plain reference of the fork's TriPlane cross-view attention, the processor
that GaussCtrl's experimental fork (Ubinya/gaussctrl_exp) hooks into its
edit loop in place of AttnAlign (``gc_pipeline.py:329-331``, the processor
``TriPlaneAttnProcessor`` of ``mv_pointnet.py:29-151``): the plane pooling of
Convolutional Occupancy Networks (Peng et al., arXiv:2003.04618) over the
world points of the views' rendered depths.

Written from the equations, in float32 with TF32 off (every product of the
attention through ``precision.q``, so that a control can round it), over
the views' depths (V, H, W) and cameras (dicts of ``c2w`` (3, 4) OpenGL,
``fx``, ``fy``, ``cx``, ``cy``):

* World points, on the g × g grid of the attention (g = 64 at the latent
  grid): the depth of pixel (s//2 + s·i, s//2 + s·j), s = H / g, on the ray
  through the centre (j + ½, i + ½) of the grid's cell, with the intrinsics
  divided by s: x = (j + ½ − cx/s)/(fx/s)·d, y = −(i + ½ − cy/s)/(fy/s)·d,
  z = −d in the camera (it looks down −z), then R·(x, y, z) + t.
* Normalised: p / bbox_length + ½, clamped to [0, 1 − 1e-6].
* Planes xy, xz, yz at r × r: a token at (u, w) on a plane falls in the cell
  (⌊w·r⌋, ⌊u·r⌋), clamped to the plane. Each cell holds the mean of the
  values v (heads flattened, C = H·D wide) of the tokens of all B rows (both
  CFG groups) that fall in it, 0 where none do. The sums and counts are
  taken with ``index_add_`` in float64, so that the order of the adds does
  not change the plane, and the mean is rounded to float32 once.
* Each token's features: the mean over the three planes of the bilinear
  sample at (u·r − ½, w·r − ½) in cell units (cell centres at integers),
  with zero padding outside the plane.
* out = mix · softmax(q·kᵀ/√D)·v + (1 − mix) · softmax(q·fᵀ/√D)·f, f the
  features as keys and values (``sd.sdpa``), in every self-attention whose
  length is the grid's; every other attention is plain.

One processor goes to the UNet and to the ControlNet alike, as the fork and
the JAX package give it: plug it into ``sd.generate`` as ``sd.attn_align``.

Departures:
* From ``mv_pointnet.py`` as SURVEY.md §2 reads it: the fork scatters the
  layer's hidden states; the JAX package and this reference pool the values
  v. The fork's ``torch_scatter.scatter_mean`` (``generate_plane_features``
  :154-173, ``coordinate2index`` :301-313) is ``index_add_`` sums over
  counts here; its ``grid_sample`` (``sample_plane_feature`` :266-273) is
  the bilinear sample above. Its rays (``compute_ray_directions``,
  ``gc_pipeline.py:503-536``) assume fov_y = 0.888 rad; here each camera's
  own intrinsics.
* From the JAX processor: its planes are ``segment_sum`` in float32; here
  float64 sums. Its geometry is the pipeline's, computed with a matrix
  product; here the sums written out.
"""

from __future__ import annotations

import torch

from .sd import sdpa

PLANES = ((0, 1), (0, 2), (1, 2))  # xy, xz, yz
CLAMP_HI = 1.0 - 1e-6


def world_points(depths: torch.Tensor, cams: list[dict], grid: int) -> torch.Tensor:
    """(V, H, W) depths → (V, grid·grid, 3) float32 world points, row-major."""
    V, H = depths.shape[0], depths.shape[1]
    s = H // grid
    c = torch.arange(grid, dtype=torch.float32, device=depths.device) + 0.5
    pi, pj = c[:, None].expand(grid, grid).reshape(-1), c[None, :].expand(grid, grid).reshape(-1)
    out = []
    for d_full, cam in zip(depths.float(), cams):
        d = d_full[s // 2 :: s, s // 2 :: s][:grid, :grid].reshape(-1)
        x = (pj - cam["cx"] / s) / (cam["fx"] / s) * d
        y = -(pi - cam["cy"] / s) / (cam["fy"] / s) * d
        z = -d
        M = torch.as_tensor(cam["c2w"], dtype=torch.float32, device=depths.device)
        out.append(torch.stack([x * M[r, 0] + y * M[r, 1] + z * M[r, 2] + M[r, 3] for r in range(3)], -1))
    return torch.stack(out)


def plane(feats: torch.Tensor, u: torch.Tensor, w: torch.Tensor, res: int, shift: int = 0) -> torch.Tensor:
    """(N, C) features at plane coordinates (u, w) in [0, 1) → (res, res, C)
    float32 cell means (float64 sums and counts), rows indexed by w; with
    ``shift``, each token pooled that many cells further along u (a fault)."""
    cell = (w * res).long().clamp(0, res - 1) * res + ((u * res).long() + shift).clamp(0, res - 1)
    f64 = torch.float64
    sums = torch.zeros((res * res, feats.shape[1]), dtype=f64, device=feats.device).index_add_(0, cell, feats.to(f64))
    counts = torch.zeros(res * res, dtype=f64, device=feats.device).index_add_(
        0, cell, torch.ones(feats.shape[0], dtype=f64, device=feats.device))
    return (sums / counts.clamp(min=1.0)[:, None]).float().reshape(res, res, -1)


def bilinear(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(R, R, C) grid sampled at (x, y) in cell units, zero outside → (N, C)."""
    R = grid.shape[0]
    padded = torch.nn.functional.pad(grid, (0, 0, 1, 1, 1, 1))  # a ring of zeros around the plane
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    # cells −1 .. R are rows 0 .. R + 1 of the padded grid; beyond them the tap is zero too
    xi, yi = x0.long() + 1, y0.long() + 1

    def tap(dx, dy):
        xx, yy = xi + dx, yi + dy
        inside = ((xx >= 0) & (xx <= R + 1) & (yy >= 0) & (yy <= R + 1))[:, None]
        return padded[yy.clamp(0, R + 1), xx.clamp(0, R + 1)] * inside

    return ((1 - fx) * (1 - fy) * tap(0, 0) + fx * (1 - fy) * tap(1, 0) + (1 - fx) * fy * tap(0, 1)
            + fx * fy * tap(1, 1))


def features(vh: torch.Tensor, norm: torch.Tensor, res: int, shift: int = 0) -> torch.Tensor:
    """Values (B, H, S, D) and normalised points (V, S, 3) → the tokens'
    triplane features (B, H, S, D), float32."""
    B, H, S, D = vh.shape
    V = norm.shape[0]
    feats = vh.transpose(1, 2).reshape(B * S, H * D)
    p = norm.repeat(B // V, 1, 1).reshape(B * S, 3)
    tri = 0.0
    for a, b in PLANES:
        u, w = p[:, a], p[:, b]
        tri = tri + bilinear(plane(feats, u, w, res, shift), u * res - 0.5, w * res - 0.5)
    return (tri / 3.0).reshape(B, S, H, D).transpose(1, 2)


def normalise(pts: torch.Tensor, bbox_length: float) -> torch.Tensor:
    return torch.clamp(pts.float() / bbox_length + 0.5, 0.0, CLAMP_HI)


def processor(pts: torch.Tensor, mix: float, bbox_length: float, res: int, shift: int = 0):
    """The triplane processor over world points ``pts`` (V, S, 3); ``shift``
    pools every token ``shift`` cells off along u, the fault of a plane index
    off by that much."""
    norm = normalise(pts, bbox_length)

    def proc(qh, kh, vh, is_cross):
        out = sdpa(qh, kh, vh)
        if is_cross or qh.shape[2] != norm.shape[1] or mix == 1.0:
            return out
        f = features(vh.float(), norm, res, shift)
        return mix * out + (1.0 - mix) * sdpa(qh, f, f)

    return proc
