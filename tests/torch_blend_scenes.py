"""Blend inputs made in screen space from a seed, for the blend kernels'
edge cases (several 256-gaussian batches a tile, one tile far heavier than
the rest, every pixel stopped early): (xys, conics, colors, opacs), the tile
bins and the image size, on any device. No JAX."""

import numpy as np
import torch

from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
from gaussctrl_exp_tpu_torch.ops.projection import BLOCK, ProjectedGaussians


def screen_scene(device, n=400, H=48, W=64, n_chan=4, seed=0, opacity=(0.2, 0.95), sd=(1.5, 6.0),
                 rho=(-0.5, 0.5), cluster=None, front=None):
    """``n`` gaussians uniform over an H×W image with pixel standard
    deviations drawn from ``sd``, correlations from ``rho`` and opacities
    from ``opacity``. ``cluster = (m, x, y)`` puts the first m centres
    within 2 px of (x, y); ``front = (m, opacity)`` makes the first m nearest
    the camera, 200 px wide and of that opacity. Depth order is a random permutation; bounding boxes
    reach 3 standard deviations."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform((0.0, 0.0), (W, H), (n, 2))
    s = rng.uniform(*sd, (n, 2))
    rho = rng.uniform(*rho, n)
    depth = rng.permutation(n).astype(np.float64) + 1.0
    if cluster is not None:
        m, cx, cy = cluster
        xy[:m] = rng.normal((cx, cy), 2.0, (m, 2))
    opac = rng.uniform(*opacity, n)
    if front is not None:
        m, o = front
        s[:m], rho[:m], opac[:m], depth[:m] = 200.0, 0.0, o, -np.arange(m, 0, -1)
    det = (s[:, 0] * s[:, 1]) ** 2 * (1 - rho**2)
    conics = np.stack([s[:, 1] ** 2 / det, -rho * s[:, 0] * s[:, 1] / det, s[:, 0] ** 2 / det], -1)
    r = 3.0 * s.max(-1)
    tiles_x, tiles_y = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bbox = np.stack([np.clip(np.floor((xy[:, 0] - r) / BLOCK), 0, tiles_x),
                     np.clip(np.floor((xy[:, 1] - r) / BLOCK), 0, tiles_y),
                     np.clip(np.floor((xy[:, 0] + r) / BLOCK) + 1, 0, tiles_x),
                     np.clip(np.floor((xy[:, 1] + r) / BLOCK) + 1, 0, tiles_y)], -1).astype(np.int32)
    hit = ((bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])).astype(np.int32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    proj = ProjectedGaussians(
        xys=t(xy), depths=t(depth), radii=t(np.ceil(r), torch.int32), conics=t(conics),
        num_tiles_hit=t(hit, torch.int32), cov3d=torch.zeros((n, 3, 3), device=device),
        mask=t(hit > 0, torch.bool), tile_bbox=t(bbox, torch.int32))
    bins = bin_gaussians(proj, tiles_x, tiles_y)
    colors = t(rng.uniform(0, 1, (n, n_chan)))
    return (proj.xys, proj.conics, colors, t(opac)), bins, H, W
