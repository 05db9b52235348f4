"""The tile blend's work (kernels B1 forward, B2 backward), counted on the
benchmark's own reference projection and binning of the same inputs.

A pixel walks its tile's depth-sorted list up to the gaussian that stops it.
Of those pairs, the kernels evaluate the ones whose gaussian's footprint box
meets the pixel's warp (two rows of the tile): no other pair can pass the
alpha test. The evaluated pairs that pass the alpha tests before the stop
are composited. Operations per pair, in float32:

* evaluated (B1 and B2 alike): dx, dy, sigma (9), the sigma test, −sigma,
  exp (one), × opacity, the clamp, the alpha test: 17;
* composited, forward: 1 − α, T ×, the stop test, the weight (4) and a
  multiply-add per channel (2C);
* composited, backward: those 4, the channel cotangent (2C), prefix (2),
  suffix (1), dα (4), dσ (2), dxy (6), dconic (8), dopacity (1), dcolour
  (C) and the sum of the 6 + C gradients over the tile (6 + C): 34 + 4C.

Bytes: each input read once and each output written once.
"""

from __future__ import annotations

import torch

from ..reference import splat as ref

OPS_EVALUATED = 17
OPS_COMPOSITED = 4  # + 2 per channel
OPS_BWD_COMPOSITED = 34  # + 4 per channel
# the kernels' footprint box (kSkipMargin, kBoxLevelScale, kBoxLevelPad,
# kBoxWiden, kBoxPad, kBoxDet): no pixel outside it takes the gaussian
SKIP_MARGIN, BOX_DET = 1e-2, 1e-3
BOX_LEVEL_SCALE, BOX_LEVEL_PAD, BOX_WIDEN, BOX_PAD = 1.01, 1e-2, 1.001, 1e-3
WARP_ROWS = 2


def footprint_box(xys, conic, opac):
    """(N, 4) boxes (x0, x1, y0, y1) outside which sigma exceeds the level
    past which alpha < 1/255."""
    x, y = xys.float().unbind(-1)
    a, b, c = conic.float().unbind(-1)
    skip = torch.log(255.0 * opac.float()) + SKIP_MARGIN
    det = a * c - b * b
    level = 2.0 * (BOX_LEVEL_SCALE * skip + BOX_LEVEL_PAD)
    ex = torch.sqrt(level * c / det) * BOX_WIDEN + BOX_PAD
    ey = torch.sqrt(level * a / det) * BOX_WIDEN + BOX_PAD
    box = torch.stack([x - ex, x + ex, y - ey, y + ey], -1)
    inf = torch.inf
    drawn = (a > 0) & (c > 0) & (det >= BOX_DET * a * c)
    box = torch.where(drawn[:, None], box, box.new_tensor([-inf, inf, -inf, inf]))
    box = torch.where((skip < 0)[:, None], box.new_tensor([inf, -inf, inf, -inf]), box)
    return torch.where(torch.isnan(skip)[:, None], box.new_tensor([-inf, inf, -inf, inf]), box)


@torch.no_grad()
def pairs(xys, conic, opac, bins, W: int, H: int, batch_elems: int = 1 << 22) -> dict:
    """Walked, evaluated and composited (pixel, gaussian) pairs of a frame."""
    ids, starts, counts = bins
    B_ = ref.BLOCK
    nx, ny = (W + B_ - 1) // B_, (H + B_ - 1) // B_
    P = B_ * B_
    dev = xys.device
    box = footprint_box(xys, conic, opac)
    cnt = counts.tolist()
    lin = torch.arange(P, device=dev)
    tot = dict(walked=0, evaluated=0, composited=0)
    t0 = 0
    while t0 < nx * ny:
        t1, K = t0 + 1, cnt[t0]
        while t1 < nx * ny and (t1 + 1 - t0) * max(K, cnt[t1]) * P <= batch_elems:
            K = max(K, cnt[t1])
            t1 += 1
        if K:
            tid = torch.arange(t0, t1, device=dev)
            px = ((tid % nx)[:, None] * B_ + lin % B_).float()
            py = ((tid // nx)[:, None] * B_ + lin // B_).float()
            ks = torch.arange(K, device=dev)
            valid = ks[None] < counts[t0:t1, None]
            g = ids[torch.where(valid, starts[t0:t1, None] + ks[None], 0)]
            a = ref.tile_alphas(xys, conic, opac, g, valid, px, py)
            Tafter = torch.cumprod(1.0 - a, -1)
            stopped = (Tafter <= ref.T_EPS) & (a > 0)
            first = torch.where(stopped, ks, K).amin(-1)
            n = torch.minimum(first + 1, counts[t0:t1, None])  # (B, P) pairs walked
            bx = box[g][:, None]  # (B, 1, K, 4)
            x0 = px[:, :1, None]
            y0 = (py - (lin // B_) % WARP_ROWS)[..., None]
            meets = ~((bx[..., 1] < x0) | (bx[..., 0] > x0 + (B_ - 1)) | (bx[..., 3] < y0)
                      | (bx[..., 2] > y0 + (WARP_ROWS - 1)))
            walk = ks < n[..., None]
            tot["walked"] += int(n.sum())
            tot["evaluated"] += int((meets & walk).sum())
            tot["composited"] += int(((Tafter > ref.T_EPS) & (a > 0)).sum())
        t0 = t1
    return tot


def blend_ops(C: int, evaluated: int, composited: int, backward: bool = False) -> int:
    per = OPS_BWD_COMPOSITED + 4 * C if backward else OPS_COMPOSITED + 2 * C
    return OPS_EVALUATED * evaluated + per * composited


def blend_bytes(N: int, C: int, n_isects: int, W: int, H: int, backward: bool = False) -> int:
    tiles = ((W + 15) // 16) * ((H + 15) // 16)
    n = 4 * (N * (2 + 3 + C + 1) + n_isects + 2 * tiles + H * W * (C + 1))
    if backward:  # + the forward's outputs and the cotangents read, the gradients written
        n += 4 * (H * W * (C + 1) + N * (6 + C))
    return n
