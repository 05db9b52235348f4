"""Front-to-back alpha blend — the plain PyTorch version.

Port of ``gaussctrl_exp_tpu/ops/blend.py``. Per pixel, over the tile's
gaussians in depth order (gsplat v0.1.2's ``rasterize_gaussians``):

    σ  = ½(c_a dx² + c_c dy²) + c_b dx dy;  skip if σ < 0
    α  = min(0.999, opac · e^{−σ});         skip if α < 1/255
    next_T = T·(1−α);  stop (without compositing) if next_T ≤ 1e-4
    out += α·T·colour;  T = next_T

Pixel coordinates are integers (no +0.5); ``xys`` already carries the −0.5.
The loop is written as tensor algebra: ``T_after = cumprod(1−α)`` along the
gaussian axis, the stop is the mask ``T_after > 1e-4`` (the product never
increases), and the output is a (pixels × gaussians) @ (gaussians × channels)
product. This is the version CPU tensors take and the one the CUDA kernels
(``blend_cuda.py``) are held against; its autograd is the plain version of
the blend backward.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import TileBins
from .projection import BLOCK

ALPHA_CLAMP = 0.999
MIN_ALPHA = 1.0 / 255.0
T_EPS = 1e-4
P = BLOCK * BLOCK  # pixels per tile

# The box of a gaussian's footprint outside which no pixel takes it, as the
# CUDA kernels draw it (csrc/blend_common.cuh, which names these constants
# kSkipMargin, kBoxDet, kBoxLevelScale, kBoxLevelPad, kBoxWiden, kBoxPad): a
# warp of B1 or B2 (two rows of a tile) evaluates only the gaussians whose box
# meets its pixels
SKIP_MARGIN = 1e-2
BOX_DET = 1e-3
BOX_LEVEL_SCALE, BOX_LEVEL_PAD = 1.01, 1e-2
BOX_WIDEN, BOX_PAD = 1.001, 1e-3
WARP_ROWS = 2  # rows of a tile a warp of 32 pixels holds

# tiles per batch are chosen so that batch × pixels × longest list stays at
# or under this many elements (each intermediate is one such f32 tensor)
_BATCH_ELEMS = 1 << 22


@dataclasses.dataclass
class BlendOutputs:
    img: torch.Tensor  # (H, W, C) composited channels, no background
    final_T: torch.Tensor  # (H, W) remaining transmittance


def blend_weights(alpha_eff: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compositing algebra shared by the tiled and naive paths.

    alpha_eff: (..., G) effective alphas in depth order (0 where skipped).
    Returns (w, final_T): per-gaussian weights α·T_excl (0 past the stop),
    and the transmittance left for the background.
    """
    one_m = 1.0 - alpha_eff
    T_after = torch.cumprod(one_m, dim=-1)
    T_excl = T_after / one_m  # alpha ≤ 0.999 ⇒ one_m ≥ 0.001
    composited = (T_after > T_EPS) & (alpha_eff > 0.0)
    w = torch.where(composited, alpha_eff * T_excl, 0.0)
    final_T = torch.where(composited, T_after, 1.0).amin(dim=-1)
    return w, final_T


class _ClampAlpha(torch.autograd.Function):
    """``min(x, 0.999)`` whose gradient passes the clamp untouched.

    gsplat v0.1.2's backward and the JAX package's kernel backward
    (``blend_pallas.py:260``) do not gate dσ and dopacity on the clamp, so
    the port does not either; autograd of a plain ``clamp`` would."""

    @staticmethod
    def forward(ctx, x):
        return torch.clamp(x, max=ALPHA_CLAMP)

    @staticmethod
    def backward(ctx, g):
        return g


def clamp_alpha(x: torch.Tensor) -> torch.Tensor:
    return _ClampAlpha.apply(x)


def _alphas(xy, con, opa, px, py, valid):
    """Effective alphas of gaussians (…, K) at pixels (…, P) → (…, P, K)."""
    dx = xy[..., None, :, 0] - px[..., :, None]
    dy = xy[..., None, :, 1] - py[..., :, None]
    ca, cb, cc = con[..., None, :, 0], con[..., None, :, 1], con[..., None, :, 2]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = clamp_alpha(opa[..., None, :] * torch.exp(-sigma))
    skip = (sigma < 0.0) | (alpha < MIN_ALPHA) | ~valid
    return torch.where(skip, 0.0, alpha)


def _tile_batches(tile_cnt: list[int]):
    """Consecutive tile ranges [t0, t1) with their longest list K."""
    t0, n = 0, len(tile_cnt)
    while t0 < n:
        t1, k = t0 + 1, tile_cnt[t0]
        while t1 < n and (t1 + 1 - t0) * max(k, tile_cnt[t1]) * P <= _BATCH_ELEMS:
            k = max(k, tile_cnt[t1])
            t1 += 1
        yield t0, t1, k
        t0 = t1


def _pixel_grid(tiles_x: int, tile_ids: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile ids (B,) → integer pixel coordinates (B, P), row-major in the tile."""
    lin = torch.arange(P, device=tile_ids.device)
    px = (tile_ids % tiles_x)[:, None] * BLOCK + lin % BLOCK
    py = (tile_ids // tiles_x)[:, None] * BLOCK + lin // BLOCK
    return px.to(dtype), py.to(dtype)


def _tile_lists(bins: TileBins, t0: int, t1: int, K: int):
    """(B, K) gaussian ids of tiles [t0, t1), padded, and their valid mask."""
    tids = torch.arange(t0, t1, device=bins.gid.device)
    start = bins.tile_start[t0:t1].long()
    cnt = bins.tile_cnt[t0:t1].long()
    ks = torch.arange(K, device=tids.device)
    valid = ks[None, :] < cnt[:, None]
    slot = torch.where(valid, start[:, None] + ks[None, :], 0)
    return tids, bins.gid[slot].long(), valid


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` through ``index_select``, whose backward (``index_add_``)
    sums in index order. The backward of advanced indexing adds with atomics
    across CPU threads, so its last bits change from run to run."""
    return torch.index_select(t, 0, idx.reshape(-1)).reshape(*idx.shape, *t.shape[1:])


def rasterize_tiles_plain(
    xys: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C)
    opacs: torch.Tensor,  # (N,)
    bins: TileBins,
    img_height: int,
    img_width: int,
) -> BlendOutputs:
    """Blend every tile over its depth-sorted list from ``bins``.

    Takes original-order per-gaussian arrays, as the kernel does. Tiles go in
    batches padded to the batch's longest list, so there is no per-tile cap.
    Differentiable through autograd.
    """
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    num_tiles = tiles_x * tiles_y
    C = colors.shape[-1]
    opacs = opacs.reshape(-1)
    img = colors.new_zeros((num_tiles, P, C))
    final_T = colors.new_ones((num_tiles, P))
    for t0, t1, K in _tile_batches(bins.tile_cnt.tolist()):
        if K == 0:
            continue  # empty tiles: img 0, T 1
        tids, g, valid = _tile_lists(bins, t0, t1, K)
        px, py = _pixel_grid(tiles_x, tids, xys.dtype)
        aeff = _alphas(_gather(xys, g), _gather(conics, g), _gather(opacs, g), px, py, valid[:, None, :])
        w, fT = blend_weights(aeff)  # (B, P, K), (B, P)
        img[t0:t1] = torch.bmm(w, _gather(colors, g))
        final_T[t0:t1] = fT

    img = img.reshape(tiles_y, tiles_x, BLOCK, BLOCK, C).permute(0, 2, 1, 3, 4)
    img = img.reshape(tiles_y * BLOCK, tiles_x * BLOCK, C)
    final_T = final_T.reshape(tiles_y, tiles_x, BLOCK, BLOCK).permute(0, 2, 1, 3)
    final_T = final_T.reshape(tiles_y * BLOCK, tiles_x * BLOCK)
    return BlendOutputs(img=img[:img_height, :img_width], final_T=final_T[:img_height, :img_width])


def blend_vjp_plain(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacs: torch.Tensor,
    bins: TileBins,
    g_img: torch.Tensor,  # (H, W, C) cotangent of img
    g_T: torch.Tensor,  # (H, W) cotangent of final_T
    img_height: int,
    img_width: int,
) -> tuple[torch.Tensor, ...]:
    """(d xys, d conics, d colors, d opacs): autograd through
    ``rasterize_tiles_plain``, the plain version of the blend backward."""
    ins = [t.detach().requires_grad_() for t in (xys, conics, colors, opacs.reshape(-1))]
    with torch.enable_grad():
        out = rasterize_tiles_plain(*ins, bins, img_height, img_width)
        if not out.img.requires_grad:  # no tile has a gaussian
            return tuple(torch.zeros_like(t) for t in ins)
        grads = torch.autograd.grad((out.img, out.final_T), ins, (g_img, g_T), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(ins, grads))


def footprint_box(xys: torch.Tensor, conics: torch.Tensor, opacs: torch.Tensor) -> torch.Tensor:
    """(N, 4) boxes (x0, x1, y0, y1) of the gaussians' footprints, in float32
    as ``csrc/blend_common.cuh``'s ``footprint_box`` draws them: no pixel
    outside a box has sigma <= log(255 * opacity) + SKIP_MARGIN, so none
    takes the gaussian. Where det = ac - b² < BOX_DET·ac (or a, c ≤ 0) the
    box is everything; where opacity < 1/255 (every pair skipped) it is
    nothing. The kernel may fuse a product into a sum where this rounds it
    apart, so an edge may differ by an ulp or so."""
    x, y = xys.float().unbind(-1)
    a, b, c = conics.float().unbind(-1)
    skip = torch.log(255.0 * opacs.float().reshape(-1)) + SKIP_MARGIN
    det = a * c - b * b
    level = 2.0 * (BOX_LEVEL_SCALE * skip + BOX_LEVEL_PAD)
    ex = torch.sqrt(level * c / det) * BOX_WIDEN + BOX_PAD
    ey = torch.sqrt(level * a / det) * BOX_WIDEN + BOX_PAD
    box = torch.stack([x - ex, x + ex, y - ey, y + ey], -1)
    inf = torch.inf
    everything = box.new_tensor([-inf, inf, -inf, inf])
    nothing = box.new_tensor([inf, -inf, inf, -inf])
    drawn = (a > 0) & (c > 0) & (det >= BOX_DET * a * c)
    box = torch.where(drawn[:, None], box, everything)
    box = torch.where((skip < 0)[:, None], nothing, box)
    return torch.where(torch.isnan(skip)[:, None], everything, box)


def tile_pairs(
    xys: torch.Tensor,
    conics: torch.Tensor,
    opacs: torch.Tensor,
    bins: TileBins,
    img_height: int,
    img_width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(walked, evaluated, composited) (pixel, gaussian) pairs of a serial
    blend, per tile: three (tiles,) int64 tensors.

    Each pixel of a tile walks its tile's list up to and including the
    gaussian that stops it, or to the end: those pairs are walked. Of them,
    the ones whose gaussian's ``footprint_box`` meets the pixel's warp (its
    two rows of the tile) are evaluated: no other can pass the alpha test,
    and B1 and B2 pass over them. The evaluated pairs that pass the alpha
    tests before the stop are composited. Pixels past the image edge count
    too, since the kernels compute them. The evaluated and composited pairs
    are the work a roofline bound of the blend counts, and their spread
    over the tiles."""
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    opacs = opacs.reshape(-1)
    box = footprint_box(xys, conics, opacs)
    walked = torch.zeros(tiles_x * tiles_y, dtype=torch.int64, device=xys.device)
    evaluated, composited = torch.zeros_like(walked), torch.zeros_like(walked)
    for t0, t1, K in _tile_batches(bins.tile_cnt.tolist()):
        if K == 0:
            continue
        tids, g, valid = _tile_lists(bins, t0, t1, K)
        px, py = _pixel_grid(tiles_x, tids, xys.dtype)
        aeff = _alphas(xys[g], conics[g], opacs[g], px, py, valid[:, None, :])
        w, _ = blend_weights(aeff)
        T_after = torch.cumprod(1.0 - aeff, dim=-1)
        stopped = (T_after <= T_EPS) & (aeff > 0.0)
        # first stop index + 1, else the list length
        ks = torch.arange(K, device=g.device)
        first = torch.where(stopped, ks, K).amin(dim=-1)
        n = torch.minimum(first + 1, bins.tile_cnt[t0:t1].long()[:, None])  # (B, P)
        # the warp's pixels: columns [x0, x0 + BLOCK - 1], rows [y0, y0 + WARP_ROWS - 1]
        x0 = px[:, :1, None]  # (B, 1, 1): the tile's first column
        y0 = (py - (torch.arange(P, device=g.device) // BLOCK) % WARP_ROWS)[..., None]  # (B, P, 1)
        bx = box[g][:, None]  # (B, 1, K, 4)
        meets = ~((bx[..., 1] < x0) | (bx[..., 0] > x0 + (BLOCK - 1))
                  | (bx[..., 3] < y0) | (bx[..., 2] > y0 + (WARP_ROWS - 1)))
        walked[t0:t1] = n.sum(-1)
        evaluated[t0:t1] = (meets & (ks < n[..., None])).sum((-2, -1))
        composited[t0:t1] = (w > 0).sum((-2, -1))
    return walked, evaluated, composited


def count_pairs(
    xys: torch.Tensor,
    conics: torch.Tensor,
    opacs: torch.Tensor,
    bins: TileBins,
    img_height: int,
    img_width: int,
) -> tuple[int, int, int]:
    """(walked, evaluated, composited) (pixel, gaussian) pairs of a serial
    blend over every tile (``tile_pairs`` summed)."""
    return tuple(int(t.sum()) for t in tile_pairs(xys, conics, opacs, bins, img_height, img_width))


def rasterize_naive(
    xys: torch.Tensor,
    depths: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacs: torch.Tensor,
    mask: torch.Tensor,
    tile_bbox: torch.Tensor,
    img_height: int,
    img_width: int,
) -> BlendOutputs:
    """O(N·pixels) oracle for small test scenes: every pixel blends every
    gaussian whose tile bbox covers the pixel's tile, in global depth order."""
    order = torch.sort(torch.where(mask, depths, torch.inf), stable=True).indices
    xy, con, col, opa = xys[order], conics[order], colors[order], opacs.reshape(-1)[order]
    bb, msk = tile_bbox[order], mask[order]

    ys = torch.arange(img_height, device=xys.device)
    xs = torch.arange(img_width, device=xys.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    ptx, pty = (px // BLOCK)[..., None], (py // BLOCK)[..., None]
    covered = (ptx >= bb[:, 0]) & (ptx < bb[:, 2]) & (pty >= bb[:, 1]) & (pty < bb[:, 3])
    aeff = _alphas(xy, con, opa, px.to(xys.dtype), py.to(xys.dtype), covered & msk)
    w, final_T = blend_weights(aeff)  # (H, W, N), (H, W)
    return BlendOutputs(img=w @ col, final_T=final_T)
