"""Tile binning: global depth sort + gaussian→tile intersection lists.

Port of the part of ``gaussctrl_exp_tpu/ops/binning.py`` the blend reads
(gsplat v0.1.2's ``map_gaussian_to_intersects`` → sort by (tile, depth) →
``get_tile_bin_edges``):

  1. a stable depth sort of the gaussians, culled ones last (``order``);
  2. each visible gaussian expanded to one intersection per tile of its bbox;
  3. a stable sort of the intersections by tile, which keeps depth order
     inside each tile, giving the tile-sorted gaussian ids ``gid``;
  4. per-tile ``tile_start`` / ``tile_cnt`` into ``gid``.

The port runs eagerly, so the list is sized from the exact intersection
count and cannot overflow; ``n_isects`` still reports that count. The TPU
layout (CHUNK-aligned streams, GROUP/SUPER padding, bit-packed bboxes) is
not needed here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import trace
from .projection import ProjectedGaussians


@dataclasses.dataclass
class TileBins:
    order: torch.Tensor  # (N,) int64 gaussian index by ascending depth (culled last)
    gid: torch.Tensor  # (n_isects,) int32 gaussian per intersection, by (tile, depth)
    tile_start: torch.Tensor  # (T,) int32 first entry of each tile in gid
    tile_cnt: torch.Tensor  # (T,) int32 intersections of each tile
    n_isects: int


def bin_gaussians(proj: ProjectedGaussians, tiles_x: int, tiles_y: int) -> TileBins:
    depths = proj.depths
    N = depths.shape[0]
    dev = depths.device
    num_tiles = tiles_x * tiles_y

    depth_key = torch.where(proj.mask, depths, torch.inf)
    order = torch.sort(depth_key, stable=True).indices
    nt = proj.num_tiles_hit[order].long()  # culled gaussians hit 0 tiles
    bbox = proj.tile_bbox[order].long()

    # one entry per (gaussian, tile), in depth-rank order, k-th tile row-major
    with trace.span("render.bin.sync", sync=True):  # the output's length is read back to the host
        rank = torch.repeat_interleave(torch.arange(N, device=dev), nt)
    n_isects = rank.shape[0]
    first = torch.cumsum(nt, 0) - nt
    k = torch.arange(n_isects, device=dev) - first[rank]
    bb = bbox[rank]
    bw = torch.clamp(bb[:, 2] - bb[:, 0], min=1)
    tile = (bb[:, 1] + k // bw) * tiles_x + bb[:, 0] + k % bw

    # stable sort by tile keeps rank (depth) order within each tile
    _, perm = torch.sort(tile, stable=True)
    gid = order[rank[perm]].to(torch.int32)
    tile_cnt = torch.bincount(tile, minlength=num_tiles)
    tile_start = torch.cumsum(tile_cnt, 0) - tile_cnt
    return TileBins(
        order=order,
        gid=gid,
        tile_start=tile_start.to(torch.int32),
        tile_cnt=tile_cnt.to(torch.int32),
        n_isects=n_isects,
    )
