"""Attribute the blend forward's time on the card: kernel B1v's ablations.

Port of ``scripts/bench_blend_variants.py``. The same synthetic scene
(``default_rng(0)``, drawn in the script's order) and camera; per mode of
kernel B1v (``ops/blend_variants.py``) the slope-timed ms of projection +
binning + the variant, and kernel B1's line for comparison. On this card
the slope is host-bound (the port's binning), so each line also gives the
kernel's own device time per launch (torch.profiler), where the split
shows:

  base      — B1's math, chunk by chunk (T carried between chunks of 128)
  empty     — the init of every tile only: launch and output cost
  notrans   — exp/log1p replaced by cheap stand-ins (wrong on purpose):
              the transcendentals' share
  nomatmul  — T frozen at each chunk's start (wrong on purpose): the
              in-chunk transmittance cumulation's share
  scan      — the cumulation as a running product (exact)
  pair      — two chunks of the JAX aligned order per step: per-step cost

Usage: python -m gaussctrl_exp_tpu_torch.scripts.bench_blend_variants [N] [S] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..cameras import Camera, camera_matrices, look_at, make_camera
from ..device import resolve_device
from ..ops import blend_cuda, blend_variants
from ..ops.binning import TileBins, bin_gaussians
from ..ops.projection import BLOCK, ProjectedGaussians, project_gaussians
from ..utils.timing import kernel_time_ms, slope_time_ms

N_DEFAULT, S_DEFAULT = 35_000, 512
K_LO, K_HI, REPEATS = 5, 30, 2
KERNEL_LAUNCHES = 20  # launches per kernel-alone measurement (after one warm-up)
B1_KERNEL = "blend_fwd_kernel"  # the kernels' names in the profiler's records


@dataclasses.dataclass
class Scene:
    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    colors: torch.Tensor  # (N, 4)
    opacs: torch.Tensor
    cam: Camera
    size: int
    g_img: torch.Tensor  # (S, S, 4) fixed cotangent of the image (bench_bwd_micro)
    g_T: torch.Tensor  # (S, S) fixed cotangent of the transmittance


def make_scene(n: int, size: int, device) -> Scene:
    """The JAX scripts' scene: N gaussians around the origin, a camera at
    distance 4 with f = 1.05 S, and the backward script's fixed cotangents,
    all drawn from one ``default_rng(0)`` in the scripts' order."""
    rng = np.random.default_rng(0)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 4.2)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    opacs = rng.uniform(0.3, 0.9, n).astype(np.float32)
    cam = make_camera(look_at(np.array([0.0, -4.0, 0.0]), np.zeros(3)), size * 1.05, size * 1.05,
                      size / 2, size / 2, size, size, device=device)
    g_img = rng.normal(size=(size, size, 4)).astype(np.float32)
    g_T = rng.normal(size=(size, size)).astype(np.float32)
    t = [torch.as_tensor(a, device=cam.c2w.device) for a in (means, scales, quats, colors, opacs, g_img, g_T)]
    return Scene(*t[:5], cam=cam, size=size, g_img=t[5], g_T=t[6])


def project_and_bin(sc: Scene) -> tuple[ProjectedGaussians, TileBins]:
    """Projection (no opacity-tightened bounding boxes, as the scripts call
    it) and binning."""
    vm, _, fm = camera_matrices(sc.cam)
    c, S = sc.cam, sc.size
    proj = project_gaussians(sc.means, sc.scales, 1.0, sc.quats, vm, fm, c.fx, c.fy, c.cx, c.cy, S, S)
    tiles = (S + BLOCK - 1) // BLOCK
    return proj, bin_gaussians(proj, tiles, tiles)


def variant_step(sc: Scene, mode: str) -> torch.Tensor:
    """Projection + binning + the chunk table + mode ``mode`` of B1v."""
    proj, bins = project_and_bin(sc)
    table = blend_variants.bins_chunk_table(bins, sc.size, sc.size)
    return blend_variants.blend_variant(mode, proj.xys, proj.conics, sc.colors, sc.opacs, bins, sc.size, sc.size,
                                        table=table)


def b1_step(sc: Scene):
    """Projection + binning + kernel B1 (the plain blend on CPU tensors)."""
    proj, bins = project_and_bin(sc)
    return blend_cuda.rasterize_tiles(proj.xys, proj.conics, sc.colors, sc.opacs, bins, sc.size, sc.size)


def _args(argv, doc):
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=N_DEFAULT, help="gaussians")
    p.add_argument("size", nargs="?", type=int, default=S_DEFAULT, help="frame side in pixels")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def variant_kernel_name(mode: str) -> str:
    return "empty_kernel" if mode == "empty" else "variant_kernel"


def main(argv=None) -> dict[str, dict[str, float]]:
    """Print and return, for B1 and each mode, the slope ms and the kernel's
    device time per launch."""
    args = _args(argv, __doc__)
    sc = make_scene(args.n, args.size, resolve_device(args.device))
    S = sc.size
    with torch.no_grad():
        proj, bins = project_and_bin(sc)
    table = blend_variants.bins_chunk_table(bins, S, S)
    fields = (proj.xys, proj.conics, sc.colors, sc.opacs)
    print(f"N={args.n} S={S} CAP={blend_variants.CAPACITY} n_isects={bins.n_isects} on "
          f"{torch.cuda.get_device_name(sc.cam.c2w.device)} — blend fwd variants: slope ms (K = {K_LO}, {K_HI}; "
          f"incl. projection and binning) | kernel alone, device ms per launch", flush=True)
    rows = {}
    with torch.no_grad():
        rows["B1 (blend_fwd)"] = dict(
            slope_ms=slope_time_ms(lambda: b1_step(sc), K_LO, K_HI, REPEATS),
            kernel_ms=kernel_time_ms(lambda: blend_cuda.rasterize_tiles(*fields, bins, S, S), B1_KERNEL,
                                     KERNEL_LAUNCHES))
        for mode in blend_variants.MODES:
            rows[mode] = dict(
                slope_ms=slope_time_ms(lambda: variant_step(sc, mode), K_LO, K_HI, REPEATS),
                kernel_ms=kernel_time_ms(lambda: blend_variants.blend_variant(mode, *fields, bins, S, S, table=table),
                                         variant_kernel_name(mode), KERNEL_LAUNCHES))
    for name, r in rows.items():
        print(f"{name:16s} {r['slope_ms']:8.4f} ms | {r['kernel_ms']:8.4f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
