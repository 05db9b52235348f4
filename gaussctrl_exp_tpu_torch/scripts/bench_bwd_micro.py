"""Slope-timed ablation of the blend backward on the card: kernel B2 on
fixed cotangents.

Port of ``scripts/bench_bwd_micro.py``, on its scene and its fixed
cotangents (``g_img_c``, ``g_T_c``, drawn after the scene from the same
generator). Cumulative rows:

  fwd (core, incl binning)  — projection + binning + kernel B1
  + bwd kernel B2           — + B2 (``blend_cuda.blend_backward``) on the
                              forward's outputs and the fixed cotangents

and beside each, the device time per launch of the row's last kernel
(B1, B2) alone, from torch.profiler.

The JAX script's "+ sort+cumsum reduction" and "+ gathers+unsort" rows have
no counterpart: B2 reduces the slot gradients by gaussian id inside the
kernel, so nothing is left to time apart.

Usage: python -m gaussctrl_exp_tpu_torch.scripts.bench_bwd_micro [N] [S] [--device cuda]
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import blend_cuda
from ..utils.timing import kernel_time_ms, slope_time_ms
from .bench_blend_variants import B1_KERNEL, KERNEL_LAUNCHES, Scene, _args, make_scene, project_and_bin

K_LO, K_HI, REPEATS = 5, 50, 3
B2_KERNEL = "blend_bwd_kernel"


def forward_core(sc: Scene):
    """Projection + binning + the blend forward: (proj, bins, outputs)."""
    proj, bins = project_and_bin(sc)
    out = blend_cuda.rasterize_tiles(proj.xys, proj.conics, sc.colors, sc.opacs, bins, sc.size, sc.size)
    return proj, bins, out


def backward_core(sc: Scene) -> tuple[torch.Tensor, ...]:
    """``forward_core`` + the blend backward on the fixed cotangents:
    (d xys, d conics, d colors, d opacs), per gaussian."""
    proj, bins, out = forward_core(sc)
    return blend_cuda.blend_backward(proj.xys, proj.conics, sc.colors, sc.opacs, bins, out.img, out.final_T,
                                     sc.g_img, sc.g_T, sc.size, sc.size)


def main(argv=None) -> dict[str, dict[str, float]]:
    """Print and return the cumulative slope ms and the row's last kernel's
    device time per launch."""
    args = _args(argv, __doc__)
    sc = make_scene(args.n, args.size, resolve_device(args.device))
    S = sc.size
    print(f"N={args.n} S={S} on {torch.cuda.get_device_name(sc.cam.c2w.device)} — cumulative slope-timed ms "
          f"(K = {K_LO}, {K_HI}) | the row's last kernel alone, device ms per launch", flush=True)
    rows = {}
    with torch.no_grad():
        proj, bins, out = forward_core(sc)
        fields = (proj.xys, proj.conics, sc.colors, sc.opacs)
        rows["fwd (core, incl binning)"] = dict(
            slope_ms=slope_time_ms(lambda: forward_core(sc), K_LO, K_HI, REPEATS),
            kernel_ms=kernel_time_ms(lambda: blend_cuda.rasterize_tiles(*fields, bins, S, S), B1_KERNEL,
                                     KERNEL_LAUNCHES))
        rows["+ bwd kernel B2"] = dict(
            slope_ms=slope_time_ms(lambda: backward_core(sc), K_LO, K_HI, REPEATS),
            kernel_ms=kernel_time_ms(lambda: blend_cuda.blend_backward(*fields, bins, out.img, out.final_T, sc.g_img,
                                                                       sc.g_T, S, S), B2_KERNEL, KERNEL_LAUNCHES))
    for name, r in rows.items():
        print(f"{name + ':':31s}{r['slope_ms']:8.4f} | {r['kernel_ms']:8.4f}", flush=True)
    for name in ("+ sort+cumsum reduction:", "+ gathers+unsort (full bwd):"):
        print(f"{name:31s}fused into B2", flush=True)
    return rows


if __name__ == "__main__":
    main()
