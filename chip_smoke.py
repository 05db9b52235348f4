#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py
    python3 chip_smoke.py --attention   # phase 9, then B3, B4, B5 alone (11, 15)
    python3 chip_smoke.py --blend       # phases 3 and 6, then B1 and B2 alone
    python3 chip_smoke.py --generator   # phase 17 alone, on seeded latents
    python3 chip_smoke.py --variants    # phase 16's checks, then B1 and B1v alone
    python3 chip_smoke.py --edit        # phases 9 to 11 alone: the edit path
    python3 chip_smoke.py --train-cli   # phase 18 alone: the loader and the training CLI
    python3 chip_smoke.py --segment     # phase 19 alone: the CLI's edit with live segmentation

Phases (any failure exits non-zero):
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
  2. build kernels B1, B2, B3, B4/B5 and B1v (csrc/*.cu) with nvcc for sm_90a,
     one process per source, all started together.
  3. B1 against its plain PyTorch version on the same CUDA tensors: the
     bear-scale 512² frame (C = 4 and C = 3), a 300k-gaussian garden-scale
     frame, an all-zero-opacity scene and a 500×372 frame.
  4. the main path: ``gaussctrl_exp_tpu_torch.cli.render camera-path`` on a
     synthetic bear-scale splatfacto checkpoint (34,174 gaussians, SH
     degree 3), 6 frames at 512², with B1's launch count read around it; the
     frames are checked and frame 1 is held against a render on the CPU.
  5. timings with CUDA events: per-frame render split into project+SH,
     binning and B1; B1 against the plain version; B1's roofline bound.
  6. kernel B2 (csrc/blend_bwd.cu) against the plain VJP (autograd through
     the plain blend) on the same CUDA tensors and cotangents: bear 512² at
     C = 4 and 3, 500×372, zero opacity, opacity 0.9999 (alpha on the
     clamp), gaussians 0..9 culled, and the garden frame.
  7. the training path: ``Trainer.train`` on a perturbed bear-scale
     checkpoint imported at capacity 1 << 17, against 6 views rendered from
     the unperturbed scene, through one opacity reset and one densify, then a
     few steps with a random-weight LPIPS term and ``Trainer.evaluate``; B1
     and B2 launches are read around the training run, and step 1's
     gradients are held against the plain path on the CPU at 128².
  8. timings: the train step by stage (CUDA events), its device busy share,
     B2 against its bound and the plain VJP at bear and garden scale.
  9. kernel B3 (csrc/flash_attn_fwd.cu) against ``sdpa_plain`` in fp32 on the
     same CUDA tensors, bf16 and fp32, at the edit path's self- and
     cross-attention shapes, a ragged shape and a reference-view call as the
     cross-view processor builds it.
 10. the edit path: ``GaussCtrlEditPipeline.render_reverse`` and
     ``edit_images`` at the full SD1.x widths in bf16 (random weights from a
     seed) on the bear-scale scene's 6 views at 512², then 20 fine-tune
     steps of ``Trainer.train`` on the written-back images; B3's launches
     are read around the edit; one full-width ``_eps`` in bf16 through B3 is
     held against fp32 through ``sdpa_plain``, and the tiny-width fp32 edit
     loop on the card against the same loop on the CPU.
 11. timings of the edit path by stage (CUDA events), the device busy share
     of a generation step and B3's share of it (torch.profiler), and B3 at
     every phase-9 shape, the inversion's and (fp32) the depth generator's
     against its three bounds and ``scaled_dot_product_attention``, by
     device time with the SM clock read around each.
 12. kernels B4 (dK, dV) and B5 (dQ) (csrc/flash_attn_bwd.cu) against
     autograd through ``sdpa_plain`` in fp32 on the same CUDA tensors, bf16
     and fp32, at the depth generator's training shapes (4 views, 64²
     latents), a ragged shape and strided head-split views; two runs bit for
     bit, B4's query split among them; B3's output with and without its
     log-sum-exp; the gradient through ``diffusion.attention._sdpa`` on the
     card.
 13. the depth generator at full SD1.x width (859,523,844 parameters, fp32,
     random weights) on 4 rendered views: one step's gradient through
     B3/B4/B5 against the same step through ``sdpa_plain``; 3 Adam steps of
     ``train_step`` with B3, B4 and B5 launches read around them; 4-step
     ``sample`` at CFG batch 8; the tiny generator's step card vs CPU.
 14. the experimental paths at full width in bf16 on phase 10's caches:
     ``edit_images`` with the correspondence and the triplane processors
     (5 steps instead of 20), ``SDInpaintPipeline.inpaint_images`` on one
     view, ``render_noise_mask`` on one view's depth (B1 counted).
 15. timings: the generator's train step by stage, its busy share and B4 +
     B5's share of the backward (torch.profiler); B4 and B5, bf16 and fp32,
     at every phase-12 shape against their bounds, the exponentials' floor
     beside them, and the backward of ``scaled_dot_product_attention``, by
     device time with the SM clock read around each, with B4's query splits;
     a sampling step and the correspondence processor's share of it.
 16. kernel B1v (csrc/blend_variants.cu, the six blend-forward ablations)
     against its plain version per mode on the variant script's scene
     (35,000 gaussians, 512²), a sparse one with empty tiles, the 500×372
     frame and (base, nomatmul) the garden frame, and ``base`` against B1;
     B1v per mode against both its bounds and the plain version; then the main
     path of this slice: the ported ``bench_blend_variants`` and
     ``bench_bwd_micro`` scripts at their defaults, with the launches of
     B1v, B1 and B2 read around them.
 17. the depth generator trained in bf16 at full width, as the JAX
     package's ``init_depth_generator(dtype=jnp.bfloat16)`` trains it (float32
     parameters and Adam state, the UNet computing in bf16), on phase 13's
     views and latents: one step's gradient through B3/B4/B5 in bf16 against
     the same step through ``sdpa_plain``; 3 Adam steps with B3, B4 and B5
     launches read around them, the parameters and the Adam state checked
     float32, the peak memory; the step by stage and by device time with B4
     + B5's share of the backward, as phase 15.
 18. the scene loader and the training CLI: a 96-frame bear-scale scene at
     512² written as PNGs (B1 renders of the bear checkpoint in the
     dataparser's frame, ``utils/png.write_png``) with a ``transforms.json``
     and a binary ``sparse_pc.ply``; ``data.DataManager`` keeps 40 views
     (4 × 10) whose images equal the PNG bytes / 255, and an OPENCV copy's
     new K and ROI equal ``data/undistort.optimal_new_K``'s;
     ``cli.train.main`` from the perturbed checkpoint for 60 steps (eval and
     save every 30) with B1 and B2 launches read around it (60 + 18 and
     60), the loss and the eval PSNR falling and rising, the saved
     checkpoint loaded back bit for bit; ``cli.train.main`` from the seed
     ply for 30 steps; ``cli.render dataset`` on the saved checkpoint (96
     frames, 96 depth sidecars, 96 B1 launches); step 1 at 128² on the card
     against the CPU; timings of each with the card's name and power limit.
 19. live segmentation in the training CLI's edit phase: a SAM at ViT-H
     widths and a CLIP at ViT-L/14 widths from seeds, written as
     segment_anything's ``.pth`` and a transformers directory;
     ``cli.train.main`` with ``--pipeline.edit-prompt``,
     ``--pipeline.langsam-obj bear``, ``--pipeline.sam-ckpt``,
     ``--pipeline.clip-ckpt``, 20 inference steps and a 20-step fine-tune on
     a fresh copy of phase 18's scene (40 views), with the full-width bf16
     SD1.x stack handed in for ``diffusion.convert.load_sd_models``; B1, B2
     and B3 launches read around it (B3 by phase 10's formula); every mask
     (512², values 0 and 1) and the composite (each written-back image is
     its render where the mask is 0) checked; the checkpoints' bytes and
     save and load walls, SAM-H encode and decode and CLIP-L by CUDA events,
     LangSAM per view, peak memory; ``LangSAM``'s logits and masks at ViT-B
     width on the card against the CPU.

``--blend`` builds only B1 and B2 (ptxas registers and spills, and, where
cuobjdump runs, the instructions by class of each loop of B1 at C = 4 and
B2 at C = 3), runs phases 3 and 6, then times each alone by device time:
B1 at bear C = 4 and garden, B2 at bear C = 3 and garden, against its
bound, with the tile-work spread (evaluated pairs per tile, largest and
mean: pairs up to each pixel's stop whose gaussian's footprint box meets
the pixel's warp, as the bound counts them, beside all walked pairs) and
the heaviest tile's one-SM floor. To compare two versions of the
kernels on one card, run it from each tree in turns (parent, change,
change, parent) within one call. ``--attention`` does the same for B3, B4
and B5 (phase 9, then the kernel rows of phases 11 and 15), and
``--generator`` for the bf16 generator's step (phase 17, on the bear-scale
scene's views with seeded latents and text states). ``--variants`` builds
only B1 and B1v (registers and spills per mode), runs phase 16's checks,
then times B1 and each mode of B1v alone by device time at the variant
script's scene and (base, nomatmul) the garden frame, against both of B1v's
bounds (the pairs each pixel's warp must evaluate and the live ones among
them, and every walked pair), with each mode's difference from base as a
share of base. ``--edit`` runs phases 9 to 11 alone (the edit path at full
width and its timings), ``--train-cli`` phase 18 and ``--segment`` phase 19.

A busy share is the union of the device ops' intervals over the wall of
the same profiled window, both from torch.profiler, so it cannot pass 1.
Every device time is read from a profiled window whose records must match
a second window of the same calls, op by op, a whole number per call
(``utils/timing.checked_window``, whose cycles open with spare launches
that take the profiler's loss of a cycle's first records): a record the
profiler dropped fails the run.
The last three lines of standard output are the card's name and power limit,
one JSON object describing each kernel, and ``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# B1's fp32 operations: every evaluated (pixel, gaussian) pair (one up to the
# pixel's stop whose gaussian's footprint box meets the pixel's warp,
# ops/blend.tile_pairs; no other pair can pass the alpha test) computes dx, dy,
# sigma (9), the sigma test, -sigma, exp (counted as one), ×opacity, the
# clamp and the alpha test; a composited pair adds 1−α, T×, the stop test,
# the weight and a multiply-add per channel
OPS_EVALUATED = 17
OPS_COMPOSITED_BASE = 4
# B2 re-evaluates every pair as B1 does (OPS_EVALUATED); a composited pair
# then adds 1−α, T×, the stop test and the weight (4), cg = g·colour (2C),
# prefix (2), suffix (1), dα (4), dσ (2), dxy (6), dconic (8), dopacity (1),
# dcolour (C) and the sum of its 6 + C values over the tile's pixels (6 + C)
OPS_BWD_COMPOSITED_BASE = 34
OPS_BWD_PER_CHANNEL = 4

S = 512  # frame size of the main path
N_BEAR = 34_174  # gaussians of the bear scene (its splatfacto checkpoint)
N_GARDEN = 300_000
FRAMES = 6
TRAIN_CAPACITY = 1 << 17  # the trainer's capacity (configs.py:62 of the JAX package)
TRAIN_STEPS = 60
LPIPS_STEPS = 3
# B3 at the edit path's shapes (B, H, S, T, D): SD1.x's self- and
# cross-attention at the 64², 32², 16² and 8² latents over the CFG batch of
# 4 reference + 5 chunk views, doubled; then a ragged shape
CFG_BATCH = 2 * (4 + 5)
FLASH_MAIN = (CFG_BATCH, 8, 4096, 4096, 40)
FLASH_SHAPES = [
    ("self 64²", FLASH_MAIN),
    ("self 32²", (CFG_BATCH, 8, 1024, 1024, 80)),
    ("self 16²", (CFG_BATCH, 8, 256, 256, 160)),
    ("self 8²", (CFG_BATCH, 8, 64, 64, 160)),
    ("cross 64²", (CFG_BATCH, 8, 4096, 77, 40)),
    ("cross 32²", (CFG_BATCH, 8, 1024, 77, 80)),
    ("cross 16²", (CFG_BATCH, 8, 256, 77, 160)),
    ("ragged", (2, 3, 100, 77, 24)),
]
# B3 vs sdpa_plain in fp32 on the upcast inputs. bf16: the kernel rounds its
# output to bf16 (2^-8 relative) and its probabilities before P·V, as the
# reference does, so max |d| ≤ 1e-2·max|plain| and relative L2 ≤ 5e-3; fp32:
# the same sums in another order, relative L2 ≤ 1e-5
FLASH_BF16_MAX_REL, FLASH_BF16_REL_L2, FLASH_F32_REL_L2 = 1e-2, 5e-3, 1e-5
# B3's fp32 log-sum-exp against torch.logsumexp of the fp32 scores: a few
# ulp of values near 8
FLASH_F32_LSE = 1e-5
# one full-width ε (UNet + ControlNet) in bf16 through B3 against fp32 through
# sdpa_plain on the same (bf16-valued) weights: bf16 rounds every
# activation to 2^-8 through ~70 layers
EPS_BF16_REL_L2 = 5e-2
# the tiny fp32 edit loop on the card (B1, B3 in fp32) vs the CPU's plain
# path: renders differ by ~1e-6 and the 2-step loops carry that forward
TINY_LOOP_REL_L2 = 1e-3
SD_SEED = 0
FINETUNE_STEPS = 20
EDIT_PROMPT, REVERSE_PROMPT = "a bronze statue of a bear", "a photo of a bear"
# the tests' tiny SD stack (tests/test_diffusion.py TINY)
TINY = dict(block_out=(32, 64), vae_block_out=(32, 32, 32, 32), heads=2, cross_dim=32, layers_per_block=1)
FOV_DEG = 50.0
T_EPS = 1e-4

# kernel vs plain: off the stop threshold the two differ only in how the
# transmittance product is rounded (serial vs cumprod, up to ~n·ulp over a
# list of n factors), so elementwise |d| ≤ ATOL + RTOL·|plain|
ATOL_IMG, RTOL = 1e-5, 1e-4
ATOL_T = 1e-6
# a pixel whose final transmittance lies within this relative band of 1e-4
# on either side may stop one gaussian earlier or later in one of the two;
# there the difference is at most that one gaussian's weight
STOP_BAND = 1e-3
# B2 vs the plain VJP, per gradient field: the relative L2 error and the
# largest |d| over the largest |plain|. Off the stop band the two take the same
# pairs; they differ in (1) suffix = img·g − prefix here against a reverse
# cumulative sum there, which loses digits when the terms are close and is
# scaled by 1/(1 − α), up to 1000 at the 0.999 clamp, and (2) the order of
# the sums, which the atomics change from run to run
BWD_REL_L2 = 1e-4
BWD_MAX_REL = 1e-3
# step 1 of the train step, card vs the plain path on the CPU, per gradient
# group: relative L2 error. The CPU's and the card's exp and log round
# differently, so a pair at the 1/255 alpha edge or a pixel at the stop can
# flip between them, and the loss sums every pixel's share
STEP_GRAD_REL_L2 = 1e-3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_params(n, seed, mean_sd, log_scale_mu, log_scale_sd, sh_degree=3):
    """Splatfacto parameters with bench.py's distributions, from a seed."""
    from gaussctrl_exp_tpu_torch.models.gaussians import rgb_to_sh_dc

    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * mean_sd).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    log_scales = (rng.normal(size=(n, 3)) * log_scale_sd + log_scale_mu).astype(np.float32)
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    frest = (rng.normal(size=(n, K - 1, 3)) * 0.05).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, (n, 1)).astype(np.float32)
    return dict(
        means=means,
        scales=log_scales,
        quats=quats,
        features_dc=rgb_to_sh_dc(rgb).astype(np.float32),
        features_rest=frest,
        opacities=np.log(opac / (1 - opac)).astype(np.float32),
    )


def orbit_c2w(i, n):
    from gaussctrl_exp_tpu_torch.cameras import look_at

    ang = 2 * np.pi * i / n
    c2w = look_at([4.0 * np.sin(ang), -4.0 * np.cos(ang), 0.5], np.zeros(3))
    return np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]]).astype(np.float32)


def save_splatfacto(path, arrays):
    """``arrays`` as a splatfacto checkpoint at step 29,999."""
    torch.save({"step": 29_999, "pipeline": {f"_model.gauss_params.{k}": torch.as_tensor(v)
                                             for k, v in arrays.items()}}, str(path))


def write_inputs(tmp: Path, arrays) -> tuple[Path, Path]:
    ckpt = tmp / "step-000029999.ckpt"
    save_splatfacto(ckpt, arrays)
    path = tmp / "camera_path.json"
    frames = [{"camera_to_world": orbit_c2w(i, FRAMES).reshape(-1).tolist(), "fov": FOV_DEG}
              for i in range(FRAMES)]
    path.write_text(json.dumps({"camera_type": "perspective", "render_height": S,
                                "render_width": S, "camera_path": frames}))
    return ckpt, path


def blend_inputs(state, cam, n_chan=4):
    """What render_model hands the blend, for one camera."""
    from gaussctrl_exp_tpu_torch.cameras import camera_matrices
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, model_colors
    from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
    from gaussctrl_exp_tpu_torch.ops.projection import BLOCK, project_gaussians

    p = state.params
    with torch.no_grad():
        colors = model_colors(p, cam, 30_000, SplatModelConfig())
        opacs = torch.sigmoid(p.opacities[:, 0])
        vm, _, fm = camera_matrices(cam)
        proj = project_gaussians(p.means, torch.exp(p.scales), 1.0, p.quats, vm, fm,
                                 cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                                 extra_mask=state.alive, opacities=opacs)
        bins = bin_gaussians(proj, (cam.width + BLOCK - 1) // BLOCK, (cam.height + BLOCK - 1) // BLOCK)
        chan = torch.cat([colors, proj.depths[:, None]], -1)[:, :n_chan].contiguous()
    return (proj.xys, proj.conics, chan, opacs), bins


def check_kernel(name, args, bins, H, W) -> float:
    """B1 against the plain version on the same CUDA tensors; returns max |d|."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops.blend import rasterize_tiles_plain

    got = blend_cuda.rasterize_tiles(*args, bins, H, W)
    torch.cuda.synchronize()
    want = rasterize_tiles_plain(*args, bins, H, W)
    torch.cuda.synchronize()
    d_img = (got.img - want.img).abs()
    d_T = (got.final_T - want.final_T).abs()
    band = STOP_BAND * T_EPS
    flip = ((got.final_T - T_EPS).abs() <= band) | ((want.final_T - T_EPS).abs() <= band)
    a_max = min(0.999, float(args[3].max()))
    w_max = T_EPS * (1 + STOP_BAND) * a_max / (1 - a_max)  # one gaussian's weight at the stop
    c_max = float(args[2].abs().max())
    tight_img = d_img <= ATOL_IMG + RTOL * want.img.abs()
    tight_T = d_T <= ATOL_T + RTOL * want.final_T.abs()
    ok_img = torch.where(flip[..., None], d_img <= w_max * c_max, tight_img)
    ok_T = torch.where(flip, d_T <= w_max, tight_T)
    err = max(float(d_img.max()), float(d_T.max())) if d_img.numel() else 0.0
    off = int((~tight_img.all(-1) & ~flip).sum()) + int((~tight_T & ~flip).sum())
    print(f"  {name}: H×W {H}×{W} C {args[2].shape[1]} n_isects {bins.n_isects} "
          f"max|d| {err:.3e} (img {float(d_img.max()) if d_img.numel() else 0:.3e}, "
          f"T {float(d_T.max()) if d_T.numel() else 0:.3e}); stop-band pixels {int(flip.sum())} "
          f"(bound there {w_max * c_max:.3e}); pixels over tolerance off the band {off}")
    if not (bool(ok_img.all()) and bool(ok_T.all())):
        raise SystemExit(f"FAIL: blend kernel disagrees with its plain version on {name}")
    return err


def cotangents(fwd, ref, seed):
    """Random cotangents of (img, final_T), zero at stop-band pixels: those
    whose final T lies within STOP_BAND of 1e-4 in either forward, where the
    two versions may stop one gaussian apart. There a zero cotangent makes the
    pixel's contribution exactly zero in both, so the rest compares tightly."""
    gen = torch.Generator(device=fwd.img.device).manual_seed(seed)
    g_img = torch.randn(fwd.img.shape, generator=gen, device=fwd.img.device)
    g_T = torch.randn(fwd.final_T.shape, generator=gen, device=fwd.img.device)
    band = STOP_BAND * T_EPS
    flip = ((fwd.final_T - T_EPS).abs() <= band) | ((ref.final_T - T_EPS).abs() <= band)
    return g_img * ~flip[..., None], g_T * ~flip, int(flip.sum())


def check_backward(name, args, bins, H, W, seed=0):
    """B2 against the plain VJP on the same CUDA tensors and cotangents;
    returns max |d| over the four gradients, and B2's gradients."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops.blend import blend_vjp_plain, rasterize_tiles_plain

    fwd = blend_cuda.blend_forward(*args, bins, H, W)
    ref = rasterize_tiles_plain(*args, bins, H, W)
    g_img, g_T, n_band = cotangents(fwd, ref, seed)
    got = blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T, H, W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = blend_vjp_plain(*args, bins, g_img, g_T, H, W)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    parts, ok, err = [], True, 0.0
    for field, a, b in zip(("xys", "conics", "colors", "opacs"), got, want):
        d = (a - b).abs()
        err = max(err, float(d.max()))
        nb, mb = float(b.norm()), float(b.abs().max())
        rel = float(d.norm()) / nb if nb > 0 else float(d.norm())
        mrel = float(d.max()) / mb if mb > 0 else float(d.max())
        parts.append(f"{field} relL2 {rel:.2e} max|d| {float(d.max()):.2e} (max|plain| {mb:.3e})")
        if nb == 0:
            ok &= bool((a == 0).all())
        else:
            ok &= rel <= BWD_REL_L2 and mrel <= BWD_MAX_REL
    print(f"  {name}: H×W {H}×{W} C {args[2].shape[1]} n_isects {bins.n_isects}; "
          f"stop-band pixels zeroed {n_band}; plain VJP peak {peak_mb:.0f} MiB")
    print("    " + "; ".join(parts))
    if not ok:
        raise SystemExit(f"FAIL: blend_bwd disagrees with the plain VJP on {name}")
    return err, got


def blend_cases(dev, state, cam0, garden) -> dict:
    """The inputs of phases 3 and 6, (args, bins) each: the bear-scale 512²
    frame at C = 4 and C = 3, with every opacity 0, the 500×372 frame, and
    the 300k-gaussian garden-scale frame."""
    from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy

    bear_args, bear_bins = blend_inputs(state, cam0, 4)
    f0 = float(cam0.fx)
    cam_odd = make_camera(orbit_c2w(0, FRAMES), f0, f0, 250.0, 186.0, 500, 372, device=dev)
    gstate = GaussianState(params_from_numpy(garden, dev), torch.ones(N_GARDEN, dtype=torch.bool, device=dev))
    gcam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), S * 1.05, S * 1.05, S / 2, S / 2, S, S, device=dev)
    return dict(bear=(bear_args, bear_bins), bear3=blend_inputs(state, cam0, 3),
                zero=((*bear_args[:3], torch.zeros_like(bear_args[3])), bear_bins),
                odd=blend_inputs(state, cam_odd, 4), garden=blend_inputs(gstate, gcam, 4))


def phase3_blend(cases) -> float:
    """Phase 3: B1 against its plain version on each case; returns max |d|."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda

    print("[3] blend kernel vs plain version")
    errs = [check_kernel(f"bear {S}² C=4", *cases["bear"], S, S),
            check_kernel(f"bear {S}² C=3", *cases["bear3"], S, S),
            check_kernel(f"bear {S}² zero opacity", *cases["zero"], S, S)]
    out0 = blend_cuda.rasterize_tiles(*cases["zero"][0], cases["zero"][1], S, S)
    if not (bool((out0.img == 0).all()) and bool((out0.final_T == 1).all())):
        raise SystemExit("FAIL: zero-opacity scene is not img 0, T 1")
    errs.append(check_kernel("bear 500×372 C=4", *cases["odd"], 372, 500))
    errs.append(check_kernel(f"garden {N_GARDEN} {S}² C=4", *cases["garden"], S, S))
    return max(errs)


def phase6_blend(dev, cases, state, cam0) -> float:
    """Phase 6: B2 against the plain VJP on phase 3's cases, with opacity
    0.9999 (alpha on the clamp) and with gaussians 0..9 culled; one launch
    a case; returns max |d|."""
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState
    from gaussctrl_exp_tpu_torch.ops import blend_cuda

    print("[6] blend backward kernel vs plain VJP (stop-band pixels get a zero cotangent)")
    blend_cuda.bwd_launches = 0
    bear_args, bear_bins = cases["bear"]
    bwd = [check_backward(f"bear {S}² C=4", bear_args, bear_bins, S, S),
           check_backward(f"bear {S}² C=3", *cases["bear3"], S, S),
           check_backward("bear 500×372 C=4", *cases["odd"], 372, 500),
           check_backward(f"bear {S}² zero opacity", *cases["zero"], S, S)]
    if any(bool(g.any()) for g in bwd[-1][1]):
        raise SystemExit("FAIL: zero opacity gives a non-zero gradient")
    clamped = (*bear_args[:3], torch.full_like(bear_args[3], 0.9999))
    bwd.append(check_backward(f"bear {S}² opacity 0.9999 (alpha on the clamp)", clamped, bear_bins, S, S))
    n_cut = 10
    if not bool((bear_bins.gid < n_cut).any()):
        raise SystemExit(f"FAIL: none of gaussians 0..{n_cut - 1} is visible, so culling them tests nothing")
    keep = state.alive & (torch.arange(N_BEAR, device=dev) >= n_cut)
    c_args, c_bins = blend_inputs(GaussianState(state.params, keep), cam0, 4)
    bwd.append(check_backward(f"bear {S}² gaussians 0..{n_cut - 1} culled", c_args, c_bins, S, S))
    first = int(c_bins.gid.min())
    if any(bool(g[:n_cut].any()) for g in bwd[-1][1]) or not bool(bwd[-1][1][2][first].any()):
        raise SystemExit("FAIL: culled gaussians got a gradient, or the first visible one none")
    bwd.append(check_backward(f"garden {N_GARDEN} {S}² C=4", *cases["garden"], S, S))
    print(f"    blend_bwd launches in phase 6: {blend_cuda.bwd_launches} for {len(bwd)} cases")
    if blend_cuda.bwd_launches != len(bwd):
        raise SystemExit("FAIL: blend_bwd did not launch once per case")
    return max(e for e, _ in bwd)


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(n_bytes, n_ops) -> tuple[float, str]:
    """The least time (ms) for this fp32 work on the card at the data
    sheet's peaks, and what bounds it."""
    from gaussctrl_exp_tpu_torch.utils.timing import PEAK_BYTES_S, PEAK_F32_OPS_S

    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_OPS_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def blend_ops(C, evaluated, composited, backward=False):
    """B1's fp32 operations (B2's with ``backward``) for these counts of
    evaluated and composited pairs (ints or tensors of them)."""
    if backward:
        return OPS_EVALUATED * evaluated + (OPS_BWD_COMPOSITED_BASE + OPS_BWD_PER_CHANNEL * C) * composited
    return OPS_EVALUATED * evaluated + (OPS_COMPOSITED_BASE + 2 * C) * composited


def blend_bound(args, bins, H, W, backward=False) -> tuple[float, str, dict]:
    """B1's bound, or B2's with ``backward``: each input read once, each
    output written once, and the fp32 operations of the pairs these inputs
    evaluate up to each pixel's stop, where the gaussian's footprint box
    meets the pixel's warp (``ops/blend.tile_pairs``). The walked pairs,
    the box ignored, are reported beside them."""
    from gaussctrl_exp_tpu_torch.ops.blend import count_pairs

    xys, conics, chan, opacs = args
    N, C = chan.shape
    tiles = bins.tile_cnt.numel()
    with torch.no_grad():
        walked, evaluated, composited = count_pairs(xys, conics, opacs, bins, H, W)
    n_bytes = 4 * (N * (2 + 3 + C + 1) + bins.n_isects + 2 * tiles + H * W * (C + 1))
    if backward:  # + residuals img, final_T (counted above as the outputs), cotangents, gradients
        n_bytes += 4 * (H * W * (C + 1) + N * (6 + C))
    n_ops = blend_ops(C, evaluated, composited, backward)
    bound, by = roofline(n_bytes, n_ops)
    return bound, by, dict(bytes=n_bytes, ops=n_ops, walked_pairs=walked, evaluated_pairs=evaluated,
                           composited_pairs=composited)


def tile_spread(args, bins, H, W, backward=False) -> dict:
    """How B1's (B2's) work spreads over the tiles, one CTA each: evaluated
    pairs per tile, largest and mean; the list lengths; and the heaviest
    tile's fp32 operations over one SM's share of the fp32 peak, the least
    time its CTA could take on its SM (the one-SM floor)."""
    from gaussctrl_exp_tpu_torch.ops.blend import tile_pairs
    from gaussctrl_exp_tpu_torch.utils.timing import PEAK_F32_OPS_S, SMS

    xys, conics, chan, opacs = args
    with torch.no_grad():
        _, evaluated, composited = tile_pairs(xys, conics, opacs, bins, H, W)
    ops = blend_ops(chan.shape[1], evaluated, composited, backward)
    heavy = int(ops.argmax())
    return dict(tiles=ops.numel(), eval_max=int(evaluated.max()), eval_mean=float(evaluated.double().mean()),
                list_max=int(bins.tile_cnt.max()), list_mean=float(bins.tile_cnt.double().mean()),
                heaviest_tile=heavy, heaviest_list=int(bins.tile_cnt[heavy]), heaviest_eval=int(evaluated[heavy]),
                heaviest_ops=int(ops[heavy]), ops_max_over_mean=float(ops.max() / ops.double().mean()),
                one_sm_floor_ms=float(ops[heavy]) / (PEAK_F32_OPS_S / SMS) * 1e3)


class ViewSet:
    """An in-memory datamanager for ``Trainer``: fixed cameras and images on
    the card, training views drawn from a seeded numpy generator."""

    def __init__(self, cameras, images, seed=0):
        self.cameras, self.images = cameras, images
        self.width, self.height = cameras[0].width, cameras[0].height
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.cameras)

    def next_train(self):
        i = int(self._rng.integers(len(self.cameras)))
        return i, self.images[i]

    def camera(self, i):
        return self.cameras[i]

    def image(self, i):
        return self.images[i]

    def eval_indices(self, max_views: int = 8):
        return list(range(min(len(self.cameras), max_views)))


def perturbed(arrays, seed):
    """The bear checkpoint with its means and colours moved and every
    opacity at 0.15, below the reset value 2·cull_alpha_thresh = 0.2, so the
    loss has far to fall and the opacity reset cannot lift it above the
    start."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    out["means"] = (arrays["means"] + rng.normal(0, 0.01, arrays["means"].shape)).astype(np.float32)
    out["features_dc"] = (arrays["features_dc"] + rng.normal(0, 0.3, arrays["features_dc"].shape)).astype(np.float32)
    out["opacities"] = np.full_like(arrays["opacities"], np.log(0.15 / 0.85))
    return out


def step_gradients(state_src, cam, gt, cfg):
    """One train step from a fresh state copied from ``state_src``;
    returns its metrics and per-group gradients on the CPU."""
    from gaussctrl_exp_tpu_torch.engine.trainer import init_train_state, make_train_step
    from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES

    st = init_train_state(state_src, cfg)
    m = make_train_step(cfg)(st, cam, gt)
    return ({k: float(v) for k, v in m.items()},
            {n: getattr(st.params, n).grad.detach().cpu() for n in PARAM_NAMES})


def crc_tokenize(texts, max_len: int = 77) -> np.ndarray:
    """``simple_tokenize`` with ``zlib.crc32`` for Python's salted ``hash``,
    so that two runs give the same ids."""
    ids = np.zeros((len(texts), max_len), np.int32)
    for i, t in enumerate(texts):
        toks = [49406] + [zlib.crc32(w.encode()) % 49000 for w in t.lower().split()][: max_len - 2] + [49407]
        ids[i, : len(toks)] = toks
    return ids


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm())


def check_flash(name, q, k, v) -> float:
    """B3 against sdpa_plain in fp32 on the upcast inputs (in batch chunks of
    at most ~2 GB of scores); returns max |d|."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    got = attention_cuda.flash_attn(q, k, v)
    torch.cuda.synchronize()
    B, H, S, D = q.shape
    T = k.shape[2]
    chunk = max(1, int(2e9 // (H * S * T * 4)))
    want = torch.cat([attention_cuda.sdpa_plain(q[i:i + chunk].float(), k[i:i + chunk].float(),
                                                v[i:i + chunk].float()) for i in range(0, B, chunk)])
    d = (got.float() - want).abs()
    err, top = float(d.max()), float(want.abs().max())
    rel = float(d.norm() / want.norm())
    print(f"  {name} {str(q.dtype).split('.')[-1]} (B, H, S, T, D) = {(B, H, S, T, D)}: max|d| {err:.3e} "
          f"(max|plain| {top:.3e}) relative L2 {rel:.3e}")
    if q.dtype == torch.bfloat16:
        ok = err <= FLASH_BF16_MAX_REL * top and rel <= FLASH_BF16_REL_L2
    else:
        ok = rel <= FLASH_F32_REL_L2
    if not ok or got.shape != q.shape or got.dtype != q.dtype:
        raise SystemExit(f"FAIL: flash_attn_fwd disagrees with sdpa_plain on {name} {q.dtype}")
    return err


def flash_inputs(shape, dtype, seed, dev):
    B, H, S, T, D = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((B, H, L, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
                 for L in (S, T, T))


class EditViews(ViewSet):
    """``ViewSet`` that the edit loop writes back into: the fine-tune then
    trains on the edited images."""

    def __init__(self, cameras, images, seed=0):
        super().__init__(cameras, images, seed)
        self.writes: list[int] = []

    def write_back(self, i, img):
        self.writes.append(i)
        self.images[i] = torch.as_tensor(np.asarray(img, np.float32), device=self.images[i].device)


class ArcViews:
    """The tests' tiny edit scene: 6 cameras on an arc at 64², f = 70."""

    def __init__(self, device, n=6, size=64):
        self.device, self.n, self.size = device, n, size
        self.images = np.zeros((n, size, size, 3), np.float32)

    def __len__(self):
        return self.n

    def camera(self, i):
        from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera

        ang = 0.3 * i
        eye = np.array([4 * np.sin(ang), -4 * np.cos(ang), 1.0])
        s = self.size
        return make_camera(look_at(eye, np.zeros(3)), 70.0, 70.0, s / 2, s / 2, s, s, device=self.device)

    def write_back(self, i, img):
        self.images[i] = img


def tiny_edit_loop(models, device):
    """The tests' tiny fp32 edit loop (2 steps, chunks of 2, view 3 masked);
    returns z0 and the written-back images."""
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
    from gaussctrl_exp_tpu_torch.models.gaussians import init_random
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig

    cfg = EditConfig(edit_prompt=EDIT_PROMPT, reverse_prompt=REVERSE_PROMPT, num_inference_steps=2,
                     chunk_size=2)
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=crc_tokenize)
    dm = ArcViews(device)
    pipe.render_reverse(init_random(64, capacity=64, sh_degree=1, seed=0, device=device), dm,
                        SplatModelConfig(sh_degree=1, background_color="white"))
    pipe.masks[3] = (np.random.default_rng(5).uniform(size=(64, 64)) > 0.5).astype(np.float32)
    pipe.edit_images(dm)
    return np.stack([pipe.z0[i] for i in range(dm.n)]), dm.images


def count_transformers(module) -> int:
    from gaussctrl_exp_tpu_torch.diffusion.attention import Transformer2D

    return sum(isinstance(m, Transformer2D) for m in module.modules())


def busy_text(w: dict) -> str:
    return (f"busy share {w['busy']:.3f} (device-op union {w['busy_ms']:.4f} ms over the {w['wall_ms']:.4f} ms "
            f"window timed inside torch.profiler; device time outside the window {w['outside_ms']:.4f} ms)")


def phase9_flash(dev) -> tuple[dict, list]:
    """B3 against sdpa_plain at every edit-path shape, bf16 and fp32, and in
    fp32 at the depth generator's shapes (training and sampling), with the
    log-sum-exp and a repeat at its main shape; returns the largest max |d|
    by dtype and the bf16 inputs of each edit-path shape for phase 11."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    print("[9] flash attention kernel vs sdpa_plain (fp32 on the upcast inputs)")
    errs, cases = {torch.bfloat16: [], torch.float32: []}, []
    for i, (name, shape) in enumerate(FLASH_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(shape, dtype, 100 + i, dev)
            errs[dtype].append(check_flash(name, q, k, v))
            if dtype == torch.bfloat16:
                cases.append((name, shape, (q, k, v)))
    B, H, L, _, D = FLASH_MAIN
    for dtype in (torch.bfloat16, torch.float32):  # as the cross-view processor builds a reference call
        q, k, v = flash_inputs(FLASH_MAIN, dtype, 99, dev)
        kg, vg = k.reshape(2, B // 2, H, L, D), v.reshape(2, B // 2, H, L, D)
        k_r = kg[:, 1:2].expand(kg.shape).reshape(B, H, L, D)
        v_r = vg[:, 1:2].expand(vg.shape).reshape(B, H, L, D)
        errs[dtype].append(check_flash("reference view 1 of each CFG group", q, k_r, v_r))
    for i, (name, shape) in enumerate([*MV_SHAPES, ("sampling self 64² (CFG 8)", MV_SAMPLE_MAIN)]):
        errs[torch.float32].append(check_flash(f"generator {name}", *flash_inputs(shape, torch.float32, 500 + i, dev)))
    q, k, v = flash_inputs(MV_MAIN, torch.float32, 510, dev)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    again, lse_again = attention_cuda.flash_attn(q, k, v, return_lse=True)
    want = torch.logsumexp(torch.matmul(q[:1], k[:1].transpose(-1, -2)) * MV_MAIN[-1] ** -0.5, -1)
    lse_err = float((lse[:1] - want).abs().max())
    same = torch.equal(out, again) and torch.equal(lse, lse_again)
    print(f"  generator {MV_MAIN} float32: two runs bit-identical {same}; lse max|d| vs logsumexp of the fp32 "
          f"scores (batch 0) {lse_err:.3e} (limit {FLASH_F32_LSE})")
    if not same or lse_err > FLASH_F32_LSE:
        raise SystemExit("FAIL: B3 in fp32 is not deterministic, or its log-sum-exp is off")
    return {dtype: max(e) for dtype, e in errs.items()}, cases


def phase10_edit(dev, state, cams, targets) -> dict:
    """The edit path at full SD1.x width in bf16 with random weights, the
    fine-tune, the full-width ε check and the tiny loop card vs CPU."""
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline, select_reference_views
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, SDModels, init_random_models
    from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig, Trainer
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
    from gaussctrl_exp_tpu_torch.ops import attention_cuda, blend_cuda

    t0 = time.perf_counter()
    models = init_random_models(SD_SEED, dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in getattr(models, n).parameters())
                for n in ("unet", "controlnet", "vae", "text_encoder")}
    print(f"[10] SD1.x stack, random weights (seed {SD_SEED}), bf16 (text encoder fp32), made on the card in "
          f"{time.perf_counter() - t0:.2f} s; parameters {n_params}")
    cfg = EditConfig(edit_prompt=EDIT_PROMPT, reverse_prompt=REVERSE_PROMPT)
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=crc_tokenize)
    views = EditViews(cams, [t.clone() for t in targets])
    model_cfg = SplatModelConfig(background_color="white")
    V, steps = len(views), cfg.num_inference_steps
    n_chunks = -(-V // cfg.chunk_size)
    per_eval = count_transformers(models.unet) + count_transformers(models.controlnet)
    expected = V * steps * 2 * per_eval + n_chunks * steps * (2 + cfg.ref_view_num) * per_eval
    attention_cuda.launches = 0
    blend_cuda.launches = blend_cuda.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.render_reverse(state, views, model_cfg)
    torch.cuda.synchronize()
    reverse_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.edit_images(views)
    torch.cuda.synchronize()
    edit_wall = time.perf_counter() - t0
    b3, b1 = attention_cuda.launches, blend_cuda.launches
    print(f"    render_reverse {V} views at {S}² ({steps}-step inversion each) {reverse_wall:.3f} s; edit_images "
          f"{n_chunks} chunks of ≤ {cfg.chunk_size} views + {cfg.ref_view_num} references {edit_wall:.3f} s "
          f"(host wall, first calls included); reference views {select_reference_views(V, cfg.ref_view_num)}")
    print(f"    flash_attn_fwd launches {b3} (expected {expected}: {per_eval} Transformer2D blocks per UNet + "
          f"ControlNet evaluation; inversion {V}×{steps}×{2 * per_eval}, generation "
          f"{n_chunks}×{steps}×{(2 + cfg.ref_view_num) * per_eval}); blend_fwd launches {b1}; "
          f"inputs the B3 wrapper copied {attention_cuda.copies}")
    if b3 != expected or b1 != V:
        raise SystemExit(f"FAIL: the edit path launched B3 {b3} times (expected {expected}) and B1 {b1} times "
                         f"(expected {V})")
    z0s = [pipe.z0[i] for i in range(V)]
    if not all(z.shape == (S // 8, S // 8, 4) and np.isfinite(z).all() for z in z0s):
        raise SystemExit("FAIL: a z0 is not finite or not (64, 64, 4)")
    imgs = torch.stack(views.images)
    print(f"    z0 std per view {[round(float(z.std()), 4) for z in z0s]}; written back {sorted(views.writes)}; "
          f"edited images in [{float(imgs.min()):.4f}, {float(imgs.max()):.4f}], mean |edited − render| "
          f"{float((imgs - torch.stack(targets)).abs().mean()):.4f}")
    if sorted(views.writes) != list(range(V)) or not bool(torch.isfinite(imgs).all()) \
            or float(imgs.min()) < 0 or float(imgs.max()) > 1:
        raise SystemExit("FAIL: the edit did not write every view once with values in [0, 1]")

    ft_cfg = TrainConfig(model=SplatModelConfig(background_color="white"), use_lpips=False)
    ft = Trainer(GaussianState(state.params, state.alive), views, ft_cfg)
    blend_cuda.launches = blend_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    ft.train(FINETUNE_STEPS, log_every=5)
    torch.cuda.synchronize()
    ft_wall = time.perf_counter() - t0
    ft_launches = (blend_cuda.launches, blend_cuda.bwd_launches)
    losses = [h["main_loss"] for h in ft.history]
    print(f"    fine-tune: {FINETUNE_STEPS} steps of Trainer.train on the edited images in {ft_wall:.3f} s host "
          f"wall; main_loss at steps {[h['step'] for h in ft.history]}: {[round(x, 5) for x in losses]}; "
          f"blend_fwd/blend_bwd launches {ft_launches}")
    if not all(np.isfinite(losses)) or ft_launches != (FINETUNE_STEPS, FINETUNE_STEPS):
        raise SystemExit("FAIL: the fine-tune loss is not finite or the blend kernels were skipped")

    # one full-width ε: bf16 through B3 against fp32 through sdpa_plain on the same weights
    rev_ctx = pipe._encode([f"{REVERSE_PROMPT}, best quality, extremely detailed"])
    lat2 = torch.as_tensor(np.stack(z0s[:2]), device=dev)
    hint2 = torch.as_tensor(np.stack([pipe.disparity[0], pipe.disparity[1]]), device=dev)
    t2 = torch.full((2,), 501, dtype=torch.long, device=dev)
    eps_bf16 = pipe.pipe._eps(lat2, t2, rev_ctx.expand(2, -1, -1), hint2, 1.0)
    m32 = SDModels(copy.deepcopy(models.unet).float(), copy.deepcopy(models.controlnet).float(),
                   models.vae, models.text_encoder)

    def plain(q, k, v, is_cross):
        return attention_cuda.sdpa_plain(q, k, v)

    eps_f32 = SDControlNetPipeline(m32)._eps(lat2, t2, rev_ctx.expand(2, -1, -1), hint2, 1.0, plain)
    eps_rel = rel_l2(eps_bf16.float(), eps_f32)
    print(f"    _eps at {S // 8}² (B = 2, t = 501): bf16 through B3 vs fp32 through sdpa_plain, relative L2 "
          f"{eps_rel:.3e} (limit {EPS_BF16_REL_L2}); std of ε {float(eps_f32.std()):.4f}")
    del m32, eps_f32
    if not (eps_rel <= EPS_BF16_REL_L2 and bool(torch.isfinite(eps_bf16).all())):
        raise SystemExit("FAIL: the bf16 ε through B3 disagrees with fp32 through sdpa_plain")

    # the tiny fp32 edit loop on the card vs the plain path on the CPU
    tiny_cpu = init_random_models(SD_SEED, "cpu", torch.float32, **TINY)
    tiny_card = SDModels(*(copy.deepcopy(m).to(dev) for m in (tiny_cpu.unet, tiny_cpu.controlnet,
                                                              tiny_cpu.vae, tiny_cpu.text_encoder)))
    z_card, img_card = tiny_edit_loop(tiny_card, dev)
    z_cpu, img_cpu = tiny_edit_loop(tiny_cpu, torch.device("cpu"))
    tiny_rel = (rel_l2(torch.as_tensor(z_card), torch.as_tensor(z_cpu)),
                rel_l2(torch.as_tensor(img_card), torch.as_tensor(img_cpu)))
    print(f"    tiny fp32 edit loop (6 views at 64², 2 steps), card vs CPU: z0 relative L2 {tiny_rel[0]:.3e}, "
          f"edited images {tiny_rel[1]:.3e} (limit {TINY_LOOP_REL_L2})")
    if max(tiny_rel) > TINY_LOOP_REL_L2:
        raise SystemExit("FAIL: the tiny edit loop on the card disagrees with the CPU")
    return dict(pipe=pipe, views=views, cfg=cfg, model_cfg=model_cfg, ft=ft, ft_cfg=ft_cfg, rev_ctx=rev_ctx,
                lat2=lat2, hint2=hint2, b3_launches=b3, edit_wall=edit_wall, reverse_wall=reverse_wall)


def phase11_timings(dev, state, cams, edit, flash_cases) -> dict:
    """The edit path by stage, a generation step's device share, and B3 at
    every phase-9 shape; returns B3's numbers at the main shape."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import make_cross_view_processor
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import EVAL_STEP
    from gaussctrl_exp_tpu_torch.engine.trainer import make_train_step
    from gaussctrl_exp_tpu_torch.models.splat_model import render_model
    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import device_window

    pipe, views, cfg = edit["pipe"], edit["views"], edit["cfg"]
    sd, V, steps = pipe.pipe, len(views), cfg.num_inference_steps
    proc = make_cross_view_processor(cfg.self_attn_coeff_unet, cfg.ref_view_num)
    z1, h1, rev_ctx = edit["lat2"][:1], edit["hint2"][:1], edit["rev_ctx"]
    t1 = torch.full((1,), 501, dtype=torch.long, device=dev)
    nb = cfg.ref_view_num + cfg.chunk_size
    z9 = torch.as_tensor(np.stack([pipe.z0[i % V] for i in range(nb)]), device=dev)
    h9 = torch.as_tensor(np.stack([pipe.disparity[i % V] for i in range(nb)]), device=dev)
    pos = pipe._encode([f"{EDIT_PROMPT}, best quality"]).expand(nb, -1, -1)
    ctx18, h18 = torch.cat([pos, pos], 0), torch.cat([h9, h9], 0)
    t18 = torch.full((2 * nb,), 501, dtype=torch.long, device=dev)
    sd.scheduler.set_timesteps(steps)
    sd.inverse_scheduler.set_timesteps(steps)

    def gen_step():
        eps_u, eps_c = sd._eps(torch.cat([z9, z9], 0), t18, ctx18, h18, 1.0, proc).chunk(2, 0)
        return sd.scheduler.step(eps_u + cfg.guidance_scale * (eps_c - eps_u), 501, z9)

    def render():
        with torch.no_grad():
            return render_model(state, cams[0], EVAL_STEP, edit["model_cfg"])

    img1 = views.images[0][None]
    gen_name = f"generation step (B = {nb}, CFG batch {2 * nb})"
    stage = {
        "prompt encode": time_ms(lambda: pipe._encode([EDIT_PROMPT]), iters=10),
        "render": time_ms(render, iters=10),
        "VAE encode (1 view)": time_ms(lambda: sd.image_to_latent(img1), iters=5),
        "inversion step (B = 1)": time_ms(lambda: sd.inverse_scheduler.step(sd._eps(z1, t1, rev_ctx, h1, 1.0), 501, z1),
                                          iters=5, warmup=2),
        gen_name: time_ms(gen_step, iters=3, warmup=1),
        f"VAE decode ({nb} views)": time_ms(lambda: sd.latent_to_image(z9), iters=3, warmup=1),
    }
    ft_step = make_train_step(edit["ft_cfg"])
    stage["fine-tune step"] = time_ms(lambda: ft_step(edit["ft"].state, cams[0], views.images[0]), iters=10)
    gen_win = device_window(gen_step, attention_cuda.B3_KERNEL, calls=2)
    gen_dev_ms, gen_b3_ms = gen_win["device_ms"], gen_win["part_ms"]
    print(f"[11] edit path by stage (CUDA events, warm), bf16 at full SD1.x width, {S}² views:")
    for name, ms in stage.items():
        print(f"    {name}: {ms:.4f} ms")
    print(f"    edit_images wall (phase 10, {V} views, {steps} steps, host clock): {edit['edit_wall'] * 1e3:.1f} ms; "
          f"render_reverse wall {edit['reverse_wall'] * 1e3:.1f} ms")
    print(f"    generation step device time {gen_dev_ms:.4f} ms in {gen_win['ops']:.0f} device ops (torch.profiler, "
          f"2 steps): {busy_text(gen_win)}; B3 {gen_b3_ms:.4f} ms = {gen_b3_ms / gen_dev_ms:.3f} of the device time")
    rows = b3_rows(dev, flash_cases)
    q, k, v = flash_cases[0][2]
    main = rows[flash_cases[0][0]]
    plain_ms = time_ms(lambda: attention_cuda.sdpa_plain(q, k, v), iters=2, warmup=1)
    print(f"    B3 main shape {FLASH_MAIN}: {main['ms']:.4f} ms device time; sdpa_plain (bf16 in, fp32 softmax) "
          f"{plain_ms:.4f} ms (CUDA events); scaled_dot_product_attention {main['sdpa_ms']:.4f} ms device time; "
          f"B3 / SDPA {main['ratio']:.3f}; at the data sheet's peaks bound {main['rated']['bound_ms']:.5f} ms "
          f"({main['rated']['bound_by']}), exponentials {main['rated']['exp_ms']:.5f} ms")
    gen = rows[f"generator {MV_SHAPES[0][0]}"]
    q, k, v = flash_inputs(MV_MAIN, torch.float32, 98, dev)
    gen_plain_ms = time_ms(lambda: attention_cuda.sdpa_plain(q, k, v), iters=2, warmup=1)
    print(f"    B3 generator shape {MV_MAIN} fp32: {gen['ms']:.4f} ms device time; sdpa_plain {gen_plain_ms:.4f} ms "
          f"(CUDA events); scaled_dot_product_attention {gen['sdpa_ms']:.4f} ms device time; B3 / SDPA "
          f"{gen['ratio']:.3f}; at the data sheet's peaks bound {gen['rated']['bound_ms']:.5f} ms as 3×TF32 "
          f"({gen['rated']['bound_by']}, {gen['rated']['bound_ms'] / gen['ms']:.3f} of B3), "
          f"{gen['rated']['ops_ms']:.5f} ms at the fp32 FMA peak")
    return dict(ms=main["ms"], plain_ms=plain_ms, bound_ms=main["rated"]["bound_ms"],
                bound_by=main["rated"]["bound_by"], library_ms=main["sdpa_ms"],
                f32=dict(ms=gen["ms"], plain_ms=gen_plain_ms, bound_ms=gen["rated"]["bound_ms"],
                         bound_by=gen["rated"]["bound_by"], library_ms=gen["sdpa_ms"]))


ATTN_LAUNCHES = 10  # calls in each device-time window of phases 11 and 15


def clock_text(c: dict) -> str:
    return f"SM {c['sm_mhz']:.0f}/{c['max_sm_mhz']:.0f} MHz {c['power_w']:.1f} W {c['temp_c']:.0f} °C"


def ops_text(ops: dict) -> str:
    """SDPA's device ops by name (cut to 90 characters) with their ms: the
    names say which backend it took."""
    return "; ".join(f"{name[:90]} {ms:.4f}" for name, ms in sorted(ops.items(), key=lambda x: -x[1]))


def time_forward(q, k, v, launches=ATTN_LAUNCHES) -> dict:
    """B3 and ``scaled_dot_product_attention`` (every device op of its call)
    on the same inputs, by device time, with the SM clock read before,
    between and after; B3's bounds at the clock read after it and at the
    data sheet's peaks."""
    from torch.nn.functional import scaled_dot_product_attention

    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import attention_bound, device_ops_ms, gpu_clocks, kernel_time_ms

    shape = (*q.shape[:3], k.shape[2], q.shape[3])
    c0 = gpu_clocks()
    ms = kernel_time_ms(lambda: attention_cuda.flash_attn(q, k, v), attention_cuda.B3_KERNEL, launches)
    c1 = gpu_clocks()
    sdpa = device_ops_ms(lambda: scaled_dot_product_attention(q, k, v), launches)
    c2 = gpu_clocks()
    sdpa_ms = sum(sdpa.values())
    return dict(shape=shape, dtype=q.dtype, ms=ms, launches=launches, sdpa_ms=sdpa_ms, ratio=ms / sdpa_ms,
                sdpa_ops=ops_text(sdpa), clocks=(c0, c1, c2),
                at_clock=attention_bound(shape, q.dtype, c1["sm_mhz"] * 1e6), rated=attention_bound(shape, q.dtype))


def forward_text(name: str, r: dict) -> str:
    a, b = r["at_clock"], r["rated"]
    ops = f"operations {a['ops_ms']:.5f} ms"
    if r["dtype"] == torch.float32:
        ops += f" at the fp32 FMA peak, {a['tf32x3_ms']:.5f} ms as 3×TF32"
    return (f"B3 {name} {r['shape']} {str(r['dtype']).split('.')[-1]}: {r['ms']:.4f} ms device time ({r['launches']} "
            f"launches, every record kept); SDPA {r['sdpa_ms']:.4f} ms (every device op: {r['sdpa_ops']}); B3 / SDPA "
            f"{r['ratio']:.3f}; bounds at {a['clock_hz'] / 1e6:.0f} MHz: {ops}, bytes "
            f"{a['bytes_ms']:.5f} ms, exponentials on the SFU {a['exp_ms']:.5f} ms; at the data sheet's peaks: "
            f"bound_ms {b['bound_ms']:.5f} ({b['bound_by']}, {b['bound_ms'] / r['ms']:.3f} of B3), exponentials "
            f"{b['exp_ms']:.5f} ms at {b['clock_hz'] / 1e6:.0f} MHz; SM clock read before / after B3 / after SDPA (around the "
            "windows, not during them): " + " | ".join(clock_text(c) for c in r["clocks"]))


def time_backward(q, k, v, dout, launches=ATTN_LAUNCHES) -> dict:
    """B4 and B5 on B3's output and log-sum-exp, and the backward of
    ``scaled_dot_product_attention`` (its forward + backward less its
    forward, every device op), by device time, with the SM clock read
    around each."""
    from torch.nn.functional import scaled_dot_product_attention

    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import device_ops_ms, gpu_clocks, kernel_time_ms

    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    delta = attention_cuda.delta_of(out, dout)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    c0 = gpu_clocks()
    b4 = kernel_time_ms(lambda: attention_cuda.flash_attn_bwd_dkv(q, k, v, out, lse, dout, delta),
                        attention_cuda.B4_KERNEL, launches)
    c1 = gpu_clocks()
    b5 = kernel_time_ms(lambda: attention_cuda.flash_attn_bwd_dq(q, k, v, out, lse, dout, delta),
                        attention_cuda.B5_KERNEL, launches)
    c2 = gpu_clocks()
    both = device_ops_ms(lambda: torch.autograd.grad(scaled_dot_product_attention(*leaves), leaves, dout), launches)
    fwd = device_ops_ms(lambda: scaled_dot_product_attention(*leaves), launches)
    c3 = gpu_clocks()
    sdpa_bwd = sum(both.values()) - sum(fwd.values())
    bwd_ops = {n: ms - fwd.get(n, 0.0) for n, ms in both.items() if ms - fwd.get(n, 0.0) > 1e-6}
    return dict(b4=b4, b5=b5, launches=launches, sdpa_bwd_ms=sdpa_bwd, ratio=(b4 + b5) / sdpa_bwd,
                sdpa_ops=ops_text(bwd_ops), clocks=(c0, c1, c2, c3))


def backward_text(name: str, shape, dtype, r: dict) -> str:
    return (f"B4/B5 {name} {shape} {str(dtype).split('.')[-1]}: B4 {r['b4']:.4f} ms, B5 {r['b5']:.4f} ms device "
            f"time ({r['launches']} launches each, every record kept); SDPA backward {r['sdpa_bwd_ms']:.4f} ms "
            f"(forward + backward − forward, every device op: {r['sdpa_ops']}); (B4 + B5) / SDPA {r['ratio']:.3f}; "
            "SM clock read before / after B4 / after B5 / after SDPA: " + " | ".join(clock_text(c) for c in r["clocks"]))


def b3_rows(dev, flash_cases) -> dict:
    """B3 alone against SDPA at phase 9's bf16 cases and ``B3_TIMED_SHAPES``,
    printed; the rows by name."""
    rows = {}
    for name, shape, (q, k, v) in flash_cases:
        rows[name] = time_forward(q, k, v)
        print("    " + forward_text(name, rows[name]), flush=True)
    for i, (name, shape, dtype) in enumerate(B3_TIMED_SHAPES):
        rows[name] = time_forward(*flash_inputs(shape, dtype, 98 - i, dev))
        print("    " + forward_text(name, rows[name]), flush=True)
    return rows


def bound_text(kernel: str, ms: float, rated: dict, at_clock: dict) -> str:
    """A backward kernel's bounds (``timing.attention_bwd_bound``) at the
    data sheet's peaks and at the clock read after it, beside its time."""
    return (f"{kernel} bound {rated['bound_ms']:.5f} ms ({rated['bound_by']}, {rated['bound_ms'] / ms:.3f} of it), "
            f"beside it the exponentials' floor {rated['exp_ms']:.5f} ms at 1830 MHz ({rated['exp_ms'] / ms:.3f} of "
            f"it): operations at the fp32 FMA peak {rated['fp32_ms']:.5f}, as 3×TF32 {rated['tf32x3_ms']:.5f}, bf16 "
            f"{rated['bf16_ms']:.5f}, bytes {rated['bytes_ms']:.5f}; at {at_clock['clock_hz'] / 1e6:.0f} MHz fp32 FMA "
            f"{at_clock['fp32_ms']:.5f}, 3×TF32 {at_clock['tf32x3_ms']:.5f}, bf16 {at_clock['bf16_ms']:.5f}, "
            f"exponentials {at_clock['exp_ms']:.5f}")


def bwd_rows(dev) -> dict:
    """B4 and B5 alone against SDPA's backward at phase 12's shapes, fp32
    and bf16, with their bounds and the exponentials' floor beside them
    (``attention_bwd_bound``: the rated one, and at the clock read after
    each kernel) and B4's query splits (where the rule splits, B4 unsplit
    too), printed; the rows by (name, dtype)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import attention_bwd_bound, kernel_time_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for i, (name, shape) in enumerate(MV_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(shape, dtype, 400 + i, dev)
            dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(i), device=dev).to(dtype)
            r = time_backward(q, k, v, dout)
            for kern, c in (("B4", r["clocks"][1]), ("B5", r["clocks"][2])):
                r[kern.lower() + "_rated"] = attention_bwd_bound(shape, dtype, kern)
                r[kern.lower() + "_at_clock"] = attention_bwd_bound(shape, dtype, kern, c["sm_mhz"] * 1e6)
            splits = attention_cuda.dkv_splits(*shape, sms, bf16=dtype == torch.bfloat16)
            unsplit = ""
            if splits > 1:
                out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
                delta = attention_cuda.delta_of(out, dout)
                r["b4_unsplit"] = kernel_time_ms(
                    lambda: attention_cuda.flash_attn_bwd_dkv(q, k, v, out, lse, dout, delta, _splits=1),
                    attention_cuda.B4_KERNEL, ATTN_LAUNCHES)
                unsplit = f" (unsplit {r['b4_unsplit']:.4f} ms)"
            rows[(name, dtype)] = r
            print(f"    {backward_text(name, shape, dtype, r)}; B4 query splits {splits}{unsplit}; "
                  f"{bound_text('B4', r['b4'], r['b4_rated'], r['b4_at_clock'])}; "
                  f"{bound_text('B5', r['b5'], r['b5_rated'], r['b5_at_clock'])}", flush=True)
    return rows


ATTENTION_SOURCES = ("flash_attn_fwd", "flash_attn_bwd")
BLEND_SOURCES = ("blend_fwd", "blend_bwd")
# the instantiations whose SASS loops --blend counts: B1 as the eval frame
# runs it (C = 4), B2 as the train step does (C = 3)
SASS_KERNELS = (("blend_fwd", "blend_fwd_kernelILi4E"), ("blend_bwd", "blend_bwd_kernelILi3E"))
BLEND_LAUNCHES = 20  # calls in each device-time window of --blend


def print_ptxas(sources=ATTENTION_SOURCES + BLEND_SOURCES + ("blend_variants",)) -> None:
    """The kernels' registers and spills, per kernel and instantiation, as
    ptxas -v reported them to the nvcc runs of this process."""
    from gaussctrl_exp_tpu_torch.ops import cuda_build

    for src in sources:
        for line in cuda_build.logs.get(src, "").splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line and "0 bytes spill" not in line:
                print(f"    ptxas {src}: " + line.split("ptxas info    :")[-1].strip())


_SASS_FUNC = re.compile(r"Function : (\S+)")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)[.\w]*([^;]*);")
_SASS_TARGET = re.compile(r"0x([0-9a-f]+)")
SASS_CLASSES = ("FFMA", "FMUL", "FADD", "MUFU", "LDS", "STS", "SHFL", "ATOMS", "BRA")


def sass_loops(text: str, match: str) -> list[dict]:
    """The loops of the first function whose (mangled) name holds ``match``
    in ``cuobjdump -sass`` output ``text``: one entry per backward branch,
    innermost (shortest) first, with its byte range, its instruction count
    and the count of each class of ``SASS_CLASSES`` (the opcode before its
    first dot; a loop's count includes the loops nested in it)."""
    instrs, found = [], False
    for line in text.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            if found:
                break
            found = match in m.group(1)
            continue
        m = _SASS_INSTR.search(line) if found else None
        if m:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in instrs:
        t = _SASS_TARGET.search(rest)
        if op == "BRA" and t and int(t.group(1), 16) <= addr:
            lo = int(t.group(1), 16)
            body = [o for a, o, _ in instrs if lo <= a <= addr]
            loops.append(dict(start=lo, end=addr, instructions=len(body),
                              **{c: body.count(c) for c in SASS_CLASSES}))
    return sorted(loops, key=lambda d: d["instructions"])


def sass(name: str) -> str:
    """``cuobjdump -sass`` of kernel ``name``'s library (built if needed)."""
    from gaussctrl_exp_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(cuda_build.build([name])[name])], capture_output=True, text=True,
                         check=True, timeout=300)
    return out.stdout


def print_sass() -> None:
    """The loops of B1 (C = 4) and B2 (C = 3) in their SASS, innermost
    first, with their instructions by class, where cuobjdump runs; where it
    does not, says so."""
    for src, match in SASS_KERNELS:
        try:
            text = sass(src)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"    sass {src}: cuobjdump did not run: {e}")
            continue
        loops = sass_loops(text, match)
        if not loops:
            print(f"    sass {match}: no backward branch found in {len(text)} bytes of cuobjdump output")
        for lp in loops:
            counts = " ".join(f"{c} {lp[c]}" for c in SASS_CLASSES)
            print(f"    sass {match} loop {lp['start']:#06x}-{lp['end']:#06x}: {lp['instructions']} instructions; {counts}")


def blend_rows(dev, cases) -> dict:
    """B1 at bear C = 4 and garden, B2 at bear C = 3 (seeded random
    cotangents) and garden, each alone by device time (``kernel_time_ms``,
    ``BLEND_LAUNCHES`` calls a window) with the SM clock read before and
    after, against its bound, with the tile-work spread and the one-SM
    floor (``tile_spread``)."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import gpu_clocks, kernel_time_ms

    rows = {}
    for kernel, case in (("B1", "bear"), ("B1", "garden"), ("B2", "bear3"), ("B2", "garden")):
        args, bins = cases[case]
        backward = kernel == "B2"
        fwd = blend_cuda.blend_forward(*args, bins, S, S)
        gen = torch.Generator(device=dev).manual_seed(3)
        g_img = torch.randn(fwd.img.shape, generator=gen, device=dev)
        g_T = torch.randn(fwd.final_T.shape, generator=gen, device=dev)
        if backward:
            def fn():
                return blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T, S, S)
        else:
            def fn():
                return blend_cuda.blend_forward(*args, bins, S, S)
        before = gpu_clocks()
        ms = kernel_time_ms(fn, "blend_bwd_kernel" if backward else "blend_fwd_kernel", BLEND_LAUNCHES)
        after = gpu_clocks()
        bound, by, work = blend_bound(args, bins, S, S, backward)
        sp = tile_spread(args, bins, S, S, backward)
        print(f"  {kernel} {'garden' if case == 'garden' else 'bear'} {S}² C={args[2].shape[1]}: {ms:.4f} ms device time per launch; bound {bound:.5f} ms "
              f"({by}), time / bound {ms / bound:.2f}; n_isects {bins.n_isects}; work {work}; clock before "
              f"{clock_text(before)}, after {clock_text(after)}")
        print(f"    tiles {sp['tiles']}: evaluated pairs a tile max {sp['eval_max']} mean {sp['eval_mean']:.1f}; list "
              f"max {sp['list_max']} mean {sp['list_mean']:.1f}; heaviest tile {sp['heaviest_tile']} (list "
              f"{sp['heaviest_list']}, {sp['heaviest_eval']} pairs evaluated, {sp['heaviest_ops']} operations, "
              f"{sp['ops_max_over_mean']:.2f}× the mean); one-SM floor {sp['one_sm_floor_ms']:.5f} ms")
        rows[(kernel, case)] = dict(ms=ms, bound_ms=bound, bound_by=by, **sp)
    return rows


def attention_only(dev) -> int:
    """``--attention``: kernels B3, B4 and B5 built, B3 checked at phase 9's
    shapes, then the three alone against SDPA by device time (the kernel rows
    of phases 11 and 15), for a before/after comparison of the attention
    kernels within one chip call. Prints no kernels line and no result."""
    from gaussctrl_exp_tpu_torch.ops import cuda_build
    from gaussctrl_exp_tpu_torch.utils.timing import spare_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{smi_line()}; {ATTN_LAUNCHES} calls a window")
    cuda_build.build(ATTENTION_SOURCES)
    print_ptxas(ATTENTION_SOURCES)
    _, flash_cases = phase9_flash(dev)
    print("[11] B3 alone, by device time")
    b3_rows(dev, flash_cases)
    print("[15] B4 and B5 alone, by device time")
    bwd_rows(dev)
    print(f"spare launches a profiled cycle at the end {spare_launches()}")
    return 0


def blend_only(dev) -> int:
    """``--blend``: kernels B1 and B2 built (their registers, spills and
    SASS loops printed), checked as in phases 3 and 6, then timed alone by
    device time (``blend_rows``), for a before/after comparison of the blend
    kernels within one chip call. Prints no kernels line and no result."""
    from gaussctrl_exp_tpu_torch.cli import render as cli
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.ops import cuda_build
    from gaussctrl_exp_tpu_torch.utils.timing import spare_launches

    print(f"{smi_line()}; {BLEND_LAUNCHES} calls a window")
    t0 = time.perf_counter()
    cuda_build.build(BLEND_SOURCES)
    print(f"built B1 and B2 in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)})")
    print_ptxas(BLEND_SOURCES)
    print_sass()
    bear = synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5)
    garden = synthetic_params(N_GARDEN, 7, 1.2, -5.3, 0.4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, path_json = write_inputs(Path(tmp), bear)
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
        cam0 = cli.path_cameras(path_json, device=dev)[0]
    cases = blend_cases(dev, state, cam0, garden)
    phase3_blend(cases)
    phase6_blend(dev, cases, state, cam0)
    print("[5, 8] B1 and B2 alone, by device time")
    blend_rows(dev, cases)
    print(f"spare launches a profiled cycle at the end {spare_launches()}")
    return 0

# ---------------------------------------------------------------- phases 12-15

# B4/B5 at the depth generator's training shapes (B, H, S, T, D): 4 views at
# 64² latents, SD1.x's self-attention at 64², 32², 16², 8² and its
# cross-attention to the 77 text tokens; then a ragged shape
MV_V = 4
MV_MAIN = (MV_V, 8, 4096, 4096, 40)
MV_SHAPES = [
    ("self 64²", MV_MAIN),
    ("self 32²", (MV_V, 8, 1024, 1024, 80)),
    ("self 16²", (MV_V, 8, 256, 256, 160)),
    ("self 8²", (MV_V, 8, 64, 64, 160)),
    ("cross 64²", (MV_V, 8, 4096, 77, 40)),
    ("cross 32²", (MV_V, 8, 1024, 77, 80)),
    ("cross 16²", (MV_V, 8, 256, 77, 160)),
    ("ragged", (2, 3, 100, 77, 24)),
]
MV_SAMPLE_MAIN = (2 * MV_V, *MV_MAIN[1:])  # the sampling step's self-attention at 64², CFG batch 8
# B3 timed in phase 11 beyond phase 9's bf16 shapes: the DDIM inversion's
# batch of 1 in bf16, and in fp32 the depth generator's shapes (training and
# sampling)
B3_TIMED_SHAPES = [
    ("inversion self 64²", (1, *FLASH_MAIN[1:]), torch.bfloat16),
    *((f"generator {name}", shape, torch.float32) for name, shape in MV_SHAPES),
    ("generator sampling self 64² (CFG 8)", MV_SAMPLE_MAIN, torch.float32),
]
# B4/B5 against autograd through sdpa_plain in fp32 on the upcast inputs and
# cotangent, relative L2 per gradient. fp32: the same sums in another order;
# bf16: the gradients are rounded to bf16, and so are P and dS before their
# products, as the forward rounds P
BWD_F32_REL_L2, BWD_BF16_REL_L2 = 1e-5, 1.5e-2
MV_PARAMS = 859_523_844  # the SD1.x UNet's 859,520,964 + 320·9 for the depth channel
MV_ORBIT = 24  # 4 views 15° apart on phase 4's orbit
MV_LR = 1e-5
MV_TRAIN_STEPS = 3
MV_SAMPLE_STEPS = 4
# the full-width fp32 gradient through B3/B4/B5 against the same step through
# sdpa_plain: each attention differs by ~1e-6 and the UNet carries it
MV_GRAD_REL_L2 = 1e-3
# the tiny fp32 train step on the card against the CPU: loss and gradient
MV_TINY_REL = 1e-4
TINY_GEN = dict(block_out=(32, 64), heads=2, cross_dim=16, layers_per_block=1)
EXP_STEPS = 5  # the experimental processors' edits: 5 steps instead of 20
INPAINT_STEPS = 20


def flash_grads(q, k, v, dout):
    """FlashAttnFunction's output and (dq, dk, dv)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attention_cuda.FlashAttnFunction.apply(*leaves)
    return out, torch.autograd.grad(out, leaves, dout)


def plain_grads(q, k, v, dout):
    """(dq, dk, dv) of autograd through sdpa_plain in fp32 on the upcast
    inputs, in batch chunks of at most ~2 GB of scores."""
    from gaussctrl_exp_tpu_torch.ops.attention_cuda import sdpa_plain

    B, H, S, _ = q.shape
    chunk = max(1, int(2e9 // (H * S * k.shape[2] * 4)))
    parts = []
    for i in range(0, B, chunk):
        ref = [t[i:i + chunk].detach().float().requires_grad_() for t in (q, k, v)]
        parts.append(torch.autograd.grad(sdpa_plain(*ref), ref, dout[i:i + chunk].float()))
    return [torch.cat([p[j] for p in parts]) for j in range(3)]


def check_flash_bwd(name, q, k, v, seed) -> dict:
    """B4/B5 against autograd through sdpa_plain; returns max |d| of dq (B5)
    and of dk, dv (B4)."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    _, got = flash_grads(q, k, v, dout)
    torch.cuda.synchronize()
    want = plain_grads(q, k, v, dout)
    limit = BWD_BF16_REL_L2 if q.dtype == torch.bfloat16 else BWD_F32_REL_L2
    errs, parts, ok = {}, [], True
    for gname, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        d = g.float() - w
        rel, err = float(d.norm() / w.norm()), float(d.abs().max())
        errs[gname] = err
        parts.append(f"{gname} relL2 {rel:.3e} max|d| {err:.3e} (max|plain| {float(w.abs().max()):.3e})")
        ok &= rel <= limit and g.shape == x.shape and g.dtype == x.dtype and bool(torch.isfinite(g).all())
    print(f"  {name} {str(q.dtype).split('.')[-1]} (B, H, S, T, D) = {tuple(q.shape[:3]) + tuple(k.shape[2:])}: "
          + "; ".join(parts))
    if not ok:
        raise SystemExit(f"FAIL: flash_attn_bwd disagrees with autograd through sdpa_plain on {name} {q.dtype}")
    return {"B5": errs["dq"], "B4": max(errs["dk"], errs["dv"])}


def phase12_flash_bwd(dev) -> dict:
    """B4/B5 against autograd through sdpa_plain at the depth generator's
    shapes, bf16 and fp32; a strided view; two runs bit for bit; B3's
    output with and without the log-sum-exp; the gradient through _sdpa."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import _sdpa
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    print("[12] flash attention backward kernels (B4 dK/dV, B5 dQ) vs autograd through sdpa_plain (fp32)")
    errs = {torch.bfloat16: {"B4": 0.0, "B5": 0.0}, torch.float32: {"B4": 0.0, "B5": 0.0}}
    for i, (name, shape) in enumerate(MV_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            e = check_flash_bwd(name, *flash_inputs(shape, dtype, 200 + i, dev), seed=300 + i)
            errs[dtype] = {kk: max(errs[dtype][kk], e[kk]) for kk in e}
    B, H, S, T, D = 2, 4, 96, 77, 24  # the head split's transposed views
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(5)
        mk = lambda L: torch.randn((B, L, H * D), generator=gen, device=dev).to(dtype).view(B, L, H, D).transpose(1, 2)
        q, k, v = mk(S), mk(T), mk(T)
        copies = attention_cuda.copies
        check_flash_bwd("strided head-split views", q, k, v, seed=6)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        a = flash_grads(q, k, v, dout)[1]
        b = flash_grads(q.contiguous(), k.contiguous(), v.contiguous(), dout)[1]
        if attention_cuda.copies != copies or not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise SystemExit("FAIL: the strided views were copied, or gave other gradients than contiguous inputs")
    for dtype in (torch.bfloat16, torch.float32):  # determinism and the log-sum-exp at the main shape
        q, k, v = flash_inputs(MV_MAIN, dtype, 7, dev)
        dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(8), device=dev).to(dtype)
        first, second = flash_grads(q, k, v, dout)[1], flash_grads(q, k, v, dout)[1]
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        out_plain = attention_cuda.flash_attn(q, k, v)
        out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
        want = torch.logsumexp(torch.matmul(q[:1].float(), k[:1].float().transpose(-1, -2)) * MV_MAIN[-1] ** -0.5, -1)
        lse_err = float((lse[:1] - want).abs().max())
        print(f"  {str(dtype).split('.')[-1]} {MV_MAIN}: two backward runs bit-identical {same}; B3 output with and "
              f"without the log-sum-exp bit-identical {torch.equal(out, out_plain)}; lse max|d| vs logsumexp of the "
              f"fp32 scores (batch 0) {lse_err:.3e}")
        if not (same and torch.equal(out, out_plain) and lse_err <= 1e-3):
            raise SystemExit("FAIL: the backward is not deterministic, or the log-sum-exp changed B3's output")
    # B4 with its queries split over several CTAs (cross 64²): the partials
    # are summed in a fixed order, by a second pass that each of the two
    # backward runs launches once
    shape = dict(MV_SHAPES)["cross 64²"]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(shape, dtype, 10, dev)
        dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(11), device=dev).to(dtype)
        sums = attention_cuda.dkv_sum_launches()
        first, second = flash_grads(q, k, v, dout)[1], flash_grads(q, k, v, dout)[1]
        sums = attention_cuda.dkv_sum_launches() - sums
        splits = attention_cuda.dkv_splits(*shape, torch.cuda.get_device_properties(dev).multi_processor_count,
                                           bf16=dtype == torch.bfloat16)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        print(f"  {str(dtype).split('.')[-1]} {shape}: B4's queries split {splits} ways; the partials' sum launched "
              f"{sums} times in two backward runs; the two runs bit-identical {same}")
        if splits < 2 or sums != 2 or not same:
            raise SystemExit("FAIL: the split backward did not split, or is not deterministic")
    for dtype in (torch.bfloat16, torch.float32):  # _sdpa keeps the gradient on the card
        q, k, v = (t.requires_grad_() for t in flash_inputs((2, 8, 1024, 1024, 80), dtype, 9, dev))
        out = _sdpa(q, k, v)
        out.float().square().sum().backward()
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        attention_cuda.sdpa_plain(*ref).square().sum().backward()
        rels = [float((t.grad.float() - r.grad).norm() / r.grad.norm()) for t, r in zip((q, k, v), ref)]
        limit = BWD_BF16_REL_L2 if dtype == torch.bfloat16 else BWD_F32_REL_L2
        print(f"  _sdpa on CUDA inputs that require grad ({str(dtype).split('.')[-1]}): out.requires_grad "
              f"{out.requires_grad}, grad_fn {type(out.grad_fn).__name__}; dq, dk, dv relative L2 vs plain "
              + ", ".join(f"{r:.3e}" for r in rels))
        if not out.requires_grad or max(rels) > limit:
            raise SystemExit("FAIL: _sdpa on the card drops or corrupts the gradient through attention")
    return errs


@contextlib.contextmanager
def attention_through_plain():
    """Every ``_sdpa`` call of the diffusion modules goes to ``sdpa_plain``
    (the processors stay as they are); yields the count of those calls."""
    from gaussctrl_exp_tpu_torch.diffusion import attention, correspondence, triplane_attention
    from gaussctrl_exp_tpu_torch.ops.attention_cuda import sdpa_plain

    calls = [0]

    def plain(q, k, v):
        calls[0] += 1
        return sdpa_plain(q, k, v)

    saved = [(m, m._sdpa) for m in (attention, correspondence, triplane_attention)]
    for m, _ in saved:
        m._sdpa = plain
    try:
        yield calls
    finally:
        for m, f in saved:
            m._sdpa = f


def counts() -> tuple[int, int, int]:
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    return attention_cuda.launches, attention_cuda.dkv_launches, attention_cuda.dq_launches


def zero_counts() -> None:
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    attention_cuda.launches = attention_cuda.dkv_launches = attention_cuda.dq_launches = 0


def grad_groups(named_grads, ref) -> tuple[float, dict]:
    """Relative L2 of the whole gradient against ``ref``, and per top-level
    block (``down_0``, ``mid``, ``up_3``, ``conv_in``, …)."""
    num, den, groups = 0.0, 0.0, {}
    for name, g in named_grads.items():
        w = ref[name]
        dn, wn = float((g - w).double().square().sum()), float(w.double().square().sum())
        num, den = num + dn, den + wn
        key = "_".join(name.split(".")[0].split("_")[:2]) if name.startswith(("down", "up")) else name.split("_")[0]
        a, b = groups.get(key, (0.0, 0.0))
        groups[key] = (a + dn, b + wn)
    return (num / den) ** 0.5, {k: (a / b) ** 0.5 if b > 0 else 0.0 for k, (a, b) in groups.items()}


def mv_views(state, dev):
    """4 orbit views at 512², 15° apart: rgb and depth from render_model."""
    from gaussctrl_exp_tpu_torch.cameras import make_camera
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model

    f = S / (2 * np.tan(np.radians(FOV_DEG) / 2))
    cams = [make_camera(orbit_c2w(i, MV_ORBIT), f, f, S / 2, S / 2, S, S, device=dev) for i in range(MV_V)]
    with torch.no_grad():
        outs = [render_model(state, c, 30_000, SplatModelConfig(background_color="white")) for c in cams]
    return cams, [o.rgb for o in outs], [o.depth for o in outs]


def tiny_train_step(tiny, device) -> tuple[float, dict]:
    """One Adam(1e-3) step of a copy of the tests' tiny generator ``tiny``
    (2 views at 32², 8² latents) on ``device`` through its epipolar
    processor; returns the loss and the gradients on the CPU."""
    from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
    from gaussctrl_exp_tpu_torch.diffusion.mv_generator import DepthGenerator

    gen = DepthGenerator(copy.deepcopy(tiny.unet).to(device), tiny.cfg)
    cams = [make_camera(look_at(e, np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32, device=device)
            for e in ([0.0, -4.0, 0.0], [0.5, -3.9, 0.2])]
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    depths = [4.0 + 0.2 * xs - 0.1 * ys, 4.1 - 0.15 * xs + 0.1 * ys]
    proc, dl, _ = gen.prepare(depths, cams)
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor((rng.normal(size=(2, 8, 8, 4)) * 0.5).astype(np.float32), device=device)
    ctx = torch.as_tensor(rng.normal(size=(2, 77, 16)).astype(np.float32), device=device)
    noise = torch.as_tensor(rng.normal(size=(2, 8, 8, 4)).astype(np.float32), device=device)
    t = torch.tensor([437, 81], device=device)
    opt = torch.optim.Adam(gen.unet.parameters(), lr=1e-3)
    loss = gen.train_step_at(opt, x0, dl, ctx, t, noise, proc)
    return float(loss), {n: p.grad.detach().cpu() for n, p in gen.unet.named_parameters()}


def phase13_mv(dev, state, edit) -> dict:
    """The depth generator at full SD1.x width in fp32: 3 Adam steps through
    the epipolar processor with B3/B4/B5 counted, the step's gradient
    against the same step through sdpa_plain, sampling, and the tiny step
    card vs CPU."""
    from gaussctrl_exp_tpu_torch.diffusion.mv_generator import MVGeneratorConfig, init_depth_generator

    pipe = edit["pipe"]
    t0 = time.perf_counter()
    gen = init_depth_generator(SD_SEED, cfg=MVGeneratorConfig(latent_size=S // 8, num_steps=MV_SAMPLE_STEPS), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in gen.unet.parameters())
    cams, rgbs, depths = mv_views(state, dev)
    with torch.no_grad():
        x0 = torch.cat([pipe.pipe.image_to_latent(r[None]).float() for r in rgbs])
    ctx = pipe._encode([EDIT_PROMPT] * MV_V)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    proc, dl, pair_mask = gen.prepare(depths, cams)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t1
    print(f"[13] depth generator: UNet with a 5-channel conv_in, {n_params:,} parameters (expected {MV_PARAMS:,}), "
          f"fp32, random weights (seed {SD_SEED}), made in {t1 - t0:.2f} s with the {MV_V} views' renders and "
          f"latents; prepare (tables at {gen.attention_resolutions()}, pair mask) {prep_s:.3f} s; pair mask "
          f"{pair_mask.tolist()}; clean latents {tuple(x0.shape)} std {float(x0.std()):.4f}")
    if n_params != MV_PARAMS or not (pair_mask - np.eye(MV_V)).any():
        raise SystemExit("FAIL: the depth generator has the wrong size, or no view pair exchanges attention")

    # one step's gradient through the kernels against the same step through sdpa_plain
    g = torch.Generator(device=dev).manual_seed(11)
    t_fix = torch.randint(0, 1000, (MV_V,), generator=g, device=dev)
    noise_fix = torch.randn(x0.shape, generator=g, device=dev)
    gen.unet.zero_grad(set_to_none=True)
    zero_counts()
    loss_k = gen.loss(x0, dl, ctx, t_fix, noise_fix, proc)
    loss_k.backward()
    torch.cuda.synchronize()
    grad_launches = counts()
    g_kernel = {n: p.grad.detach().clone() for n, p in gen.unet.named_parameters()}
    gen.unet.zero_grad(set_to_none=True)
    zero_counts()
    with attention_through_plain() as plain_calls:
        loss_p = gen.loss(x0, dl, ctx, t_fix, noise_fix, proc)
        loss_p.backward()
    torch.cuda.synchronize()
    total_rel, groups = grad_groups(g_kernel, {n: p.grad for n, p in gen.unet.named_parameters()})
    print(f"    one step at t = {t_fix.tolist()}: loss through B3/B4/B5 {loss_k.item():.7f}, through sdpa_plain "
          f"{loss_p.item():.7f}; launches (B3, B4, B5) {grad_launches} vs {counts()} and {plain_calls[0]} sdpa_plain "
          f"calls; gradient relative L2 {total_rel:.3e} (limit {MV_GRAD_REL_L2}); per block "
          + ", ".join(f"{k} {v:.2e}" for k, v in groups.items()))
    if total_rel > MV_GRAD_REL_L2 or counts() != (0, 0, 0) or min(grad_launches) == 0:
        raise SystemExit("FAIL: the full-width gradient through the kernels disagrees with sdpa_plain's")
    del g_kernel
    gen.unet.zero_grad(set_to_none=True)

    # the main path: 3 Adam steps, launches counted
    opt = torch.optim.Adam(gen.unet.parameters(), lr=MV_LR)
    step = gen.make_train_step(opt, proc)
    before = {n: p.detach().clone() for n, p in gen.unet.named_parameters()}
    n_attn = 2 * count_transformers(gen.unet)  # self + cross per Transformer2D
    gen_draws = torch.Generator(device=dev).manual_seed(12)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [float(step(x0, dl, ctx, gen_draws)) for _ in range(MV_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = {}
    for n, p in gen.unet.named_parameters():
        key = "_".join(n.split(".")[0].split("_")[:2]) if n.startswith(("down", "up")) else n.split("_")[0]
        moved[key] = max(moved.get(key, 0.0), float((p.detach() - before[n]).abs().max()))
    del before
    print(f"    {MV_TRAIN_STEPS} Adam({MV_LR}) steps of train_step ({MV_V} views, 64² latents): losses "
          f"{[round(x, 6) for x in losses]} in {train_wall:.3f} s host wall (first step included); launches "
          f"B3 {launches[0]}, B4 {launches[1]}, B5 {launches[2]} (expected {MV_TRAIN_STEPS * n_attn} each: "
          f"{n_attn} attention calls per step); peak device memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated); largest |Δ| per block "
          + ", ".join(f"{k} {v:.1e}" for k, v in moved.items()))
    if launches != (MV_TRAIN_STEPS * n_attn,) * 3 or not all(np.isfinite(losses)) or min(moved.values()) <= 0:
        raise SystemExit("FAIL: the train steps skipped a kernel, gave a non-finite loss or left a block unmoved")

    # sampling: 4 DDIM steps, CFG batch 8
    init = torch.randn((MV_V, S // 8, S // 8, 4), generator=torch.Generator(device=dev).manual_seed(13), device=dev)
    unc = pipe._encode([""] * MV_V)
    zero_counts()
    t0 = time.perf_counter()
    lat = gen.sample(ctx, unc, depths, cams, init_latents=init)
    torch.cuda.synchronize()
    sample_wall = time.perf_counter() - t0
    sample_launches = counts()
    with torch.no_grad():
        imgs = pipe.pipe.latent_to_image(lat).float()
    print(f"    sample: {MV_SAMPLE_STEPS} steps at CFG batch {2 * MV_V} in {sample_wall:.3f} s host wall (prepare "
          f"included); launches (B3, B4, B5) {sample_launches}; latents {tuple(lat.shape)} std "
          f"{float(lat.std()):.4f}; decoded images in [{float(imgs.min()):.4f}, {float(imgs.max()):.4f}]")
    if lat.shape != (MV_V, S // 8, S // 8, 4) or not bool(torch.isfinite(lat).all()) \
            or sample_launches != (MV_SAMPLE_STEPS * n_attn, 0, 0) or not bool(torch.isfinite(imgs).all()):
        raise SystemExit("FAIL: sampling gave non-finite latents or skipped B3")

    # the tiny fp32 train step on the card against the CPU
    tiny = init_depth_generator(0, latent=8, device="cpu", **TINY_GEN)
    loss_card, g_card = tiny_train_step(tiny, dev)
    loss_cpu, g_cpu = tiny_train_step(tiny, torch.device("cpu"))
    tiny_rel, _ = grad_groups(g_card, g_cpu)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"    tiny generator step (2 views, 8² latents), card vs CPU: loss {loss_card:.7f} vs {loss_cpu:.7f} "
          f"(relative {loss_rel:.2e}), gradient relative L2 {tiny_rel:.3e} (limit {MV_TINY_REL})")
    if max(loss_rel, tiny_rel) > MV_TINY_REL:
        raise SystemExit("FAIL: the tiny train step on the card disagrees with the CPU")
    return dict(gen=gen, opt=opt, proc=proc, dl=dl, ctx=ctx, unc=unc, x0=x0, t=t_fix, noise=noise_fix,
                launches=launches, train_wall=train_wall, sample_wall=sample_wall, peak_gb=peak_gb, cams=cams,
                depths=depths)


def phase14_experimental(dev, state, cams, targets, edit) -> None:
    """The edit with the experimental processors on phase 10's caches, an
    inpaint of one view, and the noise mask of one view, bf16 at full
    width."""
    from gaussctrl_exp_tpu_torch.diffusion.inpaint import InpaintConfig, SDInpaintPipeline
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
    from gaussctrl_exp_tpu_torch.experimental.noise_mask import NoiseMaskConfig, noise_points, render_noise_mask
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
    from gaussctrl_exp_tpu_torch.ops import attention_cuda, blend_cuda

    base = edit["pipe"]
    V = len(cams)
    print(f"[14] experimental paths at full SD1.x width, bf16, on phase 10's caches ({V} views at {S}²)")
    for proc in ("correspondence", "triplane"):
        cfg = EditConfig(edit_prompt=EDIT_PROMPT, reverse_prompt=REVERSE_PROMPT, attn_processor=proc,
                         num_inference_steps=EXP_STEPS)
        pipe = GaussCtrlEditPipeline(cfg, models=base.models, tokenizer=crc_tokenize)
        for name in ("z0", "disparity", "depths", "unedited"):
            setattr(pipe, name, dict(getattr(base, name)))
        views = EditViews(cams, [t.clone() for t in targets])
        attention_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.edit_images(views)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        imgs = torch.stack(views.images)
        print(f"    edit_images with attn_processor={proc!r}, {EXP_STEPS} steps (cut from 20): {wall:.3f} s host "
              f"wall; B3 launches {attention_cuda.launches}; written back {sorted(views.writes)}; images in "
              f"[{float(imgs.min()):.4f}, {float(imgs.max()):.4f}], mean |edited − render| "
              f"{float((imgs - torch.stack(targets)).abs().mean()):.4f}")
        if sorted(views.writes) != list(range(V)) or not bool(torch.isfinite(imgs).all()) \
                or float(imgs.min()) < 0 or float(imgs.max()) > 1 or attention_cuda.launches == 0:
            raise SystemExit(f"FAIL: the {proc} edit did not write every view once in [0, 1] through B3")

    ip = SDInpaintPipeline(base.pipe, InpaintConfig(num_steps=INPAINT_STEPS))
    img = targets[0][None].float()
    mask = np.zeros((S, S), np.float32)
    mask[S // 4: 3 * S // 4, S // 4: 3 * S // 4] = 1.0
    hint = torch.as_tensor(base.disparity[0], device=dev)[None]
    attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = ip.inpaint_images(torch.Generator(device=dev).manual_seed(14), img, mask,
                            base._encode([EDIT_PROMPT]), base._encode([""]), hint)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inside = torch.as_tensor(mask > 0.5, device=dev)
    kept = bool(torch.equal(out[0][~inside], img[0][~inside]))
    changed = float((out[0][inside] - img[0][inside]).abs().mean())
    print(f"    inpaint_images, one view at {S}², centre square masked, {INPAINT_STEPS} steps with the depth hint: "
          f"{wall:.3f} s host wall; B3 launches {attention_cuda.launches}; output in [{float(out.min()):.4f}, "
          f"{float(out.max()):.4f}]; outside the mask exact {kept}; mean |d| inside {changed:.4f}")
    if not (kept and bool(torch.isfinite(out).all()) and 0 <= float(out.min()) and float(out.max()) <= 1
            and changed > 0 and attention_cuda.launches > 0):
        raise SystemExit("FAIL: the inpaint is not finite in [0, 1], or changed the kept region")

    t0 = time.perf_counter()
    pts = noise_points(NoiseMaskConfig())
    pts_s = time.perf_counter() - t0
    with torch.no_grad():
        depth0 = render_model(state, cams[0], 30_000, SplatModelConfig(background_color="white")).depth
    for window in (NoiseMaskConfig().frag_depth_threshold, 0.1):
        blend_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = render_noise_mask(pts, depth0, cams[0], NoiseMaskConfig(frag_depth_threshold=window))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"    render_noise_mask, {len(pts)} Perlin points (100³ grid, threshold 0.8, {pts_s:.2f} s on the "
              f"host), depth window {window}: {wall * 1e3:.2f} ms; blend_fwd launches {blend_cuda.launches}; "
              f"mask {tuple(m.shape)} in [{float(m.min()):.4f}, {float(m.max()):.4f}], coverage > 0.5 "
              f"{float((m > 0.5).float().mean()):.5f}")
        if m.shape != (S, S) or not bool(torch.isfinite(m).all()) or float(m.min()) < 0 or float(m.max()) > 1 \
                or blend_cuda.launches != 1:
            raise SystemExit("FAIL: the noise mask is not finite in [0, 1] or skipped B1")


def step_timings(gen, opt, args, iters=2) -> dict:
    """A generator train step on ``args`` (``gen.loss``'s) by stage, in CUDA
    events (the mean of ``iters`` steps): forward, backward, optimizer; and
    by device time (torch.profiler): the whole step with its busy share, the
    forward with B3's part, the backward with B4 + B5's."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import device_window

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = np.zeros(3)
    for _ in range(iters):
        torch.cuda.synchronize()
        ev[0].record()
        loss = gen.loss(*args)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.zero_grad(set_to_none=True)
        ev[3].record()
        torch.cuda.synchronize()
        split += [ev[i].elapsed_time(ev[i + 1]) / iters for i in range(3)]

    def full_step():
        gen.loss(*args).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    def fresh_loss():
        opt.zero_grad(set_to_none=True)
        return gen.loss(*args)

    step_win = device_window(full_step, attention_cuda.ATTN_KERNELS)
    fwd_win = device_window(fresh_loss, attention_cuda.B3_KERNEL)
    bwd_win = device_window(lambda loss: loss.backward(), attention_cuda.BWD_KERNELS, prepare=fresh_loss)
    opt.zero_grad(set_to_none=True)
    return dict(split=split, step_ms=float(split.sum()), step_win=step_win, fwd_win=fwd_win, bwd_win=bwd_win)


def step_text(r: dict) -> str:
    split, step_win, fwd_win, bwd_win = r["split"], r["step_win"], r["fwd_win"], r["bwd_win"]
    bwd_dev, bwd_kernels = bwd_win["device_ms"], bwd_win["part_ms"]
    return (f"{r['step_ms']:.2f} ms = forward {split[0]:.2f} + backward {split[1]:.2f} + optimizer {split[2]:.2f}; "
            f"device time {step_win['device_ms']:.2f} ms in {step_win['ops']:.0f} device ops (torch.profiler, one "
            f"step): {busy_text(step_win)}; forward device time {fwd_win['device_ms']:.2f} ms, of which B3 "
            f"{fwd_win['part_ms']:.2f} ms = {fwd_win['part_ms'] / fwd_win['device_ms']:.3f}; backward device time "
            f"{bwd_dev:.2f} ms, of which B4 + B5 {bwd_kernels:.2f} ms = {bwd_kernels / bwd_dev:.3f}")


def bwd_entry(kernel: str, launches: int, errs: dict, mains: dict, dtype) -> dict:
    """The numbers of B4 or B5 in ``dtype`` for the kernels line: launches
    on the main path, phase 12's largest |d| and the relative L2 limit it was
    held to, and phase 15's times and bounds at the main shape with the
    exponentials' floor beside the bound."""
    m, key = mains[dtype], kernel.lower()
    return {"launches": launches, "max_abs_err": errs[dtype][kernel],
            "rel_l2_limit": BWD_BF16_REL_L2 if dtype == torch.bfloat16 else BWD_F32_REL_L2,
            "ms": m[key], "plain_ms": m["plain_ms"], "bound_ms": m[key + "_bound"]["bound_ms"],
            "bound_by": m[key + "_bound"]["bound_by"], "exp_ms": m[key + "_bound"]["exp_ms"],
            "library_ms": m["library_ms"]}


def phase15_timings(dev, mv) -> dict:
    """The train step by stage, its busy share and B4 + B5's share of the
    backward; B4 and B5 at every phase-12 shape against their bounds, the
    plain version and SDPA's backward; a sampling step and the
    correspondence processor's share of it."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor
    from gaussctrl_exp_tpu_torch.ops import attention_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import device_window

    gen, opt, proc = mv["gen"], mv["opt"], mv["proc"]
    step = step_timings(gen, opt, (mv["x0"], mv["dl"], mv["ctx"], mv["t"], mv["noise"], proc))
    print(f"[15] timings (CUDA events, warm). Depth generator train step, fp32, {MV_V} views at 64²: "
          + step_text(step))

    rows = bwd_rows(dev)
    mains = {}
    for dtype in (torch.float32, torch.bfloat16):
        main = rows[(MV_SHAPES[0][0], dtype)]
        q, k, v = flash_inputs(MV_MAIN, dtype, 400, dev)
        dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev).to(dtype)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fwd = time_ms(lambda: attention_cuda.sdpa_plain(*leaves), iters=3, warmup=1)
        plain_bwd = time_ms(lambda: torch.autograd.grad(attention_cuda.sdpa_plain(*leaves), leaves, dout), iters=3,
                            warmup=1) - fwd
        print(f"    main shape {MV_MAIN} {str(dtype).split('.')[-1]}: B4 {main['b4']:.4f} + B5 {main['b5']:.4f} ms "
              f"device time; autograd through sdpa_plain backward {plain_bwd:.4f} ms (forward + backward − forward, "
              f"CUDA events); scaled_dot_product_attention backward {main['sdpa_bwd_ms']:.4f} ms device time")
        mains[dtype] = dict(b4=main["b4"], b5=main["b5"], plain_ms=plain_bwd, library_ms=main["sdpa_bwd_ms"],
                            b4_bound=main["b4_rated"], b5_bound=main["b5_rated"])
        del q, k, v, dout, leaves

    # a sampling step at CFG batch 8, and the correspondence processor's share of it
    lat = torch.randn((2 * MV_V, S // 8, S // 8, 4), generator=torch.Generator(device=dev).manual_seed(15), device=dev)
    dl2 = torch.cat([mv["dl"], mv["dl"]])
    ctx2 = torch.cat([mv["unc"], mv["ctx"]])
    tt = torch.full((2 * MV_V,), 501, dtype=torch.long, device=dev)
    with torch.no_grad():
        gen_ms = time_ms(lambda: gen._eps(lat, dl2, tt, ctx2, proc), iters=3, warmup=1)
        plain_proc_ms = time_ms(lambda: gen._eps(lat, dl2, tt, ctx2, default_processor), iters=3, warmup=1)
        sample_win = device_window(lambda: gen._eps(lat, dl2, tt, ctx2, proc), attention_cuda.B3_KERNEL)
    print(f"    sampling step (CFG batch {2 * MV_V}): {gen_ms:.2f} ms with the epipolar processor, {plain_proc_ms:.2f} ms "
          f"with plain attention: the correspondence processor is {1 - plain_proc_ms / gen_ms:.3f} of the step; "
          f"device time {sample_win['device_ms']:.2f} ms, of which B3 {sample_win['part_ms']:.2f} ms = "
          f"{sample_win['part_ms'] / sample_win['device_ms']:.3f}; {busy_text(sample_win)}; "
          f"phase 13's sample {mv['sample_wall'] / MV_SAMPLE_STEPS * 1e3:.1f} ms per step host wall (prepare "
          f"included)")
    return mains


# ---------------------------------------------------------------- phase 16

# B1v's fp32 operations, from csrc/blend_variants.cu: a pair it evaluates
# (a pixel not done at the chunk's start, a gaussian whose footprint box at
# the mode's skip level meets the pixel's warp) runs B1's pair_alpha and the
# alpha test (OPS_EVALUATED); a live pair (aeff > 0) then adds 1 − aeff,
# T_excl (an exp and a multiply, 2; scan a multiply, 1; nomatmul none),
# T_after and its stop test (2) and the cumulation (negate, log1p and add, 3;
# notrans the subtraction, 1; scan the multiply, 1; nomatmul none). A
# composited pair adds the weight, the running minimum and a multiply-add per
# channel
OPS_VARIANT_LIVE = {"base": 8, "notrans": 6, "nomatmul": 3, "scan": 5, "pair": 8}
OPS_VARIANT_COMPOSITED_BASE = 2
# pixels left out of B1v's comparison (a stop decision within the band around
# T_EPS, where the kernel's serial sums and the plain version's cumsums may
# decide apart), as a share of the pixels compared
VARIANT_BAND_MAX = 5e-3
N_SPARSE = 500  # the script's scene with 500 gaussians: tiles with no intersection


def variant_bound(mode, run, args, bins, table, H, W) -> tuple[float, str, dict]:
    """B1v's bound for mode ``mode``: each input read once, the output
    written once, and the fp32 operations of the pairs it must evaluate and
    of the live ones among them (``blend_variants.variant_pairs`` on the
    plain run ``run``: up to the chunk at which each pixel is done, where the
    gaussian's footprint box at the mode's skip level meets the pixel's
    warp, as B1's bound counts them); ``empty`` only writes. Beside it in the
    work, ``walked_bound_ms``: the bound with every walked pair
    (``run.pairs``, the boxes ignored) evaluated and live."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    xys, conics, colors, opacs = args
    N, C = colors.shape
    n_bytes = run.out.numel() * 4
    evaluated, live = V.variant_pairs(mode, run, xys, conics, opacs, bins, H, W, table)
    n_ops = walked_ops = 0
    if mode != "empty":
        n_bytes += 4 * (N * (6 + C) + bins.n_isects + 2 * table.num_tiles)
        if mode == "pair":  # the chunk table and the pair ranges
            n_bytes += 4 * (3 * table.chunk_tile.numel() + 2 * table.num_tiles)
        composited_ops = (OPS_VARIANT_COMPOSITED_BASE + 2 * C) * run.composited
        n_ops = OPS_EVALUATED * evaluated + OPS_VARIANT_LIVE[mode] * live + composited_ops
        walked_ops = (OPS_EVALUATED + OPS_VARIANT_LIVE[mode]) * run.pairs + composited_ops
    bound, by = roofline(n_bytes, n_ops)
    walked, walked_by = roofline(n_bytes, walked_ops)
    return bound, by, dict(bytes=n_bytes, ops=n_ops, evaluated_pairs=evaluated, live_pairs=live,
                           walked_pairs=run.pairs, composited=run.composited, chunks=run.chunks,
                           walked_ops=walked_ops, walked_bound_ms=walked, walked_bound_by=walked_by)


def check_variant(name, mode, args, bins, H, W, capacity):
    """B1v against its plain version on the same CUDA tensors, every tile,
    the stop band left out; returns max |d|, the plain run and B1v's output."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    table = V.bins_chunk_table(bins, H, W, capacity)
    got = V.blend_variant(mode, *args, bins, H, W, table=table)
    torch.cuda.synchronize()
    run = V.variant_plain_run(mode, *args, bins, H, W, table=table)
    keep = ~run.band
    d = (got - run.out).abs()[keep]
    want = run.out[keep]
    err = float(d.max()) if d.numel() else 0.0
    tight = bool((d <= ATOL_IMG + RTOL * want.abs()).all())
    done_ok = torch.equal(got[keep][:, V.COL_DONE], want[:, V.COL_DONE])
    n_band = int(run.band.sum())
    defined = V.defined_tiles(mode, table)
    print(f"  {name} {mode}: max|d| {err:.3e} off the band; band pixels {n_band} of {run.band.numel()}; done flags "
          f"equal {done_ok}; tiles defined on the TPU {int(defined.sum())} of {table.num_tiles}; chunks evaluated "
          f"{run.chunks}, pairs {run.pairs}")
    if not (tight and done_ok and n_band <= VARIANT_BAND_MAX * run.band.numel() and got.shape == run.out.shape):
        raise SystemExit(f"FAIL: blend_variants {mode} disagrees with its plain version on {name}")
    return err, run, got


def check_base_against_b1(name, got, run, args, bins, H, W) -> float:
    """``base`` in image layout against kernel B1 on the same inputs, off
    the stop band of either."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    C = args[2].shape[1]
    img, T = V.tiles_to_image(got, H, W, C)
    b1 = blend_cuda.blend_forward(*args, bins, H, W)
    torch.cuda.synchronize()
    band = V.tiles_to_image(run.band[..., None].expand(-1, -1, V.NCOL).float(), H, W, 1)[1] > 0
    band |= (b1.final_T - T_EPS).abs() <= V.STOP_BAND * T_EPS
    d_img, d_T = (img - b1.img).abs()[~band], (T - b1.final_T).abs()[~band]
    ok = bool((d_img <= ATOL_IMG + RTOL * b1.img.abs()[~band]).all()) and \
        bool((d_T <= ATOL_T + RTOL * b1.final_T.abs()[~band]).all())
    err = max(float(d_img.max()), float(d_T.max()))
    print(f"  {name} base vs B1 (image layout): max|d| {err:.3e} (img {float(d_img.max()):.3e}, T "
          f"{float(d_T.max()):.3e}) off {int(band.sum())} band pixels")
    if not ok:
        raise SystemExit(f"FAIL: blend_variants base disagrees with B1 on {name}")
    return err


def variant_checks(dev, odd, garden) -> tuple[dict, tuple]:
    """B1v against its plain version per mode at four scenes and ``base``
    against B1; returns the largest max |d| per mode and the script's scene
    (name, inputs, bins)."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V
    from gaussctrl_exp_tpu_torch.scripts import bench_blend_variants as bbv

    print("[16] kernel B1v (the blend-forward ablations) vs its plain version, every tile (both write the init "
          "where the TPU kernel leaves a tile undefined), pixels in the stop band left out")
    scenes = []
    for n, label in ((bbv.N_DEFAULT, "script scene"), (N_SPARSE, "sparse script scene")):
        sc = bbv.make_scene(n, bbv.S_DEFAULT, dev)
        with torch.no_grad():
            proj, bins = bbv.project_and_bin(sc)
        scenes.append((f"{label} N={n} {bbv.S_DEFAULT}²", (proj.xys, proj.conics, sc.colors, sc.opacs), bins,
                       bbv.S_DEFAULT, bbv.S_DEFAULT, V.CAPACITY, V.MODES))
    (main_name, main_args, main_bins, *_), sparse = scenes[0], scenes[1]
    sparse_table = V.bins_chunk_table(sparse[2], sparse[3], sparse[4])
    empty, defined = sparse[2].tile_cnt == 0, V.defined_tiles("base", sparse_table)
    print(f"    sparse scene: {int(empty.sum())} empty tiles, {int((empty & defined).sum())} of them own a padding "
          f"chunk (initialised on the TPU), {int((empty & ~defined).sum())} own none (undefined)")
    if not bool((empty & ~defined).any()):
        raise SystemExit("FAIL: the sparse scene has no undefined empty tile")
    g_args, g_bins = garden
    scenes += [("bear 500×372", *odd, 372, 500, V.CAPACITY, V.MODES),
               (f"garden {N_GARDEN} {S}²", g_args, g_bins, S, S, max(V.CAPACITY, g_bins.n_isects), ("base", "nomatmul"))]
    errs = dict.fromkeys(V.MODES, 0.0)
    for name, args, bins, H, W, cap, modes in scenes:
        for mode in modes:
            err, run, got = check_variant(name, mode, args, bins, H, W, cap)
            errs[mode] = max(errs[mode], err)
            if mode == "base":
                check_base_against_b1(name, got, run, args, bins, H, W)
    return errs, (main_name, main_args, main_bins)


def phase16_variants(dev, odd, garden) -> dict:
    """B1v against its plain version per mode at four scenes and ``base``
    against B1 (``variant_checks``); the main path: both ported benchmark
    scripts at their defaults, with the launches of B1v, B1 and B2 read
    around them; then B1v per mode at the script's scene (its time from the
    script) against both its bounds and the plain version."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V
    from gaussctrl_exp_tpu_torch.scripts import bench_blend_variants as bbv
    from gaussctrl_exp_tpu_torch.scripts import bench_bwd_micro as micro
    from gaussctrl_exp_tpu_torch.utils import timing

    errs, (main_name, main_args, main_bins) = variant_checks(dev, odd, garden)

    # the main path: both ported scripts, as a user runs them
    for mode in V.MODES:
        V.launches[mode] = 0
    blend_cuda.launches = blend_cuda.bwd_launches = timing.calls_made = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slope = bbv.main([])
    micro_rows = micro.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, b1, b2, timed = dict(V.launches), blend_cuda.launches, blend_cuda.bwd_launches, timing.calls_made
    # each script runs its slope batches, then kernel-alone measurements:
    # pairs of profiled windows of a warm-up call and the timed launches (a
    # pair whose records fall short is profiled again); bench_bwd_micro also
    # runs the forward once for B2's residuals, and each of its backward
    # batches a forward; B1 is timed alone by both scripts
    per_mode = (1 + bbv.REPEATS) * (bbv.K_LO + bbv.K_HI)
    micro_slope = (1 + micro.REPEATS) * (micro.K_LO + micro.K_HI)
    pair = 2 * (1 + bbv.KERNEL_LAUNCHES)
    alone = [counts[m] - per_mode for m in V.MODES] + [b1 - per_mode - 1 - 2 * micro_slope, b2 - micro_slope]
    fewest = [pair] * len(V.MODES) + [2 * pair, pair]
    print(f"    the two scripts at their defaults in {wall:.1f} s: launches B1v {counts}, B1 {b1}, B2 {b2}; "
          f"alone (B1v by mode, B1, B2) {alone}, in pairs of {pair} calls, {timed} timed calls in all")
    times = [v for r in (slope, micro_rows) for row in r.values() for v in row.values()]
    if any(a < f or a % pair for a, f in zip(alone, fewest)) or sum(alone) != timed or not all(np.isfinite(times)):
        raise SystemExit("FAIL: the benchmark scripts skipped a kernel or gave a non-finite time")

    Sv = bbv.S_DEFAULT
    table = V.bins_chunk_table(main_bins, Sv, Sv)
    rows = {}
    print(f"    B1v at the {main_name} against its bound and its plain version (kernel ms: the script's device time "
          f"per launch; n_isects {main_bins.n_isects}, {len(table.chunk_tile)} chunks of capacity {V.CAPACITY}):")
    for mode in V.MODES:
        ms = slope[mode]["kernel_ms"]
        run = V.variant_plain_run(mode, *main_args, main_bins, Sv, Sv, table=table)
        plain_ms = time_ms(lambda: V.variant_plain_run(mode, *main_args, main_bins, Sv, Sv, table=table),
                           iters=3, warmup=1)
        bound, by, work = variant_bound(mode, run, main_args, main_bins, table, Sv, Sv)
        rows[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        print(f"    {mode}: {ms:.4f} ms; bound {bound:.5f} ms ({by}), {bound / ms:.3f} of it; every walked pair's "
              f"bound {work['walked_bound_ms']:.5f} ms ({work['walked_bound_by']}); plain {plain_ms:.4f} ms; work {work}")
    return dict(rows=rows, errs=errs, launches=counts, b2c_launches=b2)


VARIANT_SOURCES = ("blend_fwd", "blend_variants")
VARIANT_LAUNCHES = 20  # calls in each device-time window of --variants


def variant_rows(scenes) -> dict:
    """B1 and B1v per mode, each alone by device time (``kernel_time_ms``,
    ``VARIANT_LAUNCHES`` calls a window) with the SM clock read before and
    after, at each of ``scenes`` ((name, inputs, bins, modes) at S²), against
    its bound (B1v: both, ``variant_bound``); then each mode's difference
    from ``base`` as a share of ``base``, and ``base`` over B1."""
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V
    from gaussctrl_exp_tpu_torch.scripts.bench_blend_variants import B1_KERNEL, variant_kernel_name
    from gaussctrl_exp_tpu_torch.utils.timing import gpu_clocks, kernel_time_ms

    rows = {}
    for scene, args, bins, modes in scenes:
        table = V.bins_chunk_table(bins, S, S, max(V.CAPACITY, bins.n_isects))
        ms = {}
        for mode in ("B1", *modes):
            if mode == "B1":
                def fn():
                    return blend_cuda.blend_forward(*args, bins, S, S)
                match = B1_KERNEL
            else:
                def fn():
                    return V.blend_variant(mode, *args, bins, S, S, table=table)
                match = variant_kernel_name(mode)
            before = gpu_clocks()
            ms[mode] = kernel_time_ms(fn, match, VARIANT_LAUNCHES)
            after = gpu_clocks()
            if mode == "B1":
                bound, by, work = blend_bound(args, bins, S, S)
                walked = ""
            else:
                run = V.variant_plain_run(mode, *args, bins, S, S, table=table)
                bound, by, work = variant_bound(mode, run, args, bins, table, S, S)
                walked = (f"; every walked pair's bound {work['walked_bound_ms']:.5f} ms ({work['walked_bound_by']}), "
                          f"time / bound {ms[mode] / work['walked_bound_ms']:.2f}")
            print(f"  {scene} {mode}: {ms[mode]:.4f} ms device time per launch; bound {bound:.5f} ms ({by}), time / "
                  f"bound {ms[mode] / bound:.2f}{walked}; work {work}; clock before {clock_text(before)}, after "
                  f"{clock_text(after)}")
            rows[(scene, mode)] = dict(ms=ms[mode], bound_ms=bound, bound_by=by, **work)
        shares = ", ".join(f"{m} {(ms[m] - ms['base']) / ms['base']:+.3f}" for m in modes if m != "base")
        print(f"    {scene}: each mode's difference from base as a share of base: {shares}; base / B1 "
              f"{ms['base'] / ms['B1']:.3f}")
    return rows


def variants_only(dev) -> int:
    """``--variants``: kernels B1 and B1v built (their registers and spills
    per mode), checked as in phase 16 (``variant_checks``), then B1 and B1v
    per mode timed alone (``variant_rows``) at the variant script's scene and,
    base and nomatmul, the garden frame, for a before/after comparison of
    B1v within one chip call. Prints no kernels line and no result."""
    from gaussctrl_exp_tpu_torch.cli import render as cli
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V
    from gaussctrl_exp_tpu_torch.ops import cuda_build
    from gaussctrl_exp_tpu_torch.utils.timing import spare_launches

    print(f"{smi_line()}; {VARIANT_LAUNCHES} calls a window")
    t0 = time.perf_counter()
    cuda_build.build(VARIANT_SOURCES)
    print(f"built B1 and B1v in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)})")
    print_ptxas(VARIANT_SOURCES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, path_json = write_inputs(Path(tmp), synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5))
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
        cam0 = cli.path_cameras(path_json, device=dev)[0]
    cases = blend_cases(dev, state, cam0, synthetic_params(N_GARDEN, 7, 1.2, -5.3, 0.4))
    _, (main_name, main_args, main_bins) = variant_checks(dev, cases["odd"], cases["garden"])
    print("[16] B1 and B1v alone, by device time")
    variant_rows([(main_name, main_args, main_bins, V.MODES),
                  (f"garden {N_GARDEN} {S}²", *cases["garden"], ("base", "nomatmul"))])
    print(f"spare launches a profiled cycle at the end {spare_launches()}")
    return 0


def edit_only(dev) -> int:
    """``--edit``: phases 9 to 11 alone: B3 checked, the edit path at full
    width in bf16 on the bear-scale scene's 6 views (with its checks), then
    its stages, a generation step's device time and B3's share, and B3 alone,
    for a before/after comparison of the edit path within one chip call.
    Prints no kernels line and no result."""
    from gaussctrl_exp_tpu_torch.cli import render as cli
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
    from gaussctrl_exp_tpu_torch.ops import cuda_build
    from gaussctrl_exp_tpu_torch.utils.timing import spare_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    t0 = time.perf_counter()
    cuda_build.build(BLEND_SOURCES + ATTENTION_SOURCES)
    print(f"built B1 to B5 in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, path_json = write_inputs(Path(tmp), synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5))
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
        cams = cli.path_cameras(path_json, device=dev)
    model = SplatModelConfig(sh_degree=3, sh_degree_interval=10, background_color="white")  # phase 7's
    with torch.no_grad():
        targets = [render_model(state, c, cli.EVAL_STEP, model).rgb.contiguous() for c in cams]
    _, flash_cases = phase9_flash(dev)
    edit = phase10_edit(dev, state, cams, targets)
    phase11_timings(dev, state, cams, edit, flash_cases)
    print(f"spare launches a profiled cycle at the end {spare_launches()}")
    return 0


# ---------------------------------------------------------------- phase 17

# the full-width bf16 gradient through B3/B4/B5 against the same step through
# sdpa_plain: both run the whole UNet in bf16, and the two attentions round
# differently (sdpa_plain rounds its scores to bf16, the kernels keep them in
# fp32). On the tests' tiny generator on the CPU, moving only the attention's
# roundings (sdpa_plain in bf16 against fp32 attention rounded to bf16) moved
# the gradient by 2.0-2.2e-2 relative L2 and the loss by 4e-5 relative; the
# limits leave 5× for the full width's depth
MV_BF16_GRAD_REL_L2 = 1e-1
MV_BF16_LOSS_REL = 1e-3
MV_BF16_SEED = 17  # the fixed step's timesteps and noise, and (18) the 3 steps' draws


def phase17_mv_bf16(dev, cams, depths, x0, ctx) -> dict:
    """The depth generator at full SD1.x width trained in bf16, as the JAX
    package's ``init_depth_generator(dtype=jnp.bfloat16)`` trains it: float32
    parameters and Adam state, the UNet computing in bf16. One step's
    gradient through B3/B4/B5 against the same step through sdpa_plain; 3
    Adam steps of ``train_step`` with B3, B4 and B5 launches read around
    them and the peak memory; the step by stage and by device time with B4 +
    B5's share of the backward (phase 15's way)."""
    from gaussctrl_exp_tpu_torch.diffusion.mv_generator import MVGeneratorConfig, init_depth_generator

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    gen = init_depth_generator(SD_SEED, cfg=MVGeneratorConfig(latent_size=S // 8), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in gen.unet.parameters())
    dtypes = {p.dtype for p in gen.unet.parameters()}
    proc, dl, pair_mask = gen.prepare(depths, cams)
    print(f"[17] depth generator trained in bf16 (init_depth_generator(dtype=torch.bfloat16)): {n_params:,} "
          f"parameters (expected {MV_PARAMS:,}) of {sorted(str(d) for d in dtypes)}, the UNet computing in "
          f"{gen.unet.compute_dtype}; made in {made_s:.2f} s on {base_gb:.2f} GB already allocated; pair mask "
          f"{pair_mask.tolist()}")
    if n_params != MV_PARAMS or dtypes != {torch.float32} or gen.unet.compute_dtype != torch.bfloat16:
        raise SystemExit("FAIL: the bf16 depth generator has the wrong size, or parameters that are not float32")

    # one step's gradient through the kernels against the same step through sdpa_plain
    g = torch.Generator(device=dev).manual_seed(MV_BF16_SEED)
    t_fix = torch.randint(0, 1000, (MV_V,), generator=g, device=dev)
    noise_fix = torch.randn(x0.shape, generator=g, device=dev)
    zero_counts()
    loss_k = gen.loss(x0, dl, ctx, t_fix, noise_fix, proc)
    loss_k.backward()
    torch.cuda.synchronize()
    grad_launches = counts()
    g_kernel = {n: p.grad.detach().clone() for n, p in gen.unet.named_parameters()}
    grad_dtypes = {p.grad.dtype for p in gen.unet.parameters()}
    gen.unet.zero_grad(set_to_none=True)
    zero_counts()
    with attention_through_plain() as plain_calls:
        loss_p = gen.loss(x0, dl, ctx, t_fix, noise_fix, proc)
        loss_p.backward()
    torch.cuda.synchronize()
    total_rel, groups = grad_groups(g_kernel, {n: p.grad for n, p in gen.unet.named_parameters()})
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"    one step at t = {t_fix.tolist()}: loss through B3/B4/B5 {loss_k.item():.7f}, through sdpa_plain "
          f"{loss_p.item():.7f} (relative {loss_rel:.2e}, limit {MV_BF16_LOSS_REL}); launches (B3, B4, B5) "
          f"{grad_launches} vs {counts()} and {plain_calls[0]} sdpa_plain calls; gradients {sorted(map(str, grad_dtypes))}, "
          f"relative L2 {total_rel:.3e} (limit {MV_BF16_GRAD_REL_L2}); per block "
          + ", ".join(f"{k} {v:.2e}" for k, v in groups.items()))
    if total_rel > MV_BF16_GRAD_REL_L2 or loss_rel > MV_BF16_LOSS_REL or counts() != (0, 0, 0) \
            or min(grad_launches) == 0 or grad_dtypes != {torch.float32}:
        raise SystemExit("FAIL: the full-width bf16 gradient through the kernels disagrees with sdpa_plain's")
    del g_kernel
    gen.unet.zero_grad(set_to_none=True)

    # the main path: 3 Adam steps, launches counted; the start kept on the host
    opt = torch.optim.Adam(gen.unet.parameters(), lr=MV_LR)
    step = gen.make_train_step(opt, proc)
    before = {n: p.detach().to("cpu", copy=True) for n, p in gen.unet.named_parameters()}
    n_attn = 2 * count_transformers(gen.unet)
    draws = torch.Generator(device=dev).manual_seed(MV_BF16_SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [float(step(x0, dl, ctx, draws)) for _ in range(MV_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v) and v.dim() > 0]
    state_dtypes = {v.dtype for v in state}
    n_moved, moved = 0, {}
    for n, p in gen.unet.named_parameters():
        d = p.detach().cpu() - before[n]
        n_moved += int((d != 0).sum())
        key = "_".join(n.split(".")[0].split("_")[:2]) if n.startswith(("down", "up")) else n.split("_")[0]
        moved[key] = max(moved.get(key, 0.0), float(d.abs().max()))
    del before
    print(f"    {MV_TRAIN_STEPS} Adam({MV_LR}) steps of train_step ({MV_V} views, 64² latents): losses "
          f"{[round(x, 6) for x in losses]} in {train_wall:.3f} s host wall (first step included); launches "
          f"B3 {launches[0]}, B4 {launches[1]}, B5 {launches[2]} (expected {MV_TRAIN_STEPS * n_attn} each); "
          f"parameters {sorted(str(d) for d in {p.dtype for p in gen.unet.parameters()})}, "
          f"Adam state {len(state)} tensors of {sorted(map(str, state_dtypes))}; entries moved {n_moved:,} of "
          f"{n_params:,}; peak device memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated, {base_gb:.2f} GB "
          f"allocated before the generator was made); largest |Δ| per block "
          + ", ".join(f"{k} {v:.1e}" for k, v in moved.items()))
    if launches != (MV_TRAIN_STEPS * n_attn,) * 3 or not all(np.isfinite(losses)) or min(moved.values()) <= 0 \
            or state_dtypes != {torch.float32} or len(state) != 2 * len(list(gen.unet.parameters())) \
            or {p.dtype for p in gen.unet.parameters()} != {torch.float32}:
        raise SystemExit("FAIL: the bf16 train steps skipped a kernel, gave a non-finite loss, left a block "
                         "unmoved or kept parameters or Adam state in another type than float32")

    timed = step_timings(gen, opt, (x0, dl, ctx, t_fix, noise_fix, proc))
    print(f"    timings (CUDA events, warm). Depth generator train step, bf16 UNet, fp32 parameters, {MV_V} views "
          f"at 64²: " + step_text(timed))
    return dict(launches=launches, peak_gb=peak_gb, step=timed, train_wall=train_wall)


def generator_only(dev) -> int:
    """``--generator``: phase 17 alone, on 4 views of the bear-scale scene
    rendered through B1 and seeded random clean latents and text states in
    place of the VAE's and the text encoder's, for a before/after
    comparison of the bf16 generator step within one chip call. Prints no
    kernels line and no result."""
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.ops import cuda_build
    from gaussctrl_exp_tpu_torch.utils.timing import spare_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"built in {time.perf_counter() - t0:.2f} s")
    print_ptxas(("flash_attn_bwd",))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt, _ = write_inputs(Path(tmp), synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5))
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
    cams, _, depths = mv_views(state, dev)
    g = torch.Generator(device=dev).manual_seed(MV_BF16_SEED + 2)
    x0 = torch.randn((MV_V, S // 8, S // 8, 4), generator=g, device=dev)
    ctx = torch.randn((MV_V, 77, 768), generator=g, device=dev)
    phase17_mv_bf16(dev, cams, depths, x0, ctx)
    print(f"spare launches a profiled cycle at the end {spare_launches()}")
    return 0


# ---------------------------------------------------------------- phase 18

SCENE_VIEWS = 96  # the bear scene: 96 frames at 512² (SURVEY.md), subset to 4 × 10 = 40
CLI_STEPS = 60
CLI_EVAL_EVERY = 30  # eval image, evaluate() and a checkpoint every 30 steps
SEED_STEPS = 30
CARD_CPU_DOWNSCALE = 4  # step 1, card against CPU, at 128² through the box filter
# step 1's l1, ssim and psnr, card vs the plain path on the CPU: the same
# images and start, summed in another order (phase 7 holds the step's loss
# to 1e-5 and its gradients to 1e-3)
CARD_CPU_RTOL = 1e-4
# small OPENCV coefficients of the bear scene's kind (k1, k2, p1, p2)
BEAR_OPENCV = {"k1": 0.012, "k2": -0.0041, "p1": 0.00052, "p2": -0.00031}


def scene_c2w(i, n):
    """(4, 4) pose i of n on an orbit at the target's height: every camera's
    up is +z exactly, so the dataparser's orientation is the identity."""
    from gaussctrl_exp_tpu_torch.cameras import look_at

    ang = 2 * np.pi * i / n
    c2w = look_at([4.0 * np.sin(ang), -4.0 * np.cos(ang), 0.0], np.zeros(3))
    return np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]]).astype(np.float32)


def to_parsed_frame(arrays, transform, scale):
    """Splatfacto parameters moved into the dataparser's frame (as a
    checkpoint trained on the parsed scene holds them): means through the
    transform and the scale, as the dataparser moves the seed points, log
    scales + log(scale). The transform's rotation must be the identity, so
    quaternions and SH stay."""
    if not np.array_equal(transform[:3, :3], np.eye(3, dtype=np.float32)):
        raise SystemExit(f"FAIL: the scene's dataparser rotation is not the identity: {transform}")
    out = dict(arrays)
    out["means"] = ((arrays["means"] @ transform[:3, :3].T + transform[:3, 3]) * scale).astype(np.float32)
    out["scales"] = (arrays["scales"] + np.log(scale)).astype(np.float32)
    return out


def write_bear_scene(dev, bear, root: Path):
    """The bear-shaped scene on disk, without PIL: ``SCENE_VIEWS`` PNG
    frames at S² rendered by B1 from ``bear`` moved into the parsed frame,
    a ``transforms.json`` with global intrinsics and a binary
    ``sparse_pc.ply`` of the bear's means and colours. Returns (frames
    (uint8), the parsed outputs, the bear in the parsed frame)."""
    from gaussctrl_exp_tpu_torch.cameras import make_camera
    from gaussctrl_exp_tpu_torch.cli.render import EVAL_STEP
    from gaussctrl_exp_tpu_torch.data.dataparser import DataParserConfig, load_scene
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
    from gaussctrl_exp_tpu_torch.ops.sh import SH_C0
    from gaussctrl_exp_tpu_torch.utils.png import write_png

    (root / "images").mkdir(parents=True)
    f = S / (2 * np.tan(np.deg2rad(FOV_DEG) / 2))
    frames = [{"file_path": f"images/frame_{i + 1:05d}.png", "transform_matrix": scene_c2w(i, SCENE_VIEWS).tolist()}
              for i in range(SCENE_VIEWS)]
    meta = {"w": S, "h": S, "fl_x": f, "fl_y": f, "cx": S / 2, "cy": S / 2, "camera_model": "OPENCV",
            "ply_file_path": "sparse_pc.ply", "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    rgb = np.clip((bear["features_dc"] * SH_C0 + 0.5) * 255, 0, 255).astype(np.uint8)
    rec = np.zeros(len(rgb), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = bear["means"].T
    rec["red"], rec["green"], rec["blue"] = rgb.T
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(rec)}\n"
            + "".join(f"property {t} {n}\n" for t, n in [("float", "x"), ("float", "y"), ("float", "z"),
                                                         ("uchar", "red"), ("uchar", "green"), ("uchar", "blue")])
            + "end_header\n")
    (root / "sparse_pc.ply").write_bytes(head.encode() + rec.tobytes())

    parsed = load_scene(DataParserConfig(data=root))
    bear_p = to_parsed_frame(bear, parsed.dataparser_transform, parsed.dataparser_scale)
    state = GaussianState(params_from_numpy(bear_p, dev), torch.ones(len(rgb), dtype=torch.bool, device=dev))
    c = parsed.cameras
    cfg = SplatModelConfig(background_color="white")
    images = []
    with torch.no_grad():
        for i, path in enumerate(parsed.image_filenames):
            cam = make_camera(c.c2w[i], c.fx[i], c.fy[i], c.cx[i], c.cy[i], c.width, c.height, device=dev)
            img = (render_model(state, cam, EVAL_STEP, cfg).rgb.clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
            write_png(path, img)
            images.append(img)
    return images, parsed, bear_p


def events_of(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "logs" / "events.jsonl").read_text().splitlines()]


def phase18_train_cli(dev, bear, tmp: Path) -> dict:
    """The scene loader, the training CLI and ``render dataset`` on a
    96-frame bear-scale PNG scene: the DataManager's 4 × 10 subset and its
    images, an OPENCV copy's undistortion, ``cli.train.main`` from the
    perturbed checkpoint (B1 and B2 launches read around it, checkpoint
    round trip) and from the seed cloud, ``cli.render dataset`` on the saved
    checkpoint, and step 1 on the card against the CPU at 128²."""
    from gaussctrl_exp_tpu_torch.cli import render as render_cli
    from gaussctrl_exp_tpu_torch.cli import train as train_cli
    from gaussctrl_exp_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from gaussctrl_exp_tpu_torch.data.dataparser import DataParserConfig
    from gaussctrl_exp_tpu_torch.data.undistort import optimal_new_K
    from gaussctrl_exp_tpu_torch.engine import trainer as ttr
    from gaussctrl_exp_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES, GaussianState
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.utils.timing import device_window

    smi = smi_line()
    scene = tmp / "bear_scene"
    t0 = time.perf_counter()
    images, parsed, bear_p = write_bear_scene(dev, bear, scene)
    print(f"[18] wrote a {SCENE_VIEWS}-frame {S}² PNG scene (B1 renders, write_png) in "
          f"{time.perf_counter() - t0:.2f} s; dataparser scale {parsed.dataparser_scale:.6f}, translation "
          f"{parsed.dataparser_transform[:, 3].tolist()}; {smi}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm = DataManager(DataManagerConfig(dataparser=DataParserConfig(data=scene)), device=dev)
    dm_s = time.perf_counter() - t0
    if len(dm) != 40 or len(set(dm.view_indices)) != 40:
        raise SystemExit(f"FAIL: the DataManager kept {len(dm)} of {SCENE_VIEWS} views, expected 40")
    for k, gi in enumerate(dm.view_indices):
        if not np.array_equal(dm.images[k], images[gi].astype(np.float32) / 255.0):
            raise SystemExit(f"FAIL: view {k} (frame {gi + 1}) is not its PNG's bytes / 255")
        if dm.camera(k).c2w.device.type != dev.type:
            raise SystemExit(f"FAIL: camera {k} is on {dm.camera(k).c2w.device}")
    print(f"    DataManager: {len(dm)} of {SCENE_VIEWS} views (4 × 10) at {dm.width}×{dm.height}, images equal "
          f"their PNG bytes / 255, cameras on {dev}; build {dm_s:.3f} s host wall ({SCENE_VIEWS} PNG decodes + "
          f"subsetting); view indices {dm.view_indices[:6]}…")

    distorted = tmp / "bear_scene_opencv"
    distorted.mkdir()
    (distorted / "images").symlink_to(scene / "images")
    meta = json.loads((scene / "transforms.json").read_text())
    meta.update(BEAR_OPENCV)
    del meta["ply_file_path"]
    (distorted / "transforms.json").write_text(json.dumps(meta))
    t0 = time.perf_counter()
    dmd = DataManager(DataManagerConfig(dataparser=DataParserConfig(data=distorted)), device=dev)
    dmd_s = time.perf_counter() - t0
    c = dmd.parsed.cameras
    K = np.array([[c.fx[0], 0, c.cx[0]], [0, c.fy[0], c.cy[0]], [0, 0, 1]], np.float64)
    dist6 = [BEAR_OPENCV.get(k, 0.0) for k in ("k1", "k2", "k3", "k4", "p1", "p2")]
    newK, roi = optimal_new_K(K, np.asarray(c.distortion[0], np.float64), S, S)
    want = np.float32([newK[0, 0], newK[1, 1], newK[0, 2] - roi[0], newK[1, 2] - roi[1]])
    got = np.float32([dmd.fx[0], dmd.fy[0], dmd.cx[0], dmd.cy[0]])
    if not np.array_equal(got, want) or (dmd.width, dmd.height) != roi[2:] or \
            not np.allclose(c.distortion[0], np.float32(dist6)):
        raise SystemExit(f"FAIL: the OPENCV scene's intrinsics {got} / {dmd.width}×{dmd.height} are not "
                         f"optimal_new_K's {want} / {roi}")
    print(f"    OPENCV copy {BEAR_OPENCV}: new K fx {got[0]:.4f} fy {got[1]:.4f} cx {got[2]:.4f} cy {got[3]:.4f}, "
          f"ROI {roi} as data/undistort.optimal_new_K gives; build {dmd_s:.3f} s host wall (decode + native remap)")

    pert = perturbed(bear, 1)  # phase 7's perturbation, in the parsed frame
    pert_ckpt = tmp / "bear_scene_perturbed.ckpt"
    save_splatfacto(pert_ckpt, to_parsed_frame(pert, parsed.dataparser_transform, parsed.dataparser_scale))
    runs = tmp / "runs"
    common = ["--data", str(scene), "--output-dir", str(runs), "--capacity", str(TRAIN_CAPACITY),
              "--train.use-lpips", "False", "--train.model.background-color", "white"]

    # ---- the CLI from the perturbed checkpoint, with each train step's CUDA events
    steps: list = []
    real_make = ttr.make_train_step

    def timed_make(*a, **k):
        step = real_make(*a, **k)

        def timed(*sa, **sk):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(*sa, **sk)
            e1.record()
            steps.append((e0, e1))
            return out

        return timed

    argv = common + ["--device", dev.type, "--experiment-name", "from_ckpt", "--load-checkpoint", str(pert_ckpt),
                     "--max-num-iterations", str(CLI_STEPS), "--pipeline.render-rate", str(CLI_STEPS),
                     "--steps-per-eval-image", str(CLI_EVAL_EVERY), "--steps-per-save", str(CLI_EVAL_EVERY)]
    ttr.make_train_step = timed_make
    try:
        blend_cuda.launches = blend_cuda.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
        cli_launches = (blend_cuda.launches, blend_cuda.bwd_launches)
    finally:
        ttr.make_train_step = real_make
    n_eval = CLI_STEPS // CLI_EVAL_EVERY
    want_b1 = CLI_STEPS + n_eval * (1 + len(trainer.dm.eval_indices()))
    step_ms = [e0.elapsed_time(e1) for e0, e1 in steps]
    mean_step = float(np.mean(step_ms[1:]))
    ev = events_of(runs / "from_ckpt")
    loss = {e["step"]: e["main_loss"] for e in ev if "main_loss" in e}
    psnrs = [e["eval_psnr"] for e in ev if "eval_psnr" in e]
    print(f"    cli.train from the perturbed checkpoint: {CLI_STEPS} steps at {trainer.dm.width}² in {cli_wall:.2f} s "
          f"host wall (data, eval and checkpoints included); blend_fwd launches {cli_launches[0]} (= {CLI_STEPS} "
          f"steps + {n_eval} × (1 eval image + {len(trainer.dm.eval_indices())} evaluate views)), blend_bwd "
          f"launches {cli_launches[1]}; main_loss {loss}; eval_psnr {psnrs}")
    if cli_launches != (want_b1, CLI_STEPS) or len(steps) != CLI_STEPS:
        raise SystemExit(f"FAIL: launches {cli_launches}, expected ({want_b1}, {CLI_STEPS}); {len(steps)} steps timed")
    if not (1 in loss and 50 in loss and loss[50] < loss[1]):
        raise SystemExit(f"FAIL: main_loss did not fall from step 1 to step 50: {loss}")
    if len(psnrs) != n_eval or not psnrs[1] > psnrs[0]:
        raise SystemExit(f"FAIL: the second eval's psnr is not above the first's: {psnrs}")
    ckpts = runs / "from_ckpt" / "ckpts"
    if [p.name for p in ckpts.iterdir()] != [f"step-{CLI_STEPS:09d}"]:
        raise SystemExit(f"FAIL: checkpoints {sorted(p.name for p in ckpts.iterdir())}")
    st = trainer.state

    def example():
        return ttr.init_train_state(GaussianState(st.params, st.alive), trainer.cfg, num_views=len(trainer.dm))

    restored, step = load_checkpoint(ckpts, example(), dev)
    if step != CLI_STEPS or not all(torch.equal(getattr(restored.params, n), getattr(st.params, n))
                                    for n in PARAM_NAMES) or not torch.equal(restored.alive, st.alive):
        raise SystemExit("FAIL: load_checkpoint did not restore the trained parameters bit for bit")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev_metrics = trainer.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    saved = save_checkpoint(tmp / "ckpt_timing", st, trainer.step)
    save_s = time.perf_counter() - t0
    fresh = example()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_checkpoint(saved, fresh, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size_mb = sum(p.stat().st_size for p in saved.iterdir()) / 2**20
    win = device_window(lambda: trainer.train(1, log_every=10**9), calls=5)
    print(f"    step (CUDA events around train_step, steps 2-{CLI_STEPS}): mean {mean_step:.4f} ms, min "
          f"{min(step_ms[1:]):.4f}, max {max(step_ms[1:]):.4f}; the CLI loop's step (Trainer.train(1): sampling, "
          f"upload, step) by torch.profiler over {win['calls']} steps: wall {win['wall_ms'] / win['calls']:.4f} ms, "
          f"device time {win['device_ms']:.4f} ms in {win['ops']:.0f} ops, {busy_text(win)}")
    print(f"    one eval pass (evaluate(), {len(trainer.dm.eval_indices())} views): {eval_ms:.3f} ms host wall; "
          + " ".join(f"{k} {v:.4f}" for k, v in ev_metrics.items()))
    print(f"    checkpoint ({size_mb:.1f} MiB, capacity {TRAIN_CAPACITY}): save {save_s * 1e3:.1f} ms, load "
          f"{load_s * 1e3:.1f} ms host wall; load_checkpoint restored step {step} bit for bit")

    # ---- the CLI from the seed cloud
    blend_cuda.launches = blend_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    seeded = train_cli.main(common + ["--device", dev.type, "--experiment-name", "from_seed",
                                      "--max-num-iterations", str(SEED_STEPS), "--pipeline.render-rate",
                                      str(SEED_STEPS), "--steps-per-eval-image", str(SEED_STEPS)])
    torch.cuda.synchronize()
    seed_wall = time.perf_counter() - t0
    seed_launches = (blend_cuda.launches, blend_cuda.bwd_launches)
    n_seed = int(seeded.state.alive.sum())
    h = seeded.history
    print(f"    cli.train from the seed ply: {n_seed} gaussians, {SEED_STEPS} steps in {seed_wall:.2f} s host wall "
          f"(knn init included); launches {seed_launches}; main_loss step 1 {h[0]['main_loss']:.5f}")
    if n_seed != len(bear["means"]) or seed_launches != (SEED_STEPS + 1 + len(seeded.dm.eval_indices()), SEED_STEPS) \
            or not np.isfinite(h[0]["main_loss"]):
        raise SystemExit(f"FAIL: the seed-cloud run: {n_seed} gaussians, launches {seed_launches}")

    # ---- render dataset on the saved checkpoint
    blend_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = render_cli.main(["dataset", "--data", str(scene), "--ckpt", str(ckpts), "--out", str(tmp / "dataset"),
                              "--device", dev.type])
    torch.cuda.synchronize()
    ds_ms = (time.perf_counter() - t0) * 1e3 / SCENE_VIEWS
    ds_launches = blend_cuda.launches
    depths = sorted((scene / "depth_npy").glob("frame_*.npy"))
    d0 = np.load(depths[0])
    print(f"    render dataset: {len(frames)} frames, {len(depths)} depth_npy files ({d0.shape}, {d0.dtype}), "
          f"blend_fwd launches {ds_launches}; {ds_ms:.3f} ms per frame host wall (PNG encode and npy write included)")
    if len(frames) != SCENE_VIEWS or len(depths) != SCENE_VIEWS or ds_launches != SCENE_VIEWS or \
            d0.shape != (S, S) or not np.isfinite(d0).all():
        raise SystemExit("FAIL: render dataset did not write 96 frames and depth sidecars with 96 launches")

    # ---- step 1, card against CPU, at 128² through the box filter
    small = common + ["--load-checkpoint", str(pert_ckpt), "--max-num-iterations", "1", "--pipeline.render-rate", "1",
                      "--steps-per-eval-image", "1", "--datamanager.dataparser.downscale-factor", str(CARD_CPU_DOWNSCALE)]
    card = train_cli.main(small + ["--device", dev.type, "--experiment-name", "step1_card"]).history[0]
    cpu = train_cli.main(small + ["--device", "cpu", "--experiment-name", "step1_cpu"]).history[0]
    rels = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("l1", "ssim", "psnr", "main_loss")}
    print(f"    step 1 at {S // CARD_CPU_DOWNSCALE}², card vs CPU plain path: "
          + " ".join(f"{k} {card[k]:.7f} / {cpu[k]:.7f} (rel {rels[k]:.2e})" for k in rels))
    if max(rels[k] for k in ("l1", "ssim", "psnr")) > CARD_CPU_RTOL:
        raise SystemExit("FAIL: the CLI's step 1 on the card disagrees with the CPU's")
    return dict(b1_cli=cli_launches[0], b2_cli=cli_launches[1], b1_dataset=ds_launches, step_ms=mean_step,
                busy=win["busy"])


def train_cli_only(dev) -> int:
    """``--train-cli``: phase 18 alone (kernels B1 and B2 built). Prints no
    kernels line and no result."""
    from gaussctrl_exp_tpu_torch.ops import cuda_build

    print(smi_line())
    t0 = time.perf_counter()
    cuda_build.build(BLEND_SOURCES)
    print(f"built B1 and B2 in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase18_train_cli(dev, synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5), Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 19

SEG_OBJ = "bear"  # the reference's scripts/bear.sh object
SEG_FINETUNE_STEPS = 20  # a short fine-tune after the edit (eval and save at its end)
SAM_SEED, CLIP_SEED, SAM_B_SEED = 19, 20, 21
SEG_TIMING_ITERS = 5
# card vs CPU, LangSAM.predict at ViT-B width, fp32 on both sides with TF32
# off for matmuls and cuDNN: the low-res logits may differ by this share of
# their largest magnitude (summation order over 12 blocks; the tests see
# 5e-7 at tiny widths), and a mask only where the CPU's upsampled logit is
# within this share of it of 0
SEG_LOGIT_REL = 1e-3
SEG_MASK_MARGIN = 1e-3
# openai/clip-vit-large-patch14's text tower, as its config.json gives it
CLIP_L_TEXT = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                   num_attention_heads=12, max_position_embeddings=77, layer_norm_eps=1e-5)
CLIP_L_PROJECTION = 768


def seeded_(model: torch.nn.Module, seed: int, embed_std: float) -> torch.nn.Module:
    """Fill every parameter and buffer of a SAM or CLIP from ``seed`` on its
    device: Linear and conv weights normal over √fan-in (a transposed conv's
    fan-in is its input channels), biases 0.01, norms 1 and 0, embedding
    tables ``embed_std`` (SAM's 1, CLIP's 0.02), SAM's positional gaussian
    1, the rest (positional embeddings, relative-position tables, CLIP's
    class embedding) 0.02."""
    from gaussctrl_exp_tpu_torch.segmentation.sam import LayerNorm2d

    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    done = set()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, LayerNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w.shape[0] if isinstance(mod, torch.nn.ConvTranspose2d) else w[0].numel()
                w.normal_(0.0, fan_in**-0.5, generator=gen)
                if mod.bias is not None:
                    mod.bias.normal_(0.0, 0.01, generator=gen)
            elif isinstance(mod, torch.nn.Embedding):
                mod.weight.normal_(0.0, embed_std, generator=gen)
            else:
                continue
            done.update(id(p) for p in mod.parameters(recurse=False))
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if id(t) in done:
                continue
            t.normal_(0.0, 1.0 if name.endswith("gaussian_matrix") else 0.02, generator=gen)
    return model


def random_sam(cfg, seed: int, dev):
    from gaussctrl_exp_tpu_torch.segmentation.sam import SAM

    with torch.device("meta"):
        m = SAM(cfg)
    return seeded_(m.to_empty(device=dev), seed, embed_std=1.0).eval()


def write_sam_checkpoint(dev, path: Path):
    """A SAM at ``SAMConfig()``'s ViT-H widths from ``SAM_SEED``, saved as
    segment_anything's ``.pth`` holds it: its state dict with the pixel
    statistics and the mask-input downscaler (which neither package
    uses)."""
    from gaussctrl_exp_tpu_torch.segmentation.sam import PIXEL_MEAN, PIXEL_STD, SAMConfig

    sam = random_sam(SAMConfig(), SAM_SEED, dev)
    sd = {k: v.detach().cpu() for k, v in sam.state_dict().items()}
    n_params = sum(p.numel() for p in sam.parameters())
    del sam
    gen = torch.Generator().manual_seed(SAM_SEED)
    for i, shape in {0: (4, 1, 2, 2), 1: (4,), 3: (16, 4, 2, 2), 4: (16,), 6: (256, 16, 1, 1)}.items():
        sd[f"prompt_encoder.mask_downscaling.{i}.weight"] = torch.randn(shape, generator=gen)
        sd[f"prompt_encoder.mask_downscaling.{i}.bias"] = torch.randn(shape[0], generator=gen)
    sd["pixel_mean"] = torch.as_tensor(PIXEL_MEAN).reshape(3, 1, 1)
    sd["pixel_std"] = torch.as_tensor(PIXEL_STD).reshape(3, 1, 1)
    torch.save(sd, str(path))
    return n_params


def write_clip_checkpoint(dev, root: Path):
    """A CLIP at openai/clip-vit-large-patch14's widths from ``CLIP_SEED``
    as a transformers directory: ``config.json``, ``pytorch_model.bin`` (with
    the ``position_ids`` buffers such checkpoints hold) and the port's
    miniature ``vocab.json``/``merges.txt``."""
    from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig
    from gaussctrl_exp_tpu_torch.diffusion.tokenizer import make_test_vocab
    from gaussctrl_exp_tpu_torch.segmentation.clip_vision import CLIPModel, CLIPVisionConfig

    vision = CLIPVisionConfig()
    with torch.device("meta"):
        m = CLIPModel(CLIPTextConfig(**CLIP_L_TEXT), vision, CLIP_L_PROJECTION, eos_token_id=2)
    m = seeded_(m.to_empty(device=dev), CLIP_SEED, embed_std=0.02)
    sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    n_params = sum(p.numel() for p in m.parameters())
    del m
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd["vision_model.embeddings.position_ids"] = torch.arange(vision.grid**2 + 1)[None]
    root.mkdir()
    torch.save(sd, str(root / "pytorch_model.bin"))
    cfg = {"architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": CLIP_L_PROJECTION,
           "logit_scale_init_value": 2.6592,
           "text_config": {**CLIP_L_TEXT, "hidden_act": "quick_gelu", "bos_token_id": 0, "eos_token_id": 2,
                           "pad_token_id": 1, "projection_dim": CLIP_L_PROJECTION},
           "vision_config": {**{f: getattr(vision, f) for f in vision.__dataclass_fields__},
                             "hidden_act": "quick_gelu", "num_channels": 3, "projection_dim": CLIP_L_PROJECTION}}
    (root / "config.json").write_text(json.dumps(cfg, indent=2))
    vocab, merges = make_test_vocab()
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return n_params


def phase19_segment(dev, bear, tmp: Path) -> dict:
    """``cli.train`` with the edit phase and live segmentation at SAM ViT-H
    and CLIP ViT-L/14 widths (seeded random weights written as the files
    the CLI loads) and the full-width bf16 SD1.x stack, on the 96-frame
    bear scene (40 views), then a short fine-tune: masks and the composite
    checked, B1, B2 and B3 counted, SAM and CLIP timed, LangSAM card vs CPU
    at ViT-B width."""
    import gaussctrl_exp_tpu_torch.diffusion.convert as sd_convert
    from gaussctrl_exp_tpu_torch.cli import train as train_cli
    from gaussctrl_exp_tpu_torch.data.datamanager import DataManager
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import GaussCtrlEditPipeline
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
    from gaussctrl_exp_tpu_torch.ops import attention_cuda, blend_cuda
    from gaussctrl_exp_tpu_torch.segmentation import clip_vision, lang_sam
    from gaussctrl_exp_tpu_torch.segmentation import convert as seg_convert
    from gaussctrl_exp_tpu_torch.segmentation.grounding import clip_pixels
    from gaussctrl_exp_tpu_torch.segmentation.sam import preprocess_image, upscale_logits, vit_b_config

    smi = smi_line()
    t_phase = time.perf_counter()
    scene = tmp / "seg_scene"
    _, _, bear_p = write_bear_scene(dev, bear, scene)
    ckpt = tmp / "seg_bear.ckpt"
    save_splatfacto(ckpt, bear_p)

    # ---- the checkpoints the slice loads
    sam_pth, clip_dir = tmp / "sam_vit_h_seeded.pth", tmp / "clip_vit_l14_seeded"
    t0 = time.perf_counter()
    n_sam = write_sam_checkpoint(dev, sam_pth)
    sam_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_clip = write_clip_checkpoint(dev, clip_dir)
    clip_save_s = time.perf_counter() - t0
    sam_bytes = sam_pth.stat().st_size
    clip_bytes = sum(p.stat().st_size for p in clip_dir.iterdir())
    print(f"[19] live segmentation through cli.train; {smi}")
    print(f"    SAM ViT-H (1280 wide, 32 blocks, 16 heads, global attention at 7/15/23/31, window 14, 1024²) "
          f"{n_sam:,} parameters, seed {SAM_SEED}: {sam_bytes:,} bytes written as segment_anything's .pth in "
          f"{sam_save_s:.2f} s; CLIP ViT-L/14 (vision 1024 × 24, text 768 × 12, projection 768) {n_clip:,} "
          f"parameters, seed {CLIP_SEED}: {clip_bytes:,} bytes as a transformers directory in {clip_save_s:.2f} s")

    # ---- the full-width bf16 SD1.x stack, handed to the CLI in memory
    models = init_random_models(SD_SEED, dev, torch.bfloat16)
    per_eval = count_transformers(models.unet) + count_transformers(models.controlnet)
    print("    diffusion.convert.load_sd_models replaced for the call: the CLI gets the random-weight full-width "
          f"bf16 SD1.x stack (seed {SD_SEED}) made on the card, no SD checkpoint written")

    seen = {"predict_s": [], "written": {}}
    real = dict(load_sd=sd_convert.load_sd_models, rr=GaussCtrlEditPipeline.render_reverse,
                edit=GaussCtrlEditPipeline.edit_images, write=DataManager.write_back,
                predict=lang_sam.LangSAM.predict, ls_init=lang_sam.LangSAM.__init__, load_clip=clip_vision.load_clip,
                load_sam=seg_convert.load_sam)

    def timed(key, fn):
        def wrapper(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            seen[key] = time.perf_counter() - t
            seen["pipe"] = self
            return out
        return wrapper

    def predict(self, image, text):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["predict"](self, image, text)
        torch.cuda.synchronize()
        seen["predict_s"].append(time.perf_counter() - t)
        seen.setdefault("boxes", []).append(out[1])
        return out

    def ls_init(self, sam, box_provider=None):
        real["ls_init"](self, sam, box_provider)
        seen["langsam"] = self

    def write_back(self, i, image):
        seen["written"][i] = np.asarray(image, np.float32).copy()
        real["write"](self, i, image)

    def loaded(key, fn):  # the CLI's checkpoint load, timed to the weights on the card
        def wrapper(*a, **k):
            t = time.perf_counter()
            seen[key] = fn(*a, **k)
            torch.cuda.synchronize()
            seen[f"{key}_load_s"] = time.perf_counter() - t
            return seen[key]
        return wrapper

    argv = ["--data", str(scene), "--output-dir", str(tmp / "seg_runs"), "--experiment-name", "seg",
            "--device", dev.type, "--load-checkpoint", str(ckpt), "--capacity", str(TRAIN_CAPACITY),
            "--train.use-lpips", "False", "--train.model.background-color", "white",
            "--pipeline.edit-prompt", EDIT_PROMPT, "--pipeline.reverse-prompt", REVERSE_PROMPT,
            "--pipeline.langsam-obj", SEG_OBJ, "--pipeline.sam-ckpt", str(sam_pth),
            "--pipeline.clip-ckpt", str(clip_dir), "--pipeline.num-inference-steps", "20",
            "--max-num-iterations", str(SEG_FINETUNE_STEPS), "--pipeline.render-rate", str(SEG_FINETUNE_STEPS),
            "--steps-per-eval-image", str(SEG_FINETUNE_STEPS), "--steps-per-save", str(SEG_FINETUNE_STEPS)]
    sd_convert.load_sd_models = lambda root, device="cuda", **k: models
    GaussCtrlEditPipeline.render_reverse = timed("reverse_s", real["rr"])
    GaussCtrlEditPipeline.edit_images = timed("edit_s", real["edit"])
    DataManager.write_back = write_back
    lang_sam.LangSAM.predict = predict
    lang_sam.LangSAM.__init__ = ls_init
    clip_vision.load_clip = loaded("clip", real["load_clip"])
    seg_convert.load_sam = loaded("sam", real["load_sam"])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention_cuda.launches = 0
        blend_cuda.launches = blend_cuda.bwd_launches = 0
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
        launches = (blend_cuda.launches, blend_cuda.bwd_launches, attention_cuda.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        sd_convert.load_sd_models = real["load_sd"]
        GaussCtrlEditPipeline.render_reverse, GaussCtrlEditPipeline.edit_images = real["rr"], real["edit"]
        DataManager.write_back = real["write"]
        lang_sam.LangSAM.predict, lang_sam.LangSAM.__init__ = real["predict"], real["ls_init"]
        clip_vision.load_clip, seg_convert.load_sam = real["load_clip"], real["load_sam"]

    pipe, dm = seen["pipe"], trainer.dm
    V, cfg = len(dm), pipe.cfg
    n_chunks = -(-V // cfg.chunk_size)
    want_b3 = V * cfg.num_inference_steps * 2 * per_eval + n_chunks * cfg.num_inference_steps * \
        (2 + cfg.ref_view_num) * per_eval
    want_b1 = V + SEG_FINETUNE_STEPS + 1 + len(dm.eval_indices())
    print(f"    cli.train: {V} views at {dm.width}², edit \"{EDIT_PROMPT}\" with masks of \"{SEG_OBJ}\", "
          f"{cfg.num_inference_steps} inference steps, then {SEG_FINETUNE_STEPS} fine-tune steps: {cli_wall:.2f} s "
          f"host wall (data, checkpoint loads, edit, fine-tune, eval and save); render_reverse {seen['reverse_s']:.3f} s "
          f"(renders, inversions and LangSAM), edit_images {seen['edit_s']:.3f} s ({n_chunks} chunks); peak memory "
          f"{peak_gb:.2f} GB")
    print(f"    checkpoints loaded by the CLI (file → float32 on the card): load_sam {seen['sam_load_s']:.2f} s, "
          f"load_clip {seen['clip_load_s']:.2f} s")
    print(f"    launches: blend_fwd {launches[0]} (expected {want_b1} = {V} renders + {SEG_FINETUNE_STEPS} steps + 1 eval "
          f"image + {len(dm.eval_indices())} evaluate views), blend_bwd {launches[1]} (expected {SEG_FINETUNE_STEPS}), "
          f"flash_attn_fwd {launches[2]} (expected {want_b3}: phase 10's formula at {V} views, {per_eval} "
          f"Transformer2D blocks an evaluation)")
    if launches != (want_b1, SEG_FINETUNE_STEPS, want_b3):
        raise SystemExit(f"FAIL: launches {launches}, expected {(want_b1, SEG_FINETUNE_STEPS, want_b3)}")

    # ---- the masks and the composite
    cover = []
    if sorted(pipe.masks) != list(range(V)) or sorted(seen["written"]) != list(range(V)):
        raise SystemExit(f"FAIL: masks for {len(pipe.masks)} and write-backs for {len(seen['written'])} of {V} views")
    for i in range(V):
        m = pipe.masks[i]
        if m.shape != (dm.height, dm.width) or not np.isin(m, (0.0, 1.0)).all():
            raise SystemExit(f"FAIL: view {i}'s mask is {m.shape} with values {np.unique(m)[:6]}")
        keep = m == 0
        if not np.array_equal(seen["written"][i][keep], pipe.unedited[i][keep]):
            raise SystemExit(f"FAIL: view {i}'s written-back image differs from its render where the mask is 0")
        cover.append(float(m.mean()))
    n_boxes = [len(b) for b in seen["boxes"]]
    pre = seen["predict_s"]
    print(f"    masks: {V} of {dm.height}×{dm.width}, values in {{0, 1}}; written-back images equal their renders "
          f"wherever the mask is 0; coverage per view {[round(c, 4) for c in cover]}; CLIP boxes per view {n_boxes}")
    print(f"    LangSAM.predict host wall per view (CLIP grounding + SAM-H encode + decode + mask upsampling, "
          f"synchronized): mean {np.mean(pre) * 1e3:.2f} ms, min {min(pre) * 1e3:.2f}, max {max(pre) * 1e3:.2f} over "
          f"{len(pre)} views")

    # ---- SAM-H and CLIP-L by CUDA events on the CLI's own models
    ls, clip = seen["langsam"], seen["clip"]
    img0 = (np.clip(pipe.unedited[0], 0, 1) * 255).astype(np.uint8)
    batch = torch.as_tensor(preprocess_image(img0, ls.cfg.img_size)[0], device=dev)
    with torch.no_grad():
        emb = ls.sam.encode_image(batch)
        boxes = torch.as_tensor(np.array([[40.0, 60.0, 900.0, 980.0]], np.float32), device=dev)
        enc_ms = time_ms(lambda: ls.sam.encode_image(batch), SEG_TIMING_ITERS, warmup=1)
        dec_ms = time_ms(lambda: ls.sam.predict_boxes(emb, boxes), SEG_TIMING_ITERS, warmup=1)
        pixel = torch.as_tensor(clip_pixels(img0, clip.vision_config.image_size), device=dev)
        ids = torch.as_tensor(crc_tokenize([SEG_OBJ]), device=dev)
        patch_ms = time_ms(lambda: clip.patch_embeddings(pixel), SEG_TIMING_ITERS, warmup=1)
        text_ms = time_ms(lambda: clip.get_text_features(ids), SEG_TIMING_ITERS, warmup=1)
    print(f"    by CUDA events, mean of {SEG_TIMING_ITERS} warm calls: SAM-H encode {enc_ms:.3f} ms per 1024² image, "
          f"decode {dec_ms:.3f} ms per box; CLIP-L/14 patch embeddings {patch_ms:.3f} ms per 224² image, text "
          f"features {text_ms:.3f} ms per prompt; {smi}")

    # ---- LangSAM.predict, card vs CPU, at ViT-B width
    sam_cpu = random_sam(vit_b_config(), SAM_B_SEED, torch.device("cpu"))
    sam_card = copy.deepcopy(sam_cpu).to(dev)
    vi = int(np.argmax([0 < c < 1 for c in cover]))  # a view whose mask is neither empty nor full, if any
    img = (np.clip(pipe.unedited[vi], 0, 1) * 255).astype(np.uint8)
    fixed = seen["boxes"][vi] if len(seen["boxes"][vi]) else np.array([[0, 0, S, S]], np.float32)

    def provider(image, text):
        return fixed, [text] * len(fixed), np.ones(len(fixed), np.float32)

    card_ls, cpu_ls = lang_sam.LangSAM(sam_card, provider), lang_sam.LangSAM(sam_cpu, provider)
    t0 = time.perf_counter()
    low_cpu, scale = cpu_ls.low_res_logits(img, fixed)
    cpu_s = time.perf_counter() - t0
    low_card, _ = card_ls.low_res_logits(img, fixed)
    up_cpu = upscale_logits(low_cpu, scale, img.shape[:2], cpu_ls.cfg.img_size)[:, 0].numpy()
    m_cpu, m_card = cpu_ls.predict(img, SEG_OBJ)[0], card_ls.predict(img, SEG_OBJ)[0]
    scale_l = float(low_cpu.abs().max())
    d_low = float((low_card.cpu() - low_cpu).abs().max())
    away = np.abs(up_cpu) > SEG_MASK_MARGIN * float(np.abs(up_cpu).max())
    n_diff = int((m_card != m_cpu).sum())
    n_diff_away = int((m_card != m_cpu)[away].sum())
    print(f"    LangSAM.predict at ViT-B width (seed {SAM_B_SEED}), view {vi}, {len(fixed)} boxes, card vs CPU, fp32, TF32 "
          f"off for matmuls (torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}) and cuDNN "
          f"(torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}): low-res logits max|d| {d_low:.3e} "
          f"of max|logit| {scale_l:.4f} (limit {SEG_LOGIT_REL:g} of it); masks differ at {n_diff} pixels, "
          f"{n_diff_away} where |logit| > {SEG_MASK_MARGIN:g} of its largest (limit 0); CPU encode+decode {cpu_s:.2f} s")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise SystemExit("FAIL: TF32 is on for the card vs CPU check")
    if not d_low <= SEG_LOGIT_REL * scale_l or n_diff_away:
        raise SystemExit("FAIL: LangSAM on the card disagrees with the CPU")
    del models, sam_card, sam_cpu, pipe, ls, clip, seen, trainer
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"    phase 19 wall {phase_s:.1f} s (scene, checkpoints, the CLI run, timings and the CPU check)")
    return dict(b1=launches[0], b2=launches[1], b3=launches[2])


def segment_only(dev) -> int:
    """``--segment``: phase 19 alone (kernels B1, B2 and B3 built). Prints
    no kernels line and no result."""
    from gaussctrl_exp_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line())
    t0 = time.perf_counter()
    cuda_build.build(BLEND_SOURCES + ("flash_attn_fwd",))
    print(f"built B1, B2 and B3 in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase19_segment(dev, synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5), Path(tmp))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--attention", action="store_true",
                      help="build and time only the attention kernels (phase 9 and the kernel rows of 11 and 15)")
    mode.add_argument("--blend", action="store_true",
                      help="build, check and time only the blend kernels B1 and B2 (phases 3 and 6, then alone)")
    mode.add_argument("--generator", action="store_true",
                      help="only the bf16 depth generator's step (phase 17) on seeded latents")
    mode.add_argument("--variants", action="store_true",
                      help="build, check and time only B1 and B1v, the blend ablations (phase 16's checks, then alone)")
    mode.add_argument("--edit", action="store_true",
                      help="only the edit path at full width (phases 9 to 11)")
    mode.add_argument("--train-cli", action="store_true",
                      help="only the scene loader, the training CLI and render dataset (phase 18)")
    mode.add_argument("--segment", action="store_true",
                      help="only the training CLI's edit with live segmentation (phase 19)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if args.attention:
        return attention_only(torch.device("cuda"))
    if args.blend:
        return blend_only(torch.device("cuda"))
    if args.generator:
        return generator_only(torch.device("cuda"))
    if args.variants:
        return variants_only(torch.device("cuda"))
    if args.edit:
        return edit_only(torch.device("cuda"))
    if args.train_cli:
        return train_cli_only(torch.device("cuda"))
    if args.segment:
        return segment_only(torch.device("cuda"))
    from gaussctrl_exp_tpu_torch.cameras import camera_matrices, make_camera
    from gaussctrl_exp_tpu_torch.cli import render as cli
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, model_colors, render_model
    from gaussctrl_exp_tpu_torch.ops import blend_cuda, cuda_build
    from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
    from gaussctrl_exp_tpu_torch.ops.blend import rasterize_tiles_plain
    from gaussctrl_exp_tpu_torch.ops.projection import project_gaussians
    from gaussctrl_exp_tpu_torch.utils.png import read_png
    from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig, Trainer, make_train_step
    from gaussctrl_exp_tpu_torch.models.densify import DensifyConfig
    from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussctrl_exp_tpu_torch.ops.blend import blend_vjp_plain
    from gaussctrl_exp_tpu_torch.ops.lpips import lpips_random
    from gaussctrl_exp_tpu_torch.utils.timing import device_window, kernel_time_ms, spare_launches

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = cuda_build.build()
    built = ", ".join(f"{lib.name} from {cuda_build.SOURCES[n].relative_to(ROOT)}" for n, lib in libs.items())
    print(f"[2] built {built} in {time.perf_counter() - t0:.2f} s, one nvcc per source in parallel "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    print_ptxas()

    bear = synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5)
    garden = synthetic_params(N_GARDEN, 7, 1.2, -5.3, 0.4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt, path_json = write_inputs(tmp, bear)
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
        cams = cli.path_cameras(path_json, device=dev)
        cam0 = cams[0]

        # ---- phase 3: the kernel against its plain version
        cases = blend_cases(dev, state, cam0, garden)
        max_abs_err = phase3_blend(cases)
        (bear_args, bear_bins), (args_odd, bins_odd), (g_args, g_bins) = cases["bear"], cases["odd"], cases["garden"]
        c2w0 = orbit_c2w(0, FRAMES)

        # ---- phase 4: the main path through the CLI entry point
        out_dir = tmp / "frames"
        argv = ["camera-path", "--ckpt", str(ckpt), "--camera-path", str(path_json),
                "--out", str(out_dir), "--outputs", "rgb", "depth", "accumulation"]
        blend_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = blend_cuda.launches
        pngs = sorted(out_dir.glob("frame_*.png"))
        print(f"[4] camera-path CLI: {len(pngs)} frames of {S}×{S} in {wall:.3f} s "
              f"({wall / FRAMES * 1e3:.1f} ms/frame host wall, first frame included); "
              f"blend_fwd launches {launches}")
        if launches != FRAMES:
            raise SystemExit(f"FAIL: blend_fwd launched {launches} times for {FRAMES} frames")
        if len(pngs) != FRAMES:
            raise SystemExit(f"FAIL: {len(pngs)} PNGs written, expected {FRAMES}")
        coverage = []
        for p, fr in zip(pngs, frames):
            img = read_png(p)
            if img.shape != (S, 3 * S, 3) or not np.array_equal(img, fr):
                raise SystemExit(f"FAIL: {p.name} does not hold the rendered frame")
            coverage.append(float((img[:, 2 * S:, 0] > 127).mean()))
        print(f"    alpha > 0.5 coverage per frame: {[round(c, 4) for c in coverage]}")
        if not all(0.02 < c < 0.98 for c in coverage):
            raise SystemExit("FAIL: trivial alpha coverage")

        cfg = SplatModelConfig(background_color="white")
        with torch.no_grad():
            out = render_model(state, cam0, cli.EVAL_STEP, cfg)
            for nm in ("rgb", "alpha", "depth"):
                if not bool(torch.isfinite(getattr(out, nm)).all()):
                    raise SystemExit(f"FAIL: non-finite {nm}")
            rgb_q = (out.rgb.clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
            if not np.array_equal(rgb_q, frames[0][:, :S]):
                raise SystemExit("FAIL: frame 1's rgb panel differs from a re-render")
            cpu_state = GaussianState(params_from_numpy(bear, "cpu"), torch.ones(N_BEAR, dtype=torch.bool))
            cpu_cam = cli.path_cameras(path_json, device="cpu")[0]
            ref = render_model(cpu_state, cpu_cam, cli.EVAL_STEP, cfg)
        d_rgb = (out.rgb.cpu() - ref.rgb).abs()
        d_alpha = (out.alpha.cpu() - ref.alpha).abs()
        frac = float((d_rgb.amax(-1) > 1e-4).float().mean())
        print(f"    frame 1 on cuda vs the plain path on the cpu: max|d rgb| {float(d_rgb.max()):.3e} "
              f"max|d alpha| {float(d_alpha.max()):.3e}; pixels over 1e-4: {frac:.2e}")
        # the CPU and CUDA exp/log round differently, so a gaussian at the
        # 1/255 alpha edge or the stop threshold can flip in or out of a
        # pixel: at most one gaussian's weight (~0.02 with these colours)
        if float(d_rgb.max()) > 2e-2 or float(d_alpha.max()) > 2e-2 or frac > 1e-2:
            raise SystemExit("FAIL: cuda render disagrees with the cpu render")

        # ---- phase 5: timings (bear frame 1, 512², C = 4)
        p = state.params
        vm, _, fm = camera_matrices(cam0)

        def project():
            return project_gaussians(p.means, torch.exp(p.scales), 1.0, p.quats, vm, fm,
                                     cam0.fx, cam0.fy, cam0.cx, cam0.cy, S, S,
                                     extra_mask=state.alive, opacities=torch.sigmoid(p.opacities[:, 0]))

        with torch.no_grad():
            proj = project()
            frame_ms = time_ms(lambda: render_model(state, cam0, cli.EVAL_STEP, cfg))
            proj_ms = time_ms(lambda: (model_colors(p, cam0, cli.EVAL_STEP, cfg), project()))
            bin_ms = time_ms(lambda: bin_gaussians(proj, S // 16, S // 16))
            kernel_ms = time_ms(lambda: blend_cuda.rasterize_tiles(*bear_args, bear_bins, S, S), iters=50)
            plain_ms = time_ms(lambda: rasterize_tiles_plain(*bear_args, bear_bins, S, S), iters=5, warmup=1)
            g_kernel_ms = time_ms(lambda: blend_cuda.rasterize_tiles(*g_args, g_bins, S, S), iters=20)
            g_plain_ms = time_ms(lambda: rasterize_tiles_plain(*g_args, g_bins, S, S), iters=3, warmup=1)
            frame_win = device_window(lambda: render_model(state, cam0, cli.EVAL_STEP, cfg), calls=5)
            kernel_dev_ms = kernel_time_ms(lambda: blend_cuda.rasterize_tiles(*bear_args, bear_bins, S, S),
                                             "blend_fwd_kernel")
            g_kernel_dev_ms = kernel_time_ms(lambda: blend_cuda.rasterize_tiles(*g_args, g_bins, S, S),
                                               "blend_fwd_kernel")
        bound_ms, bound_by, work = blend_bound(bear_args, bear_bins, S, S)
        g_bound_ms, g_bound_by, g_work = blend_bound(g_args, g_bins, S, S)
        print(f"[5] bear {S}² per frame (CUDA events, warm): render_model {frame_ms:.4f} ms = "
              f"project+SH {proj_ms:.4f} + binning {bin_ms:.4f} + blend_fwd {kernel_ms:.4f} (+ rest)")
        print(f"    device time per frame {frame_win['device_ms']:.4f} ms in {frame_win['ops']:.0f} device ops "
              f"(torch.profiler, {frame_win['calls']} frames): {busy_text(frame_win)}")
        print(f"    bear blend_fwd {kernel_dev_ms:.4f} ms device time per launch (torch.profiler; {kernel_ms:.4f} ms "
              f"per call in CUDA events) vs plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}); n_isects "
              f"{bear_bins.n_isects}; work {work}")
        print(f"    garden {N_GARDEN} blend_fwd {g_kernel_dev_ms:.4f} ms device time ({g_kernel_ms:.4f} ms in events) "
              f"vs plain {g_plain_ms:.4f} ms; bound {g_bound_ms:.5f} ms ({g_bound_by}); n_isects {g_bins.n_isects}; "
              f"work {g_work}")

        # ---- phase 6: B2 against the plain VJP
        bwd_max_abs_err = phase6_blend(dev, cases, state, cam0)

        # ---- phase 7: the training path through Trainer
        train_cfg = TrainConfig(
            model=SplatModelConfig(sh_degree=3, sh_degree_interval=10, background_color="white"),
            densify=DensifyConfig(warmup_length=20, refine_every=10, reset_alpha_every=3),
            use_lpips=False,
        )
        with torch.no_grad():
            targets = [render_model(state, c, cli.EVAL_STEP, train_cfg.model).rgb.contiguous() for c in cams]
        views = ViewSet(cams, targets)
        ckpt2 = tmp / "perturbed.ckpt"
        save_splatfacto(ckpt2, perturbed(bear, 1))
        gs, _ = import_splatfacto_checkpoint(ckpt2, capacity=TRAIN_CAPACITY, device=dev)
        trainer = Trainer(gs, views, train_cfg)
        refines, resets = [], []
        real_refine, real_reset = trainer.refine_step, trainer.reset_opacity_step

        def refine_step(st):
            info = {k: int(v) for k, v in real_refine(st).items()}
            refines.append((trainer.step, info))
            return info

        trainer.refine_step = refine_step
        trainer.reset_opacity_step = lambda st: (resets.append(trainer.step), real_reset(st))
        blend_cuda.launches = blend_cuda.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(TRAIN_STEPS, log_every=10)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = (blend_cuda.launches, blend_cuda.bwd_launches)
        hist = trainer.history
        print(f"[7] Trainer.train: {TRAIN_STEPS} steps at {S}² in {train_wall:.3f} s host wall "
              f"({train_wall / TRAIN_STEPS * 1e3:.1f} ms/step, first steps included), capacity "
              f"{TRAIN_CAPACITY}; blend_fwd launches {train_launches[0]}, blend_bwd launches {train_launches[1]}")
        for h in hist:
            print(f"    step {h['step']}: main_loss {h['main_loss']:.5f} l1 {h['l1']:.5f} ssim {h['ssim']:.5f} "
                  f"psnr {h['psnr']:.3f} n_isects {h['n_isects']} n_alive {h['n_alive']} "
                  f"Gradients/Total {h['Gradients/Total']:.4e} Device Memory (MB) {h.get('Device Memory (MB)')}")
        for step_i, info in refines:
            print(f"    refine at step {step_i}: " + " ".join(f"{k} {v}" for k, v in info.items()))
        print(f"    opacity reset at steps {resets}")
        if train_launches != (TRAIN_STEPS, TRAIN_STEPS):
            raise SystemExit(f"FAIL: {TRAIN_STEPS} steps launched blend_fwd/blend_bwd {train_launches} times")
        if resets != [40] or [r[0] for r in refines] != [50]:
            raise SystemExit(f"FAIL: expected a reset at 40 and a densify at 50, got {resets} and {refines}")
        if not hist[-1]["main_loss"] < hist[0]["main_loss"]:
            raise SystemExit("FAIL: the loss did not fall from the first logged step to the last")
        if not all(bool(torch.isfinite(getattr(trainer.state.params, n)).all()) for n in PARAM_NAMES):
            raise SystemExit("FAIL: a parameter is not finite after training")
        ev = trainer.evaluate()
        print(f"    Trainer.evaluate: " + " ".join(f"{k} {v:.5f}" for k, v in ev.items()))
        if not all(np.isfinite(v) for v in ev.values()):
            raise SystemExit("FAIL: evaluate gave a non-finite metric")

        lp_cfg = TrainConfig(model=train_cfg.model, densify=DensifyConfig(warmup_length=10_000), use_lpips=True)
        lp_trainer = Trainer(GaussianState(trainer.state.params, trainer.state.alive), views, lp_cfg,
                             lpips=lpips_random(0, dev))
        lp_trainer.train(LPIPS_STEPS, log_every=1)
        lp = [h["lpips"] for h in lp_trainer.history]
        print(f"    + {LPIPS_STEPS} steps with a random-weight LPIPS term (patch 32, 8 patches): lpips {lp}")
        if len(lp) != LPIPS_STEPS or not all(np.isfinite(lp)):
            raise SystemExit("FAIL: the LPIPS term is missing or not finite")

        # step 1's gradients on the card vs the plain path on the CPU, at 128²
        small = 128
        f_small = float(cam0.fx) * small / S
        cam_s = make_camera(c2w0, f_small, f_small, small / 2, small / 2, small, small, device=dev)
        with torch.no_grad():
            gt_s = render_model(state, cam_s, cli.EVAL_STEP, train_cfg.model).rgb.contiguous()
        gs_cpu, _ = import_splatfacto_checkpoint(ckpt2, capacity=TRAIN_CAPACITY, device="cpu")
        cam_s_cpu = make_camera(c2w0, f_small, f_small, small / 2, small / 2, small, small, device="cpu")
        m_card, g_card = step_gradients(gs, cam_s, gt_s, train_cfg)
        m_cpu, g_cpu = step_gradients(gs_cpu, cam_s_cpu, gt_s.cpu(), train_cfg)
        rels = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm()) for n in PARAM_NAMES if g_cpu[n].norm() > 0}
        print(f"    step 1 at {small}², card vs CPU plain path: loss {m_card['main_loss']:.7f} vs "
              f"{m_cpu['main_loss']:.7f}; gradient relative L2 per group "
              + " ".join(f"{n} {r:.2e}" for n, r in rels.items()))
        if len(rels) < 5 or max(rels.values()) > STEP_GRAD_REL_L2 or \
                abs(m_card["main_loss"] - m_cpu["main_loss"]) > 1e-5 * abs(m_cpu["main_loss"]):
            raise SystemExit("FAIL: the card's train step disagrees with the CPU's")

        # ---- phase 8: timings of the train step (bear, 512², one fixed view, SH degree 3)
        st, gt0 = trainer.state, targets[0]
        stages = ("render", "loss", "backward", "optimizer", "stats")
        marks: list = []

        def mark(_name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)

        timed_step = make_train_step(train_cfg, on_stage=mark)
        plain_step = make_train_step(train_cfg)
        for _ in range(3):
            plain_step(st, cam0, gt0)
        iters = 20
        per_stage = dict.fromkeys(stages, 0.0)
        step_total = 0.0
        for _ in range(iters):
            marks.clear()
            torch.cuda.synchronize()
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            timed_step(st, cam0, gt0)
            torch.cuda.synchronize()
            prev = begin
            for name, e in zip(stages, marks):
                per_stage[name] += prev.elapsed_time(e) / iters
                prev = e
            step_total += begin.elapsed_time(marks[-1]) / iters
        step_win = device_window(lambda: plain_step(st, cam0, gt0), calls=5)
        t_args, t_bins = blend_inputs(GaussianState(st.params, st.alive), cam0, 3)
        fwd_t = blend_cuda.blend_forward(*t_args, t_bins, S, S)
        gen = torch.Generator(device=dev).manual_seed(3)
        g_img = torch.randn(fwd_t.img.shape, generator=gen, device=dev)
        g_T = torch.randn(fwd_t.final_T.shape, generator=gen, device=dev)
        bwd_ms = time_ms(lambda: blend_cuda.blend_backward(*t_args, t_bins, fwd_t.img, fwd_t.final_T, g_img, g_T, S, S),
                         iters=50)
        bwd_dev_ms = kernel_time_ms(
            lambda: blend_cuda.blend_backward(*t_args, t_bins, fwd_t.img, fwd_t.final_T, g_img, g_T, S, S),
            "blend_bwd_kernel")
        bwd_plain_ms = time_ms(lambda: blend_vjp_plain(*t_args, t_bins, g_img, g_T, S, S), iters=3, warmup=1)
        bwd_bound_ms, bwd_bound_by, bwd_work = blend_bound(t_args, t_bins, S, S, backward=True)
        fwd_g = blend_cuda.blend_forward(*g_args, g_bins, S, S)
        gg_img, gg_T = torch.randn_like(fwd_g.img), torch.randn_like(fwd_g.final_T)
        g_bwd_ms = time_ms(lambda: blend_cuda.blend_backward(*g_args, g_bins, fwd_g.img, fwd_g.final_T, gg_img, gg_T, S, S))
        g_bwd_dev_ms = kernel_time_ms(
            lambda: blend_cuda.blend_backward(*g_args, g_bins, fwd_g.img, fwd_g.final_T, gg_img, gg_T, S, S),
            "blend_bwd_kernel")
        g_bwd_plain_ms = time_ms(lambda: blend_vjp_plain(*g_args, g_bins, gg_img, gg_T, S, S), iters=2, warmup=1)
        g_bwd_bound_ms, g_bwd_bound_by, g_bwd_work = blend_bound(g_args, g_bins, S, S, backward=True)
        print(f"[8] train step, bear {S}², capacity {TRAIN_CAPACITY}, {int(st.alive.sum())} alive, SH degree 3, "
              f"one view (CUDA events, warm, mean of {iters}): {step_total:.4f} ms = "
              + " + ".join(f"{n} {per_stage[n]:.4f}" for n in stages))
        print(f"    backward {per_stage['backward']:.4f} ms, of which blend_bwd {bwd_ms:.4f} ms (timed alone "
              f"on this view's inputs, C=3, n_isects {t_bins.n_isects})")
        print(f"    device time per step {step_win['device_ms']:.4f} ms in {step_win['ops']:.0f} device ops "
              f"(torch.profiler, {step_win['calls']} steps): {busy_text(step_win)}")
        print(f"    bear blend_bwd {bwd_dev_ms:.4f} ms device time per launch (torch.profiler; {bwd_ms:.4f} ms per "
              f"call in CUDA events) vs plain VJP {bwd_plain_ms:.4f} ms; bound {bwd_bound_ms:.5f} ms "
              f"({bwd_bound_by}); work {bwd_work}")
        print(f"    garden {N_GARDEN} blend_bwd {g_bwd_dev_ms:.4f} ms device time ({g_bwd_ms:.4f} ms in events) vs "
              f"plain VJP {g_bwd_plain_ms:.4f} ms; bound {g_bwd_bound_ms:.5f} ms ({g_bwd_bound_by}); n_isects "
              f"{g_bins.n_isects}; work {g_bwd_work}")
        flash_errs, flash_cases = phase9_flash(dev)
        edit = phase10_edit(dev, state, cams, targets)
        flash = phase11_timings(dev, state, cams, edit, flash_cases)
        bwd_errs = phase12_flash_bwd(dev)
        mv = phase13_mv(dev, state, edit)
        phase14_experimental(dev, state, cams, targets, edit)
        bwd = phase15_timings(dev, mv)
        variants = phase16_variants(dev, (args_odd, bins_odd), (g_args, g_bins))
        for name in ("gen", "opt", "proc"):  # the fp32 generator and its Adam state make room for the bf16 one
            mv.pop(name)
        torch.cuda.empty_cache()
        mvb = phase17_mv_bf16(dev, mv["cams"], mv["depths"], mv["x0"], mv["ctx"])
        torch.cuda.empty_cache()
        cli18 = phase18_train_cli(dev, bear, tmp)
        torch.cuda.empty_cache()
        seg19 = phase19_segment(dev, bear, tmp)
        print(f"    total chip_smoke wall {time.perf_counter() - t_start:.1f} s; spare launches a profiled cycle at the end "
              f"{spare_launches()}")

    kernels = {"kernels": [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "gaussctrl_exp_tpu/ops/blend_pallas.py:117 (_fwd_kernel)",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_dev_ms,
        "event_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "train_cli_launches": cli18["b1_cli"],
        "dataset_launches": cli18["b1_dataset"],
        "segment_cli_launches": seg19["b1"],
    }, {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "gaussctrl_exp_tpu/ops/blend_pallas.py:177 (_bwd_kernel, with _blend_core_bwd's reduction)",
        "launches": train_launches[1],
        "max_abs_err": bwd_max_abs_err,
        "ms": bwd_dev_ms,
        "event_ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
        "also_replaces": "bench.py:310 and scripts/bench_bwd_micro.py:109 (B2c: B2's _bwd_kernel launched directly "
                         "on fixed cotangents), run in phase 16 by gaussctrl_exp_tpu_torch/scripts/bench_bwd_micro.py",
        "b2c_launches": variants["b2c_launches"],
        "train_cli_launches": cli18["b2_cli"],
        "segment_cli_launches": seg19["b2"],
    }, {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "gaussctrl_exp_tpu/diffusion/attention.py:37 (_flash_sdpa, the library TPU flash attention)",
        "launches": edit["b3_launches"],
        "max_abs_err": flash_errs[torch.bfloat16],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "segment_cli_launches": seg19["b3"],
    }, {
        "name": "flash_attn_fwd_f32",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "gaussctrl_exp_tpu/diffusion/attention.py:37 (_flash_sdpa in fp32: jax/experimental/pallas/ops/tpu/"
                    "flash_attention.py:589, pallas_call :758), reached from diffusion/mv_generator.py:198",
        "launches": mv["launches"][0],
        "max_abs_err": flash_errs[torch.float32],
        **flash["f32"],
    }, {
        "name": "flash_attn_bwd_dkv",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 (_flash_attention_bwd_dkv, pallas_call "
                    ":1121), the backward of gaussctrl_exp_tpu/diffusion/attention.py:37 _flash_sdpa reached from "
                    "diffusion/mv_generator.py:198",
        **bwd_entry("B4", mv["launches"][1], bwd_errs, bwd, torch.float32),
    }, {
        "name": "flash_attn_bwd_dq",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 (_flash_attention_bwd_dq, pallas_call "
                    ":1456), the backward of gaussctrl_exp_tpu/diffusion/attention.py:37 _flash_sdpa reached from "
                    "diffusion/mv_generator.py:198",
        **bwd_entry("B5", mv["launches"][2], bwd_errs, bwd, torch.float32),
    }, {
        "name": "flash_attn_bwd_dkv_bf16",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 (_flash_attention_bwd_dkv, pallas_call "
                    ":1121) in bf16, the backward of gaussctrl_exp_tpu/diffusion/attention.py:37 _flash_sdpa reached "
                    "from diffusion/mv_generator.py:198 with init_depth_generator(dtype=jnp.bfloat16)",
        **bwd_entry("B4", mvb["launches"][1], bwd_errs, bwd, torch.bfloat16),
    }, {
        "name": "flash_attn_bwd_dq_bf16",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 (_flash_attention_bwd_dq, pallas_call "
                    ":1456) in bf16, the backward of gaussctrl_exp_tpu/diffusion/attention.py:37 _flash_sdpa reached "
                    "from diffusion/mv_generator.py:198 with init_depth_generator(dtype=jnp.bfloat16)",
        **bwd_entry("B5", mvb["launches"][2], bwd_errs, bwd, torch.bfloat16),
    }]}
    for mode, row in variants["rows"].items():
        kernels["kernels"].append({
            "name": f"blend_variants/{mode}",
            "route": "cuda",
            "source": "gaussctrl_exp_tpu_torch/csrc/blend_variants.cu",
            "replaces": ("scripts/bench_blend_variants.py:149 (make_pair_kernel)" if mode == "pair" else
                         f"scripts/bench_blend_variants.py:88 (make_fwd_kernel({mode!r}))") + ", launched :241",
            "launches": variants["launches"][mode],
            "max_abs_err": variants["errs"][mode],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    print(smi_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
