#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernel to account.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
  2. build kernel B1 (csrc/blend_fwd.cu) with nvcc for sm_90a.
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
     B2 against its bound and the plain VJP at bear and garden scale, and
     ``scaled_dot_product_attention`` at the edit path's shape as the
     yardstick of the still unported flash attention (B3).

The last three lines of standard output are the card's name and power limit,
one JSON object describing each kernel, and ``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12  # dense, tensor cores
# B1's fp32 operations: every evaluated (pixel, gaussian) pair computes dx, dy,
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
# the edit path's attention (B3): SD1.x's first self-attention at a 64²
# latent, over the CFG batch of 4 reference + 5 chunk views, doubled
B3_SHAPE = (2 * (4 + 5), 8, 4096, 40)
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


def write_inputs(tmp: Path, arrays) -> tuple[Path, Path]:
    ckpt = tmp / "step-000029999.ckpt"
    sd = {f"_model.gauss_params.{k}": torch.as_tensor(v) for k, v in arrays.items()}
    torch.save({"step": 29_999, "pipeline": sd}, str(ckpt))
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


def device_share(fn, frames=5) -> tuple[float, float]:
    """Device time per call (ms) and kernels per call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in evs) / 1e3 / frames, len(evs) / frames


def roofline(n_bytes, n_ops, peak_ops_s=PEAK_F32_OPS_S) -> tuple[float, str]:
    """The least time (ms) for this work on the card, and what bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / peak_ops_s * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def blend_bound(args, bins, H, W, backward=False) -> tuple[float, str, dict]:
    """B1's bound, or B2's with ``backward``: each input read once, each
    output written once, and the fp32 operations of the pairs these inputs
    evaluate up to each pixel's stop."""
    from gaussctrl_exp_tpu_torch.ops.blend import count_pairs

    xys, conics, chan, opacs = args
    N, C = chan.shape
    tiles = bins.tile_cnt.numel()
    with torch.no_grad():
        evaluated, composited = count_pairs(xys, conics, opacs, bins, H, W)
    n_bytes = 4 * (N * (2 + 3 + C + 1) + bins.n_isects + 2 * tiles + H * W * (C + 1))
    if backward:  # + residuals img, final_T (counted above as the outputs), cotangents, gradients
        n_bytes += 4 * (H * W * (C + 1) + N * (6 + C))
        n_ops = OPS_EVALUATED * evaluated + (OPS_BWD_COMPOSITED_BASE + OPS_BWD_PER_CHANNEL * C) * composited
    else:
        n_ops = OPS_EVALUATED * evaluated + (OPS_COMPOSITED_BASE + 2 * C) * composited
    bound, by = roofline(n_bytes, n_ops)
    return bound, by, dict(bytes=n_bytes, ops=n_ops, evaluated_pairs=evaluated, composited_pairs=composited)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from gaussctrl_exp_tpu_torch.cameras import camera_matrices, look_at, make_camera
    from gaussctrl_exp_tpu_torch.cli import render as cli
    from gaussctrl_exp_tpu_torch.engine.checkpoint import import_splatfacto_checkpoint
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, model_colors, render_model
    from gaussctrl_exp_tpu_torch.ops import blend_cuda
    from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
    from gaussctrl_exp_tpu_torch.ops.blend import rasterize_tiles_plain
    from gaussctrl_exp_tpu_torch.ops.projection import project_gaussians
    from gaussctrl_exp_tpu_torch.utils.png import read_png
    from gaussctrl_exp_tpu_torch.engine.trainer import TrainConfig, Trainer, make_train_step
    from gaussctrl_exp_tpu_torch.models.densify import DensifyConfig
    from gaussctrl_exp_tpu_torch.models.gaussians import PARAM_NAMES
    from gaussctrl_exp_tpu_torch.ops.blend import blend_vjp_plain
    from gaussctrl_exp_tpu_torch.ops.lpips import lpips_random

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = blend_cuda.build()
    built = ", ".join(f"{lib.name} from {blend_cuda.SOURCES[n].relative_to(ROOT)}" for n, lib in libs.items())
    print(f"[2] built {built} in {time.perf_counter() - t0:.2f} s, one nvcc per source in parallel "
          f"(nvcc {' '.join(blend_cuda.NVCC_FLAGS)})")

    bear = synthetic_params(N_BEAR, 0, 0.8, -4.2, 0.5)
    garden = synthetic_params(N_GARDEN, 7, 1.2, -5.3, 0.4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt, path_json = write_inputs(tmp, bear)
        state, _ = import_splatfacto_checkpoint(ckpt, device=dev)
        cams = cli.path_cameras(path_json, device=dev)
        cam0 = cams[0]

        # ---- phase 3: the kernel against its plain version
        print("[3] blend kernel vs plain version")
        errs = []
        bear_args, bear_bins = blend_inputs(state, cam0, 4)
        errs.append(check_kernel(f"bear {S}² C=4", bear_args, bear_bins, S, S))
        args3, bins3 = blend_inputs(state, cam0, 3)
        errs.append(check_kernel(f"bear {S}² C=3", args3, bins3, S, S))
        zero = (bear_args[0], bear_args[1], bear_args[2], torch.zeros_like(bear_args[3]))
        errs.append(check_kernel(f"bear {S}² zero opacity", zero, bear_bins, S, S))
        out0 = blend_cuda.rasterize_tiles(*zero, bear_bins, S, S)
        if not (bool((out0.img == 0).all()) and bool((out0.final_T == 1).all())):
            raise SystemExit("FAIL: zero-opacity scene is not img 0, T 1")
        c2w0 = orbit_c2w(0, FRAMES)
        f0 = float(cam0.fx)
        cam_odd = make_camera(c2w0, f0, f0, 250.0, 186.0, 500, 372, device=dev)
        args_odd, bins_odd = blend_inputs(state, cam_odd, 4)
        errs.append(check_kernel("bear 500×372 C=4", args_odd, bins_odd, 372, 500))
        gstate = GaussianState(params_from_numpy(garden, dev), torch.ones(N_GARDEN, dtype=torch.bool, device=dev))
        gcam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), S * 1.05, S * 1.05, S / 2, S / 2, S, S, device=dev)
        g_args, g_bins = blend_inputs(gstate, gcam, 4)
        errs.append(check_kernel(f"garden {N_GARDEN} {S}² C=4", g_args, g_bins, S, S))
        max_abs_err = max(errs)

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
            dev_ms, kernels_per_frame = device_share(lambda: render_model(state, cam0, cli.EVAL_STEP, cfg))
        bound_ms, bound_by, work = blend_bound(bear_args, bear_bins, S, S)
        g_bound_ms, g_bound_by, g_work = blend_bound(g_args, g_bins, S, S)
        print(f"[5] bear {S}² per frame (CUDA events, warm): render_model {frame_ms:.4f} ms = "
              f"project+SH {proj_ms:.4f} + binning {bin_ms:.4f} + blend_fwd {kernel_ms:.4f} (+ rest)")
        print(f"    device time per frame {dev_ms:.4f} ms in {kernels_per_frame:.0f} device ops "
              f"(torch.profiler): busy share {dev_ms / frame_ms:.3f} of the {frame_ms:.4f} ms frame")
        print(f"    bear blend_fwd {kernel_ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms "
              f"({bound_by}); n_isects {bear_bins.n_isects}; work {work}")
        print(f"    garden {N_GARDEN} blend_fwd {g_kernel_ms:.4f} ms vs plain {g_plain_ms:.4f} ms; bound "
              f"{g_bound_ms:.5f} ms ({g_bound_by}); n_isects {g_bins.n_isects}; work {g_work}")

        # ---- phase 6: B2 against the plain VJP
        print("[6] blend backward kernel vs plain VJP (stop-band pixels get a zero cotangent)")
        blend_cuda.bwd_launches = 0
        bwd = [check_backward(f"bear {S}² C=4", bear_args, bear_bins, S, S),
               check_backward(f"bear {S}² C=3", args3, bins3, S, S),
               check_backward("bear 500×372 C=4", args_odd, bins_odd, 372, 500),
               check_backward(f"bear {S}² zero opacity", zero, bear_bins, S, S)]
        if any(bool(g.any()) for g in bwd[-1][1]):
            raise SystemExit("FAIL: zero opacity gives a non-zero gradient")
        clamped = (bear_args[0], bear_args[1], bear_args[2], torch.full_like(bear_args[3], 0.9999))
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
        bwd.append(check_backward(f"garden {N_GARDEN} {S}² C=4", g_args, g_bins, S, S))
        bwd_max_abs_err = max(e for e, _ in bwd)
        print(f"    blend_bwd launches in phase 6: {blend_cuda.bwd_launches} for {len(bwd)} cases")
        if blend_cuda.bwd_launches != len(bwd):
            raise SystemExit("FAIL: blend_bwd did not launch once per case")
        del bwd

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
        pert = perturbed(bear, 1)
        torch.save({"step": 29_999, "pipeline": {f"_model.gauss_params.{k}": torch.as_tensor(v)
                                                 for k, v in pert.items()}}, str(ckpt2))
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
        step_dev_ms, step_ops = device_share(lambda: plain_step(st, cam0, gt0))
        t_args, t_bins = blend_inputs(GaussianState(st.params, st.alive), cam0, 3)
        fwd_t = blend_cuda.blend_forward(*t_args, t_bins, S, S)
        gen = torch.Generator(device=dev).manual_seed(3)
        g_img = torch.randn(fwd_t.img.shape, generator=gen, device=dev)
        g_T = torch.randn(fwd_t.final_T.shape, generator=gen, device=dev)
        bwd_ms = time_ms(lambda: blend_cuda.blend_backward(*t_args, t_bins, fwd_t.img, fwd_t.final_T, g_img, g_T, S, S),
                         iters=50)
        bwd_plain_ms = time_ms(lambda: blend_vjp_plain(*t_args, t_bins, g_img, g_T, S, S), iters=3, warmup=1)
        bwd_bound_ms, bwd_bound_by, bwd_work = blend_bound(t_args, t_bins, S, S, backward=True)
        fwd_g = blend_cuda.blend_forward(*g_args, g_bins, S, S)
        gg_img, gg_T = torch.randn_like(fwd_g.img), torch.randn_like(fwd_g.final_T)
        g_bwd_ms = time_ms(lambda: blend_cuda.blend_backward(*g_args, g_bins, fwd_g.img, fwd_g.final_T, gg_img, gg_T, S, S))
        g_bwd_plain_ms = time_ms(lambda: blend_vjp_plain(*g_args, g_bins, gg_img, gg_T, S, S), iters=2, warmup=1)
        g_bwd_bound_ms, g_bwd_bound_by, g_bwd_work = blend_bound(g_args, g_bins, S, S, backward=True)
        print(f"[8] train step, bear {S}², capacity {TRAIN_CAPACITY}, {int(st.alive.sum())} alive, SH degree 3, "
              f"one view (CUDA events, warm, mean of {iters}): {step_total:.4f} ms = "
              + " + ".join(f"{n} {per_stage[n]:.4f}" for n in stages))
        print(f"    backward {per_stage['backward']:.4f} ms, of which blend_bwd {bwd_ms:.4f} ms (timed alone "
              f"on this view's inputs, C=3, n_isects {t_bins.n_isects})")
        print(f"    device time per step {step_dev_ms:.4f} ms in {step_ops:.0f} device ops (torch.profiler): "
              f"busy share {step_dev_ms / step_total:.3f}")
        print(f"    bear blend_bwd {bwd_ms:.4f} ms vs plain VJP {bwd_plain_ms:.4f} ms; bound {bwd_bound_ms:.5f} ms "
              f"({bwd_bound_by}); work {bwd_work}")
        print(f"    garden {N_GARDEN} blend_bwd {g_bwd_ms:.4f} ms vs plain VJP {g_bwd_plain_ms:.4f} ms; bound "
              f"{g_bwd_bound_ms:.5f} ms ({g_bwd_bound_by}); n_isects {g_bins.n_isects}; work {g_bwd_work}")
        B, H, L, D = B3_SHAPE
        q, k, v = (torch.randn(B3_SHAPE, dtype=torch.bfloat16, device=dev, generator=gen) for _ in range(3))
        sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        b3_bound_ms, b3_by = roofline(4 * B * H * L * D * 2, 4 * B * H * L * L * D, PEAK_BF16_OPS_S)
        print(f"    B3 yardstick (not a port; the port has no caller yet): scaled_dot_product_attention "
              f"(B, H, S, D) = {B3_SHAPE} bf16 {sdpa_ms:.4f} ms; bound {b3_bound_ms:.5f} ms ({b3_by}: "
              f"{4 * B * H * L * L * D:.3e} operations at 989 TFLOP/s, {4 * B * H * L * D * 2 / 1e6:.1f} MB)")
        print(f"    total chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "gaussctrl_exp_tpu/ops/blend_pallas.py:117 (_fwd_kernel)",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "gaussctrl_exp_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "gaussctrl_exp_tpu/ops/blend_pallas.py:177 (_bwd_kernel, with _blend_core_bwd's reduction)",
        "launches": train_launches[1],
        "max_abs_err": bwd_max_abs_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }]}
    print(smi_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
