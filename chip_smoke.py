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
# B1's fp32 operations: every evaluated (pixel, gaussian) pair computes dx, dy,
# sigma (9), the sigma test, -sigma, exp (counted as one), ×opacity, the
# clamp and the alpha test; a composited pair adds 1−α, T×, the stop test,
# the weight and a multiply-add per channel
OPS_EVALUATED = 17
OPS_COMPOSITED_BASE = 4

S = 512  # frame size of the main path
N_BEAR = 34_174  # gaussians of the bear scene (its splatfacto checkpoint)
N_GARDEN = 300_000
FRAMES = 6
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


def blend_bound(args, bins, H, W) -> tuple[float, str, dict]:
    from gaussctrl_exp_tpu_torch.ops.blend import count_pairs

    xys, conics, chan, opacs = args
    N, C = chan.shape
    tiles = bins.tile_cnt.numel()
    with torch.no_grad():
        evaluated, composited = count_pairs(xys, conics, opacs, bins, H, W)
    n_bytes = 4 * (N * (2 + 3 + C + 1) + bins.n_isects + 2 * tiles + H * W * (C + 1))
    n_ops = OPS_EVALUATED * evaluated + (OPS_COMPOSITED_BASE + 2 * C) * composited
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_OPS_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, dict(bytes=n_bytes, ops=n_ops, evaluated_pairs=evaluated,
                                         composited_pairs=composited)


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = blend_cuda.build()
    print(f"[2] built {lib.name} from {blend_cuda.SOURCE.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(blend_cuda.NVCC_FLAGS)})")

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
    }]}
    print(smi_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
