"""Render a nerfstudio camera path from a splatfacto checkpoint.

Port of the ``camera-path`` subcommand of ``gaussctrl_exp_tpu/cli/render.py``.
Frames are rendered with a white background at step 30 000 (full SH degree)
and written as ``frame_00001.png`` … into ``--out``; the requested outputs
(rgb, depth, accumulation) are concatenated side by side.

Usage:
  python -m gaussctrl_exp_tpu_torch.cli.render camera-path \\
      --ckpt step-000029999.ckpt --camera-path path.json --out renders/ \\
      [--outputs rgb depth accumulation] [--downscale-factor 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..cameras import Camera, make_camera
from ..device import resolve_device
from ..engine.checkpoint import import_splatfacto_checkpoint
from ..models.gaussians import GaussianState
from ..models.splat_model import ModelOutputs, SplatModelConfig, render_model
from ..utils.colormaps import apply_depth_colormap
from ..utils.png import write_png

EVAL_STEP = 30_000  # past every SH degree step: renders at the full degree


def frame_from_outputs(out: ModelOutputs, outputs: Sequence[str]) -> np.ndarray:
    """Concatenate the requested output images horizontally → (H, W·k, 3) uint8."""
    cols = []
    alpha = out.alpha.cpu().numpy()
    for name in outputs:
        if name == "rgb":
            cols.append(np.clip(out.rgb.cpu().numpy(), 0, 1))
        elif name == "depth":
            cols.append(apply_depth_colormap(out.depth.cpu().numpy(), alpha))
        elif name == "accumulation":
            cols.append(np.repeat(np.clip(alpha, 0, 1), 3, axis=-1))
        else:
            raise ValueError(f"unknown output {name!r}")
    return (np.concatenate(cols, axis=1) * 255).astype(np.uint8)


def render_cameras(
    state: GaussianState,
    cameras: Sequence[Camera],
    out_dir: Path,
    outputs: Sequence[str] = ("rgb",),
    cfg: Optional[SplatModelConfig] = None,
) -> list[np.ndarray]:
    """Render each camera at eval settings and write its frame as a PNG."""
    cfg = cfg or SplatModelConfig(background_color="white")
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            frame = frame_from_outputs(render_model(state, cam, EVAL_STEP, cfg), outputs)
            write_png(out_dir / f"frame_{i + 1:05d}.png", frame)
            frames.append(frame)
    return frames


def path_cameras(path_json: Path, downscale: int = 1, device="cuda") -> list[Camera]:
    """Perspective cameras of a nerfstudio camera-path json."""
    meta = json.loads(Path(path_json).read_text())
    ctype = str(meta.get("camera_type", "perspective")).lower()
    if ctype != "perspective":
        raise ValueError(f"camera_type {ctype!r} is not supported; only perspective paths render")
    H = int(meta["render_height"]) // downscale
    W = int(meta["render_width"]) // downscale
    cams = []
    for fr in meta["camera_path"]:
        c2w = np.asarray(fr["camera_to_world"], np.float32).reshape(4, 4)[:3, :4]
        fov = float(fr.get("fov", 50.0)) * np.pi / 180.0
        fy = H / (2 * np.tan(fov / 2))
        cams.append(make_camera(c2w, fy, fy, W / 2, H / 2, W, H, device=device))
    return cams


def cmd_camera_path(args) -> list[np.ndarray]:
    device = resolve_device(args.device)
    cams = path_cameras(Path(args.camera_path), args.downscale_factor, device)
    state, _ = import_splatfacto_checkpoint(args.ckpt, device=device)
    return render_cameras(state, cams, Path(args.out), args.outputs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("camera-path", help="render a nerfstudio camera-path json to PNG frames")
    sp.add_argument("--ckpt", required=True, help="splatfacto .ckpt")
    sp.add_argument("--camera-path", required=True, dest="camera_path")
    sp.add_argument("--out", required=True)
    sp.add_argument("--outputs", nargs="+", default=["rgb"],
                    choices=["rgb", "depth", "accumulation"],
                    help="output images concatenated horizontally")
    sp.add_argument("--downscale-factor", type=int, default=1, dest="downscale_factor")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(func=cmd_camera_path)
    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
