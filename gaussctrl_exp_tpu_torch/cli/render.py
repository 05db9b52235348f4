"""Render a scene's dataset views or a nerfstudio camera path.

Port of the ``dataset`` and ``camera-path`` subcommands of
``gaussctrl_exp_tpu/cli/render.py``. ``--ckpt`` is a splatfacto ``.ckpt``
or a training checkpoint directory written by ``cli/train.py`` (its latest
``step-*``). Frames are rendered with a white background at step 30 000
(full SH degree) and written as ``frame_00001.png`` … into ``--out``; the
requested outputs (rgb, depth, accumulation) are concatenated side by side.
``dataset`` renders every camera of a split and writes each frame's raw
depth divided by the dataparser scale to ``<data>/depth_npy/`` (the edit
loop's sidecar input, the reference's gc_render.py:826-838).

Usage:
  python -m gaussctrl_exp_tpu_torch.cli.render dataset \\
      --data data/bear --ckpt outputs/gaussctrl/ckpts --out renders/ [--split train]
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
from ..data.dataparser import DataParserConfig, load_scene
from ..device import resolve_device
from ..engine.checkpoint import import_splatfacto_checkpoint, load_gaussians
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


def load_state(ckpt: str | Path, device) -> GaussianState:
    """The gaussians of a splatfacto ``.ckpt`` or of a training checkpoint
    directory (its latest ``step-*``, or the one named)."""
    ckpt = Path(ckpt)
    if ckpt.suffix == ".ckpt":
        return import_splatfacto_checkpoint(ckpt, device=device)[0]
    return load_gaussians(ckpt, device)[0]


def render_cameras(
    state: GaussianState,
    cameras: Sequence[Camera],
    out_dir: Path,
    outputs: Sequence[str] = ("rgb",),
    cfg: Optional[SplatModelConfig] = None,
    depth_dir: Optional[Path] = None,
    dataparser_scale: float = 1.0,
) -> list[np.ndarray]:
    """Render each camera at eval settings and write its frame as a PNG;
    with ``depth_dir``, also its raw depth divided by ``dataparser_scale``
    as ``frame_00001.npy`` …"""
    cfg = cfg or SplatModelConfig(background_color="white")
    out_dir.mkdir(parents=True, exist_ok=True)
    if depth_dir is not None:
        depth_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            out = render_model(state, cam, EVAL_STEP, cfg)
            frame = frame_from_outputs(out, outputs)
            write_png(out_dir / f"frame_{i + 1:05d}.png", frame)
            if depth_dir is not None:
                np.save(depth_dir / f"frame_{i + 1:05d}.npy", out.depth[..., 0].cpu().numpy() / dataparser_scale)
            frames.append(frame)
    return frames


def dataset_cameras(parsed, downscale: int = 1, device="cuda") -> list[Camera]:
    """The parsed cameras of a split (as ``load_scene`` gives them, before
    undistortion), divided by ``downscale``."""
    c = parsed.cameras

    def scaled(v):
        return v if downscale == 1 else v / downscale

    return [
        make_camera(c.c2w[i], scaled(c.fx[i]), scaled(c.fy[i]), scaled(c.cx[i]), scaled(c.cy[i]),
                    c.width // downscale, c.height // downscale, device=device)
        for i in range(len(parsed.image_filenames))
    ]


def cmd_dataset(args) -> list[np.ndarray]:
    device = resolve_device(args.device)
    parsed = load_scene(DataParserConfig(data=Path(args.data)), split=args.split)
    cams = dataset_cameras(parsed, args.downscale_factor, device)
    state = load_state(args.ckpt, device)
    return render_cameras(state, cams, Path(args.out), args.outputs,
                          depth_dir=Path(args.data) / "depth_npy", dataparser_scale=parsed.dataparser_scale)


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
    return render_cameras(load_state(args.ckpt, device), cams, Path(args.out), args.outputs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, text in [
        ("dataset", cmd_dataset, "render every camera of a scene split, with depth_npy/ sidecars"),
        ("camera-path", cmd_camera_path, "render a nerfstudio camera-path json to PNG frames"),
    ]:
        sp = sub.add_parser(name, help=text)
        sp.add_argument("--ckpt", required=True, help="splatfacto .ckpt, or a training checkpoint directory")
        sp.add_argument("--out", required=True)
        sp.add_argument("--outputs", nargs="+", default=["rgb"],
                        choices=["rgb", "depth", "accumulation"],
                        help="output images concatenated horizontally")
        sp.add_argument("--downscale-factor", type=int, default=1, dest="downscale_factor")
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if name == "dataset":
            sp.add_argument("--data", required=True, help="scene directory (transforms.json)")
            sp.add_argument("--split", default="train")
        else:
            sp.add_argument("--camera-path", required=True, dest="camera_path")
        sp.set_defaults(func=fn)
    args = p.parse_args(argv)
    return args.func(args)


def entrypoint():
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()
