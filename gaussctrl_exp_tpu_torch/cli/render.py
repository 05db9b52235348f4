"""``gctpu-render``: render a scene's dataset views, a camera path, an
interpolated trajectory or a spiral.

Port of ``gaussctrl_exp_tpu/cli/render.py``. ``--ckpt`` is a splatfacto
``.ckpt`` or a training checkpoint directory written by ``cli/train.py``
(its latest ``step-*``). Frames are rendered with a white background at
step 30 000 (full SH degree) and written as ``frame_00001.png`` (or
``.jpg`` with ``--fmt jpg``, at Pillow's default quality 75) into ``--out``;
the requested outputs (rgb, depth, accumulation) are concatenated side by
side.

Subcommands (the reference's gc_render.py:875-888):
  dataset      every camera of a split; each frame's raw depth divided by
               the dataparser scale goes to ``<data>/depth_npy/`` (the edit
               loop's sidecar input, gc_render.py:826-838)
  camera-path  a nerfstudio camera-path json, then a video. An
               omnidirectional-stereo or VR180 path renders each eye with
               perspective cameras ``--ipd`` apart and stacks them (ODS top
               over bottom, VR180 side by side), and an mp4 gets the
               spherical metadata (gc_render.py:314-381, 481-599). Any other
               camera type renders perspective. ``--render-nearest-camera``
               appends the nearest training view, ``--check-occlusions``
               skipping views whose line of sight the scene blocks
               (gc_render.py:151-190)
  interpolate  poses interpolated between the training views, then a video
  spiral       a circle of cameras around the scene, then a video

The video is an mp4 from the written ``frame_%05d.png`` through an
``ffmpeg`` binary when one is on the path, else an animated GIF written by
Pillow, the JAX package's order without its imageio step.

Usage:
  python -m gaussctrl_exp_tpu_torch.cli.render dataset \\
      --data data/bear --ckpt outputs/gaussctrl/ckpts --out renders/ [--split train]
  python -m gaussctrl_exp_tpu_torch.cli.render camera-path \\
      --ckpt step-000029999.ckpt --camera-path path.json --out renders/ \\
      [--outputs rgb depth accumulation] [--downscale-factor 2] [--device cuda]
  python -m gaussctrl_exp_tpu_torch.cli.render spiral --data data/bear \\
      --ckpt outputs/gaussctrl/ckpts --out spiral/ [--frames 120] [--fps 24]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..cameras import Camera, look_at, make_camera
from ..data.dataparser import DataParserConfig, load_scene
from ..device import resolve_device
from ..engine.checkpoint import import_splatfacto_checkpoint, load_gaussians
from ..models.gaussians import GaussianState
from ..models.splat_model import ModelOutputs, SplatModelConfig, render_model
from ..utils.colormaps import apply_depth_colormap
from ..utils.video import insert_spherical_metadata, stack_stereo

EVAL_STEP = 30_000  # past every SH degree step: renders at the full degree
STEREO_TYPES = {
    "omni-directional-stereo": "ods",
    "omnidirectional": "ods",
    "ods": "ods",
    "vr180": "vr180",
}


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


def write_video(out_dir: Path, frames: Sequence[np.ndarray], fps: int) -> Path:
    """``render.mp4`` from the written ``frame_%05d.png`` through an
    ``ffmpeg`` binary when one is on the path and succeeds, else
    ``render.gif`` (the JAX package's ``_write_video`` order, which tries
    imageio first)."""
    if shutil.which("ffmpeg"):
        p = out_dir / "render.mp4"
        cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i", str(out_dir / "frame_%05d.png"),
               "-pix_fmt", "yuv420p", str(p)]
        if subprocess.run(cmd, capture_output=True).returncode == 0:
            return p
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    p = out_dir / "render.gif"
    imgs[0].save(p, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return p


def offset_eye(cam: Camera, offset: float) -> Camera:
    """Shift the camera along its right axis for stereo eye separation."""
    c2w = cam.c2w.cpu().numpy().astype(np.float32)
    c2w[:3, 3] += offset * c2w[:3, 0]
    return make_camera(c2w, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), cam.width, cam.height,
                       device=cam.c2w.device)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation → wxyz unit quaternion (host-side, for camera distance)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


class NearestCameraProbe:
    """Pick the nearest unoccluded training view per rendered camera and
    return its image column (gc_render.py:151-190): distance
    0.3·(1 − ⟨q, q_cam⟩²) + 0.7·‖Δp‖; with ``check_occlusions``, a view is
    skipped when a 16² depth render from the path camera toward it finds the
    scene's surface at its centre closer than the view. With no unoccluded
    view, the nearest one."""

    def __init__(self, parsed, check_occlusions: bool):
        self.images = list(parsed.image_filenames)
        self.c2ws = np.asarray(parsed.cameras.c2w)
        self.check = check_occlusions
        self.probes = 0  # occlusion renders since construction

    def nearest_index(self, state: GaussianState, cam: Camera, cfg: SplatModelConfig) -> int:
        c2w = cam.c2w.cpu().numpy()
        pos, qcam = np.array(c2w[:3, 3]), rotmat_to_quat(np.array(c2w[:3, :3]))
        best, best_i, tbest, tbest_i = np.inf, -1, np.inf, -1
        for i in range(len(self.c2ws)):
            tpos = self.c2ws[i, :3, 3]
            q = rotmat_to_quat(self.c2ws[i, :3, :3])
            dist = 0.3 * (1 - np.dot(q, qcam) ** 2) + 0.7 * float(np.linalg.norm(tpos - pos))
            if dist < tbest:
                tbest, tbest_i = dist, i
            if dist >= best:
                continue
            if self.check:
                d = float(np.linalg.norm(tpos - pos))
                if d > 1e-6:
                    probe = make_camera(look_at(pos, tpos), 16.0, 16.0, 8.0, 8.0, 16, 16, device=cam.c2w.device)
                    with torch.no_grad():
                        out = render_model(state, probe, EVAL_STEP, cfg)
                    self.probes += 1
                    if float(out.depth[8, 8, 0]) < d:
                        continue
            best, best_i = dist, i
        return best_i if best_i >= 0 else tbest_i

    def lookup(self, state: GaussianState, cam: Camera, height: int, cfg: SplatModelConfig) -> np.ndarray:
        """The nearest view's image, resized to ``height`` rows by PIL's
        default (bicubic) filter."""
        from PIL import Image

        img = np.asarray(Image.open(self.images[self.nearest_index(state, cam, cfg)]).convert("RGB"))
        w = int(round(img.shape[1] * height / img.shape[0]))
        return np.asarray(Image.fromarray(img).resize((w, height)))


def render_cameras(
    state: GaussianState,
    cameras: Sequence[Camera],
    out_dir: Path,
    outputs: Sequence[str] = ("rgb",),
    cfg: Optional[SplatModelConfig] = None,
    depth_dir: Optional[Path] = None,
    dataparser_scale: float = 1.0,
    fmt: str = "png",
    video: bool = False,
    fps: int = 24,
    nearest: Optional[NearestCameraProbe] = None,
    stereo: Optional[str] = None,
    ipd: float = 0.064,
) -> list[np.ndarray]:
    """Render each camera at eval settings and write its frame
    (``frame_00001.<fmt>`` …). With ``stereo`` ("ods" or "vr180") each
    frame is the two eyes ``ipd`` apart, stacked; with ``nearest`` the
    probe's train view is appended on the right; with ``depth_dir`` (mono
    only) each raw depth divided by ``dataparser_scale`` is saved as
    ``frame_00001.npy`` …; with ``video``, ``write_video`` follows."""
    from PIL import Image

    cfg = cfg or SplatModelConfig(background_color="white")
    out_dir.mkdir(parents=True, exist_ok=True)
    if depth_dir is not None:
        depth_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            if stereo:
                eyes = [frame_from_outputs(render_model(state, offset_eye(cam, side * ipd / 2.0), EVAL_STEP, cfg),
                                           outputs) for side in (-1.0, 1.0)]
                frame = stack_stereo(eyes[0], eyes[1], stereo)
            else:
                out = render_model(state, cam, EVAL_STEP, cfg)
                frame = frame_from_outputs(out, outputs)
                if depth_dir is not None:
                    np.save(depth_dir / f"frame_{i + 1:05d}.npy", out.depth[..., 0].cpu().numpy() / dataparser_scale)
            if nearest is not None:
                frame = np.concatenate([frame, nearest.lookup(state, cam, frame.shape[0], cfg)], axis=1)
            Image.fromarray(frame).save(out_dir / f"frame_{i + 1:05d}.{fmt}")
            frames.append(frame)
    if video:
        vp = write_video(out_dir, frames, fps)
        print(f"video: {vp.name} ({'ffmpeg' if vp.suffix == '.mp4' else 'Pillow GIF'})")
        if vp.suffix == ".mp4" and stereo:
            insert_spherical_metadata(vp, {"ods": "top-bottom", "vr180": "left-right"}[stereo])
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


def scene_camera(parsed, c2w, downscale: int, device) -> Camera:
    """A camera at ``c2w`` with the scene's first intrinsics, downscaled."""
    c = parsed.cameras

    def scaled(v):
        return v if downscale == 1 else v / downscale

    return make_camera(c2w, scaled(c.fx[0]), scaled(c.fy[0]), scaled(c.cx[0]), scaled(c.cy[0]),
                       c.width // downscale, c.height // downscale, device=device)


def cmd_dataset(args) -> list[np.ndarray]:
    device = resolve_device(args.device)
    parsed = load_scene(DataParserConfig(data=Path(args.data)), split=args.split)
    cams = dataset_cameras(parsed, args.downscale_factor, device)
    state = load_state(args.ckpt, device)
    return render_cameras(state, cams, Path(args.out), args.outputs, fmt=args.fmt,
                          depth_dir=Path(args.data) / "depth_npy", dataparser_scale=parsed.dataparser_scale)


def path_meta(path_json: Path) -> dict:
    return json.loads(Path(path_json).read_text())


def path_stereo(path_json: Path) -> Optional[str]:
    """"ods" or "vr180" for a stereo camera path, else None."""
    ctype = str(path_meta(path_json).get("camera_type", "perspective")).lower().replace("_", "-")
    return STEREO_TYPES.get(ctype)


def path_cameras(path_json: Path, downscale: int = 1, device="cuda") -> list[Camera]:
    """Perspective cameras of a nerfstudio camera-path json, whatever its
    ``camera_type`` (as the JAX package renders every type)."""
    meta = path_meta(path_json)
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
    state = load_state(args.ckpt, device)
    nearest = None
    if args.render_nearest_camera:
        if not args.data:
            raise SystemExit("--render-nearest-camera requires --data")
        nearest = NearestCameraProbe(load_scene(DataParserConfig(data=Path(args.data))), args.check_occlusions)
    return render_cameras(state, cams, Path(args.out), args.outputs, fmt=args.fmt, video=True, fps=args.fps,
                          nearest=nearest, stereo=path_stereo(Path(args.camera_path)), ipd=args.ipd)


def interp_poses(c2ws, steps_per_transition: int = 10) -> list[np.ndarray]:
    """Linear pose interpolation with renormalized rotations (gc_render interp)."""
    out = []
    for a, b in zip(c2ws[:-1], c2ws[1:]):
        for t in np.linspace(0, 1, steps_per_transition, endpoint=False):
            m = (1 - t) * a + t * b
            u, _, vt = np.linalg.svd(m[:3, :3])
            m = m.copy()
            m[:3, :3] = u @ vt
            out.append(m)
    return out


def spiral_poses(parsed, frames: int) -> list[np.ndarray]:
    """``frames`` cameras on a circle at the training cameras' mean distance
    from the origin and mean height, each looking at the origin."""
    radius = float(np.linalg.norm(parsed.cameras.c2w[:, :3, 3], axis=1).mean())
    height = float(parsed.cameras.c2w[:, 2, 3].mean())
    return [look_at(np.array([radius * np.cos(a), radius * np.sin(a), height]), np.zeros(3))
            for a in np.linspace(0, 2 * np.pi, frames, endpoint=False)]


def cmd_interpolate(args) -> list[np.ndarray]:
    device = resolve_device(args.device)
    parsed = load_scene(DataParserConfig(data=Path(args.data)))
    poses = interp_poses(list(np.asarray(parsed.cameras.c2w)), args.steps)
    cams = [scene_camera(parsed, p, args.downscale_factor, device) for p in poses]
    return render_cameras(load_state(args.ckpt, device), cams, Path(args.out), args.outputs, fmt=args.fmt,
                          video=True, fps=args.fps)


def cmd_spiral(args) -> list[np.ndarray]:
    device = resolve_device(args.device)
    parsed = load_scene(DataParserConfig(data=Path(args.data)))
    cams = [scene_camera(parsed, p, args.downscale_factor, device) for p in spiral_poses(parsed, args.frames)]
    return render_cameras(load_state(args.ckpt, device), cams, Path(args.out), args.outputs, fmt=args.fmt,
                          video=True, fps=args.fps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, text in [
        ("dataset", cmd_dataset, "render every camera of a scene split, with depth_npy/ sidecars"),
        ("camera-path", cmd_camera_path, "render a nerfstudio camera-path json to frames and a video"),
        ("interpolate", cmd_interpolate, "render poses interpolated between the training views"),
        ("spiral", cmd_spiral, "render a circle of cameras around the scene"),
    ]:
        sp = sub.add_parser(name, help=text)
        sp.add_argument("--ckpt", required=True, help="splatfacto .ckpt, or a training checkpoint directory")
        sp.add_argument("--out", required=True)
        sp.add_argument("--fmt", default="png", choices=["png", "jpg"])
        sp.add_argument("--fps", type=int, default=24)
        sp.add_argument("--outputs", nargs="+", default=["rgb"],
                        choices=["rgb", "depth", "accumulation"],
                        help="output images concatenated horizontally")
        sp.add_argument("--downscale-factor", type=int, default=1, dest="downscale_factor")
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if name != "camera-path":
            sp.add_argument("--data", required=True, help="scene directory (transforms.json)")
        if name == "dataset":
            sp.add_argument("--split", default="train")
        if name == "camera-path":
            sp.add_argument("--camera-path", required=True, dest="camera_path")
            sp.add_argument("--data", default=None)
            sp.add_argument("--ipd", type=float, default=0.064, help="stereo eye separation in world units")
            sp.add_argument("--render-nearest-camera", action="store_true", dest="render_nearest_camera")
            sp.add_argument("--check-occlusions", action="store_true", dest="check_occlusions")
        if name == "interpolate":
            sp.add_argument("--steps", type=int, default=10)
        if name == "spiral":
            sp.add_argument("--frames", type=int, default=120)
        sp.set_defaults(func=fn)
    args = p.parse_args(argv)
    return args.func(args)


def entrypoint():
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()
