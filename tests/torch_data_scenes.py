"""Synthetic nerfstudio-format scenes written from seeds, for the port's data
and CLI tests: ``transforms.json``, images (JPEG or PNG, written with PIL,
which only these CPU tests use), a ``sparse_pc.ply`` in several PLY
formats, and the edit loop's sidecar folders."""

import json
from pathlib import Path

import numpy as np
from PIL import Image

OPENCV = {"k1": 0.02, "k2": -0.004, "p1": 0.001, "p2": -0.0007}
PLY_FORMATS = ("binary_little_endian", "binary_big_endian", "ascii", "float_rgb", "no_rgb")


def orbit_c2w(i: int, n: int, radius: float = 4.0) -> np.ndarray:
    """(4, 4) OpenGL camera-to-world on a circle around the origin, looking at it."""
    ang = 2 * np.pi * i / n
    eye = np.array([radius * np.sin(ang), -radius * np.cos(ang), 0.8 + 0.1 * np.cos(3 * ang)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, -forward], axis=1)
    c2w[:3, 3] = eye + np.array([0.3, -0.2, 0.5])  # off-centre, so centring moves it
    return c2w


def smooth_image(rng, h: int, w: int) -> np.ndarray:
    """A smooth (H, W, 3) uint8 image with noise: adaptive PNG filters get
    rows of every kind, and JPEG blocks are not flat."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = 0.5 + 0.4 * np.sin(6 * xx[..., None] + 4 * yy[..., None] + phase)
    return np.clip(base * 255 + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def write_ply(path: Path, xyz: np.ndarray, rgb: np.ndarray, fmt: str) -> None:
    """``fmt``: one of PLY_FORMATS (float_rgb: little-endian, colours as
    floats in [0, 1]; no_rgb: little-endian, positions only)."""
    n = len(xyz)
    if fmt == "ascii":
        lines = ["ply", "format ascii 1.0", f"element vertex {n}",
                 "property float x", "property float y", "property float z",
                 "property uchar red", "property uchar green", "property uchar blue", "end_header"]
        lines += [f"{x:.6f} {y:.6f} {z:.6f} {r} {g} {b}" for (x, y, z), (r, g, b) in zip(xyz, rgb)]
        path.write_text("\n".join(lines) + "\n")
        return
    endian = ">" if fmt == "binary_big_endian" else "<"
    header = "binary_big_endian" if fmt == "binary_big_endian" else "binary_little_endian"
    fields = [("x", endian + "f4"), ("y", endian + "f4"), ("z", endian + "f4")]
    if fmt == "float_rgb":
        fields += [("red", endian + "f4"), ("green", endian + "f4"), ("blue", endian + "f4")]
    elif fmt != "no_rgb":
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    props = {"f4": "float", "u1": "uchar"}
    rec = np.zeros(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = xyz.T
    if fmt == "float_rgb":
        rec["red"], rec["green"], rec["blue"] = (rgb / 255.0).T
    elif fmt != "no_rgb":
        rec["red"], rec["green"], rec["blue"] = rgb.T
    head = [f"ply\nformat {header} 1.0\nelement vertex {n}\n"]
    head += [f"property {props[t[-2:]]} {name}\n" for name, t in fields]
    path.write_bytes(("".join(head) + "end_header\n").encode() + rec.tobytes())


def write_scene(
    root: Path,
    n: int = 6,
    w: int = 32,
    h: int = 24,
    fmt: str = "jpg",
    per_frame: bool = False,
    distortion: dict | None = None,
    ply: str | None = "binary_little_endian",
    applied_scale: float | None = None,
    names: list | None = None,
    split_lists: dict | None = None,
    image_scale: int = 1,
    ds_folder: int | None = None,
    sidecars: bool = False,
    seed: int = 0,
) -> Path:
    """Write a scene of ``n`` views at w×h (images ``image_scale`` times
    larger, as a downscaled scene holds them) to ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    names = names or [f"frame_{i + 1:05d}.{fmt}" for i in range(n)]
    frames = []
    for i, name in enumerate(names):
        img = smooth_image(rng, h * image_scale, w * image_scale)
        Image.fromarray(img).save(root / "images" / name, quality=92)
        if ds_folder:
            (root / f"images_{ds_folder}").mkdir(exist_ok=True)
            small = Image.fromarray(img).resize((w * image_scale // ds_folder, h * image_scale // ds_folder))
            small.save(root / f"images_{ds_folder}" / name, quality=92)
        fr = {"file_path": f"images/{name}", "transform_matrix": orbit_c2w(i, n).tolist()}
        if per_frame:
            f = 30.0 * image_scale + 0.5 * i
            fr.update({"fl_x": f, "fl_y": f * 1.01, "cx": w * image_scale / 2 + 0.25 * i,
                       "cy": h * image_scale / 2 - 0.125 * i})
            for k, v in (distortion or {}).items():
                fr[k] = v * (1 + 0.1 * i)
        frames.append(fr)
    rng.shuffle(frames)  # the parser sorts by file path
    meta = {"w": w * image_scale, "h": h * image_scale, "camera_model": "OPENCV", "frames": frames}
    if not per_frame:
        meta.update({"fl_x": 30.0 * image_scale, "fl_y": 30.5 * image_scale,
                     "cx": w * image_scale / 2 + 0.3, "cy": h * image_scale / 2 - 0.2})
        meta.update(distortion or {})
    if ply is not None:
        pts = rng.normal(size=(40, 3)).astype(np.float32)
        cols = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        write_ply(root / "sparse_pc.ply", pts, cols, ply)
        meta["ply_file_path"] = "sparse_pc.ply"
    if applied_scale is not None:
        meta["applied_scale"] = applied_scale
    if split_lists:
        meta.update(split_lists)
    (root / "transforms.json").write_text(json.dumps(meta))
    if sidecars:
        for d in ("depth_npy", "z_0", "mask_npy", "unedited"):
            (root / d).mkdir(exist_ok=True)
        for i in range(n):
            mask = (rng.uniform(size=(h, w)) > 0.5).astype(np.float32)
            np.save(root / "mask_npy" / f"frame_{i + 1:05d}.npy", mask[..., None] if i % 2 else mask)
    return root
