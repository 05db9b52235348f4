"""Dataset parsing: nerfstudio-format ``transforms.json`` scenes.

Port of ``gaussctrl_exp_tpu/data/dataparser.py``, all numpy, so its
outputs equal the JAX package's bit for bit. It follows the reference's
dataparser (gc_dataparser_ns.py):

  * per-frame or global intrinsics + OPENCV distortion coefficients (:122-201),
  * frames sorted by filename (:143-149),
  * train/eval split modes fraction/filename/interval/all with
    train_split_fraction=1.0 default (:64,227-246), and explicit
    ``{split}_filenames`` lists,
  * auto-orient ("up") + center ("poses") + auto-scale poses to the ±1 box
    (:254-267),
  * the ``images_{ds}/`` folders of a downscaled scene (:475-504),
  * seed point cloud from ``sparse_pc.ply`` transformed into the oriented
    frame (:436-473),
  * sidecar discovery: depth_npy/, z_0/, mask_npy/, unedited/ (:408-420).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Literal, Optional

import numpy as np

from .ply import read_ply_points


@dataclasses.dataclass
class DataParserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    orientation_method: Literal["up", "none"] = "up"
    center_method: Literal["poses", "none"] = "poses"
    auto_scale_poses: bool = True
    eval_mode: Literal["fraction", "filename", "interval", "all"] = "fraction"
    train_split_fraction: float = 1.0  # reference default: all views train
    eval_interval: int = 8
    load_3D_points: bool = True
    load_mask: bool = True


@dataclasses.dataclass
class ParsedCameras:
    """Per-frame camera arrays (numpy, host-side)."""

    c2w: np.ndarray  # (V, 3, 4) OpenGL convention, oriented/centered/scaled
    fx: np.ndarray  # (V,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    distortion: np.ndarray  # (V, 6) k1 k2 k3 k4 p1 p2


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: list
    cameras: ParsedCameras
    dataparser_transform: np.ndarray  # (3, 4)
    dataparser_scale: float
    points_xyz: Optional[np.ndarray] = None  # (P, 3) in oriented frame
    points_rgb: Optional[np.ndarray] = None  # (P, 3) uint8
    depth_filenames: Optional[list] = None
    z0_filenames: Optional[list] = None
    mask_filenames: Optional[list] = None
    unedited_filenames: Optional[list] = None
    indices: Optional[np.ndarray] = None  # split indices into the sorted frames


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if c < -1 + 1e-8:  # antiparallel: rotate 180° about any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis /= np.linalg.norm(axis)
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        return -np.eye(3) + 2 * np.outer(axis, axis) + 0 * K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> tuple[np.ndarray, np.ndarray]:
    """(V, 4, 4) c2w → oriented (V, 3, 4) + applied (3, 4) transform.

    "up": aligns the average camera up (+y column) with world +z.
    "poses": subtracts the mean camera origin.
    """
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(axis=0)
    translation = mean_origin if center_method == "poses" else np.zeros(3)
    if method == "up":
        up = poses[:, :3, 1].sum(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        rotation = np.eye(3)
    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=1)  # (3,4)
    oriented = np.einsum("ij,vjk->vik", transform, poses)  # (V, 3, 4)
    return oriented.astype(np.float32), transform.astype(np.float32)


def _split_indices(
    n: int, cfg: DataParserConfig, split: str, names=None, meta=None
) -> np.ndarray:
    """Train/eval split (gc_dataparser_ns.py:210-246): explicit
    ``{split}_filenames`` lists in transforms.json override everything; else
    eval_mode ∈ fraction | filename | interval | all."""
    is_train = split == "train"
    if meta is not None and any(
        f"{s}_filenames" in meta for s in ("train", "val", "test")
    ):
        key = "train_filenames" if is_train else (
            "test_filenames" if split == "test" and "test_filenames" in meta else "val_filenames"
        )
        if key not in meta:
            raise RuntimeError(f"transforms.json has split filename lists but not {key}")
        wanted = {Path(w).name for w in meta[key]}
        idx = [i for i, nm in enumerate(names) if Path(nm).name in wanted]
        missing = wanted - {Path(names[i]).name for i in idx}
        if missing:
            raise RuntimeError(f"split {split} filenames not found: {sorted(missing)[:4]}")
        return np.asarray(idx, dtype=int)
    if cfg.eval_mode == "all":
        return np.arange(n)
    if cfg.eval_mode == "filename":
        # nerfstudio get_train_eval_split_filename: frames whose name contains
        # "train" are train; "eval"/"test" are eval
        i_train = [i for i, nm in enumerate(names) if "train" in Path(nm).name]
        i_eval = [
            i for i, nm in enumerate(names)
            if "eval" in Path(nm).name or "test" in Path(nm).name
        ]
        if not i_train and not i_eval:
            raise RuntimeError(
                'eval_mode="filename" needs "train"/"eval"/"test" in the image names'
            )
        return np.asarray(i_train if is_train else i_eval, dtype=int)
    if cfg.eval_mode == "interval":
        all_idx = np.arange(n)
        i_eval = all_idx[:: cfg.eval_interval]
        i_train = np.setdiff1d(all_idx, i_eval)
        return i_train if is_train else i_eval
    # fraction (nerfstudio: evenly-spaced train subset)
    num_train = int(np.ceil(n * cfg.train_split_fraction))
    num_eval = n - num_train
    all_idx = np.arange(n)
    if num_eval == 0:
        return all_idx
    train_idx = np.linspace(0, n - 1, num_train, dtype=int)
    eval_idx = np.setdiff1d(all_idx, train_idx)
    return train_idx if is_train else eval_idx


def load_scene(cfg: DataParserConfig, split: str = "train") -> DataparserOutputs:
    data_dir = Path(cfg.data)
    meta = json.loads((data_dir / "transforms.json").read_text())

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])

    def frame_val(fr, key, default=0.0):
        return float(fr.get(key, meta.get(key, default)))

    poses, fx, fy, cx, cy, dist, names = [], [], [], [], [], [], []
    for fr in frames:
        poses.append(np.asarray(fr["transform_matrix"], np.float32).reshape(4, 4))
        fx.append(frame_val(fr, "fl_x"))
        fy.append(frame_val(fr, "fl_y"))
        cx.append(frame_val(fr, "cx"))
        cy.append(frame_val(fr, "cy"))
        dist.append(
            [frame_val(fr, k) for k in ("k1", "k2", "k3", "k4", "p1", "p2")]
        )
        names.append(fr["file_path"])
    poses = np.stack(poses)

    indices = _split_indices(len(frames), cfg, split, names=names, meta=meta)

    oriented, transform = auto_orient_and_center_poses(
        poses, cfg.orientation_method, cfg.center_method
    )
    scale = 1.0
    if cfg.auto_scale_poses:
        scale = 1.0 / float(np.max(np.abs(oriented[:, :3, 3])))
    scale *= cfg.scale_factor
    oriented = oriented.copy()
    oriented[:, :3, 3] *= scale

    width = int(meta.get("w", frames[0].get("w", 0)))
    height = int(meta.get("h", frames[0].get("h", 0)))
    ds = cfg.downscale_factor or 1

    sel = indices
    cameras = ParsedCameras(
        c2w=oriented[sel],
        fx=np.asarray(fx, np.float32)[sel] / ds,
        fy=np.asarray(fy, np.float32)[sel] / ds,
        cx=np.asarray(cx, np.float32)[sel] / ds,
        cy=np.asarray(cy, np.float32)[sel] / ds,
        width=width // ds,
        height=height // ds,
        distortion=np.asarray(dist, np.float32)[sel],
    )
    image_filenames = [data_dir / names[i] for i in sel]
    if ds > 1:
        # pre-downscaled folder resolution (gc_dataparser_ns.py:475-504):
        # images/... → images_{ds}/... when that folder exists; otherwise the
        # datamanager box-downsamples at decode time
        scaled = [
            p.parent.with_name(p.parent.name + f"_{ds}") / p.name for p in image_filenames
        ]
        if all(p.exists() for p in scaled):
            image_filenames = scaled

    points_xyz = points_rgb = None
    if cfg.load_3D_points and "ply_file_path" in meta:
        xyz, rgb = read_ply_points(data_dir / meta["ply_file_path"])
        xyz = xyz @ transform[:3, :3].T + transform[:3, 3]
        xyz = xyz * scale
        if "applied_scale" in meta:
            xyz = xyz * float(meta["applied_scale"])
        points_xyz, points_rgb = xyz.astype(np.float32), rgb

    def sidecar(dirname: str, ext: str):
        d = data_dir / dirname
        if not d.exists():
            return None
        return [d / f"frame_{int(i) + 1:05d}.{ext}" for i in range(len(image_filenames))]

    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=cameras,
        dataparser_transform=transform,
        dataparser_scale=scale,
        points_xyz=points_xyz,
        points_rgb=points_rgb,
        depth_filenames=sidecar("depth_npy", "npy"),
        z0_filenames=sidecar("z_0", "npy"),
        mask_filenames=sidecar("mask_npy", "npy") if cfg.load_mask else None,
        unedited_filenames=sidecar("unedited", "jpg"),
        indices=np.asarray(sel),
    )
