"""Data manager: image caching + undistortion, view subsetting, train sampling.

Port of ``gaussctrl_exp_tpu/data/datamanager.py``, after the reference's
GaussCtrlDataManager (gc_datamanager.py):

  * caches + undistorts every image up front, updating the intrinsics to the
    alpha=0 optimal new camera matrix and cropping to its ROI (:112-186),
  * view subsetting: if views > subset_num × sampled_views_every_subset
    (4 × 10 = 40) and not load_all, splits the views into ``subset_num``
    contiguous anchors and samples ``sampled_views_every_subset`` per split
    with ``random.Random(seed)``, re-indexing (:89-110),
  * ``next_train`` pops a random unseen view and re-populates when
    exhausted (:213-235),
  * edited-image write-back for the GaussCtrl edit loop.

Images live as a host (V, H, W, 3) float32 numpy stack, as in the JAX
package; ``camera(i)`` returns the port's ``Camera`` on ``device``.

Baseline JPEGs go through the native batch loader (``native/imageio.cpp``:
decode, integer box downscale, bilinear undistort remap, one thread a core).
Every view it refuses (a PNG, a progressive JPEG, a size that is not an
integer multiple of the cameras') is decoded by Pillow, fitted by
``_fit_to`` (the box filter at integer ratios, else Pillow's LANCZOS) and
undistorted by the native ``undistort_f32``, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import random
from pathlib import Path

import numpy as np
import torch

from ..cameras import Camera, make_camera, stack_cameras
from ..device import resolve_device
from ..native import get_imageio
from .dataparser import DataParserConfig, DataparserOutputs, ParsedCameras, load_scene
from .undistort import optimal_new_K


@dataclasses.dataclass
class DataManagerConfig:
    dataparser: DataParserConfig = dataclasses.field(default_factory=DataParserConfig)
    subset_num: int = 4
    sampled_views_every_subset: int = 10
    load_all: bool = False
    seed: int = 0


def _load_image(path: Path) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1]: Pillow's RGB / 255."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def _fit_to(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Resize to the cameras' (downscaled) resolution: box filter for integer
    ratios (nerfstudio downscales with ffmpeg-area semantics), PIL otherwise."""
    h, w = img.shape[:2]
    if (h, w) == (H, W) or not (H and W):
        return img
    if h % H == 0 and w % W == 0 and h // H == w // W:
        r = h // H
        return img.reshape(H, r, W, r, -1).mean(axis=(1, 3))
    from PIL import Image

    img8 = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(img8.resize((W, H), Image.LANCZOS), dtype=np.float32) / 255.0


def _image_size(path: Path) -> tuple[int, int]:
    """(W, H) of an image file."""
    from PIL import Image

    with Image.open(path) as img:
        return img.size


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def cache_images(paths: list, cams: ParsedCameras) -> tuple[np.ndarray, np.ndarray, list]:
    """Decode + undistort every view: (images (V, H, W, 3) float32, new
    camera matrices (V, 3, 3), ROIs (x, y, w, h)), the images before the
    ROI crop."""
    lib = get_imageio()
    if cams.width and cams.height:  # target size (downscaled when ds > 1)
        W, H = int(cams.width), int(cams.height)
    else:
        W, H = _image_size(paths[0])

    V = len(paths)
    Ks = np.zeros((V, 3, 3), np.float64)
    newKs = np.zeros((V, 3, 3), np.float64)
    dists = np.ascontiguousarray(cams.distortion[:V], np.float64)
    rois = []
    for i in range(V):
        Ks[i] = [[cams.fx[i], 0, cams.cx[i]], [0, cams.fy[i], cams.cy[i]], [0, 0, 1]]
        newKs[i], roi = optimal_new_K(Ks[i], dists[i], W, H)
        rois.append(roi)

    out = np.zeros((V, H, W, 3), np.float32)
    failed = np.full(V, -1, np.int32)
    cpaths = (ctypes.c_char_p * V)(*[str(p).encode() for p in paths])
    n_ok = lib.load_undistort_batch(cpaths, V, H, W, _ptr(Ks), _ptr(dists), _ptr(newKs), _ptr(out),
                                    _ptr(failed), 0)
    if n_ok < V:  # non-JPEG / progressive views: PIL decode + native remap
        for i in sorted(failed[failed >= 0]):
            img = np.ascontiguousarray(_fit_to(_load_image(paths[i]), H, W), np.float32)
            if np.any(np.abs(dists[i]) > 0):
                lib.undistort_f32(_ptr(img), H, W, 3, _ptr(Ks[i]), _ptr(dists[i]), _ptr(newKs[i]), _ptr(out[i]))
            else:
                out[i] = img
    return out, newKs, rois


class DataManager:
    """Caches train images and serves (camera_index, image) train samples."""

    def __init__(self, config: DataManagerConfig, split: str = "train",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.parsed: DataparserOutputs = load_scene(config.dataparser, split)
        self._rng = random.Random(config.seed)

        n_views = len(self.parsed.image_filenames)
        stack, newKs, rois = cache_images(self.parsed.image_filenames, self.parsed.cameras)
        images, fx, fy, cx, cy = [], [], [], [], []
        for i in range(stack.shape[0]):
            x, y, rw, rh = rois[i]
            images.append(stack[i, y : y + rh, x : x + rw])
            fx.append(newKs[i][0, 0])
            fy.append(newKs[i][1, 1])
            cx.append(newKs[i][0, 2] - x)
            cy.append(newKs[i][1, 2] - y)
        # undistortion ROI can differ by a pixel between views; crop to common size
        H = min(im.shape[0] for im in images)
        W = min(im.shape[1] for im in images)
        images = [im[:H, :W] for im in images]

        self.images = np.stack(images)  # (V, H, W, 3)
        self.c2w = self.parsed.cameras.c2w
        self.fx = np.asarray(fx, np.float32)
        self.fy = np.asarray(fy, np.float32)
        self.cx = np.asarray(cx, np.float32)
        self.cy = np.asarray(cy, np.float32)
        self.width, self.height = W, H

        # --- view subsetting (gc_datamanager.py:89-110)
        cap = config.subset_num * config.sampled_views_every_subset
        if n_views <= cap or config.load_all:
            self.view_indices = list(range(n_views))
        else:
            anchors = list(range(0, n_views, n_views // config.subset_num))[: config.subset_num]
            anchors = anchors + [n_views]
            sampled = []
            for a, b in zip(anchors[:-1], anchors[1:]):
                sampled += sorted(self._rng.sample(range(a, b), config.sampled_views_every_subset))
            self.view_indices = sampled
        self._select(self.view_indices)
        self._unseen = list(range(len(self.view_indices)))

    def _select(self, idx):
        idx = np.asarray(idx)
        self.images = self.images[idx]
        self.c2w = self.c2w[idx]
        self.fx, self.fy = self.fx[idx], self.fy[idx]
        self.cx, self.cy = self.cx[idx], self.cy[idx]
        self.unedited_images = self.images.copy()

    def __len__(self) -> int:
        return len(self.view_indices)

    def camera(self, i: int) -> Camera:
        return make_camera(self.c2w[i], self.fx[i], self.fy[i], self.cx[i], self.cy[i],
                           self.width, self.height, device=self.device)

    def cameras_stacked(self) -> Camera:
        return stack_cameras([self.camera(i) for i in range(len(self))])

    def next_train(self) -> tuple[int, np.ndarray]:
        """Random unseen view; re-populate when exhausted (gc_datamanager.py:213-235)."""
        i = self._unseen.pop(self._rng.randint(0, len(self._unseen) - 1))
        if not self._unseen:
            self._unseen = list(range(len(self.view_indices)))
        return i, self.images[i]

    def image(self, i: int) -> np.ndarray:
        return self.images[i]

    def eval_indices(self, max_views: int = 8) -> list[int]:
        """Views used for the periodic image-metric eval: the reference's
        default split is train_split_fraction=1.0 (eval = train views),
        subsampled evenly to bound the eval's cost."""
        n = len(self)
        if n <= max_views:
            return list(range(n))
        stride = n / max_views
        return [int(i * stride) for i in range(max_views)]

    def write_back(self, i: int, image: np.ndarray) -> None:
        """Replace a cached train image with its edited version (ad_pipeline.py:241-242)."""
        self.images[i] = np.asarray(image, np.float32)

    def reset_images(self) -> None:
        """Restore the unedited images (the viewer's reset, gc_trainer.py:136-144)."""
        self.images = self.unedited_images.copy()

    def load_masks(self) -> dict[int, np.ndarray]:
        """Precomputed object masks from the scene's ``mask_npy/`` sidecars,
        keyed by (subsetted) view index; empty when the scene has none."""
        out: dict[int, np.ndarray] = {}
        files = self.parsed.mask_filenames
        if not files:
            return out
        for local_i, global_i in enumerate(self.view_indices):
            path = files[global_i]
            if Path(path).exists():
                out[local_i] = np.load(path).astype(np.float32).squeeze()
        return out
