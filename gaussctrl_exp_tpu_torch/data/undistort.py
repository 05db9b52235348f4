"""Undistortion geometry in numpy: iterative point undistortion and the
alpha=0 optimal new camera matrix.

A copy of ``gaussctrl_exp_tpu/data/undistort.py``: the OpenCV calls
nerfstudio's ``_undistort_image`` makes on the reference's data-caching path
(``getOptimalNewCameraMatrix`` + ``undistort``). The per-pixel remap lives in
``native/imageio.cpp``; the 3×3-matrix geometry lives here.

Distortion layout everywhere: dist6 = (k1, k2, k3, k4, p1, p2), the
dataparser's OPENCV storage order; the radial model is the rational subset
(1 + k1 r^2 + k2 r^4 + k3 r^6) / (1 + k4 r^2).
"""

from __future__ import annotations

import numpy as np


def distort_points(xy: np.ndarray, dist6: np.ndarray) -> np.ndarray:
    """Apply the distortion model to normalized points (..., 2)."""
    k1, k2, k3, k4, p1, p2 = [float(v) for v in dist6]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (1.0 + r2 * k4)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(
    pts: np.ndarray, K: np.ndarray, dist6: np.ndarray, iters: int = 5
) -> np.ndarray:
    """Pixel points (..., 2) → undistorted *normalized* coordinates.

    Fixed-point iteration matching cv2.undistortPoints' compensate-and-divide
    update (5 iterations, OpenCV's default termination count).
    """
    k1, k2, k3, k4, p1, p2 = [float(v) for v in dist6]
    x0 = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[..., 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = (1.0 + r2 * k4) / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return np.stack([x, y], axis=-1)


def _rectangles(K: np.ndarray, dist6: np.ndarray, w: int, h: int, newK=None):
    """Inscribed/circumscribed rectangles of the undistorted image
    (OpenCV icvGetRectangles: 9x9 grid, float32 points like CvPoint2D32f).
    Normalized coordinates, or pixels through ``newK`` when given."""
    N = 9
    gx, gy = np.meshgrid(np.arange(N) * w / (N - 1), np.arange(N) * h / (N - 1))
    pts = undistort_points(np.stack([gx, gy], axis=-1), K, dist6)  # (N, N, 2)
    if newK is not None:
        pts = pts @ np.array([[newK[0, 0], 0], [0, newK[1, 1]]]) + np.array(
            [newK[0, 2], newK[1, 2]]
        )
    pts = pts.astype(np.float32)  # OpenCV stores the grid as float32
    px, py = pts[..., 0], pts[..., 1]
    outer = (px.min(), py.min(), px.max(), py.max())
    inner = (px[:, 0].max(), py[0, :].max(), px[:, -1].min(), py[-1, :].min())
    return inner, outer


def optimal_new_K(
    K: np.ndarray, dist6: np.ndarray, w: int, h: int
) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """alpha=0 new camera matrix + valid-pixel ROI (x, y, w, h).

    Matches cv2.getOptimalNewCameraMatrix(K, d, (w, h), alpha=0): the inner
    (fully-valid) rectangle of the undistorted image is mapped to the full
    viewport; the ROI is that rectangle re-projected through the new matrix.
    """
    dist6 = np.asarray(dist6, np.float64)
    if not np.any(np.abs(dist6) > 0):
        return np.asarray(K, np.float64).copy(), (0, 0, w, h)
    (ix0, iy0, ix1, iy1), _ = _rectangles(K, dist6, w, h)
    fx = w / (ix1 - ix0)
    fy = h / (iy1 - iy0)
    newK = np.array(
        [[fx, 0.0, -fx * ix0], [0.0, fy, -fy * iy0], [0.0, 0.0, 1.0]], np.float64
    )
    # ROI convention matches OpenCV: re-run the grid through newK in float32,
    # ceil the origin, floor the *size*, intersect with the image rectangle
    (jx0, jy0, jx1, jy1), _ = _rectangles(K, dist6, w, h, newK=newK)
    # the alpha=0 inner rect spans [0,w]x[0,h] up to float32 rounding; OpenCV's
    # float32 arithmetic almost always lands a hair under the integer, so bias
    # by 1e-3 px to reproduce its (w-1, h-1)-sized ROI deterministically
    rx0, ry0 = max(int(np.ceil(jx0 - 1e-3)), 0), max(int(np.ceil(jy0 - 1e-3)), 0)
    rw = int(np.floor(jx1 - jx0 - 1e-3))
    rh = int(np.floor(jy1 - jy0 - 1e-3))
    rx1, ry1 = min(rx0 + rw, w), min(ry0 + rh, h)
    return newK, (rx0, ry0, max(rx1 - rx0, 0), max(ry1 - ry0, 0))
