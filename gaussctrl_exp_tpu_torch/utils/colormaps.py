"""Colormaps for rendered outputs (depth/accumulation), host-side numpy.

Copy of ``gaussctrl_exp_tpu/utils/colormaps.py``: turbo-mapped depth with
percentile normalization.
"""

from __future__ import annotations

import numpy as np

# 16-stop turbo approximation (matplotlib-free)
_TURBO = np.array(
    [
        [0.190, 0.072, 0.232], [0.276, 0.180, 0.648], [0.273, 0.351, 0.952],
        [0.199, 0.522, 0.989], [0.096, 0.684, 0.855], [0.063, 0.808, 0.640],
        [0.168, 0.896, 0.424], [0.373, 0.956, 0.233], [0.606, 0.982, 0.108],
        [0.797, 0.947, 0.104], [0.925, 0.857, 0.133], [0.989, 0.720, 0.126],
        [0.984, 0.542, 0.077], [0.918, 0.347, 0.028], [0.800, 0.175, 0.004],
        [0.640, 0.057, 0.002],
    ],
    np.float32,
)


def apply_turbo(x: np.ndarray) -> np.ndarray:
    """(H, W) values in [0,1] → (H, W, 3) turbo colours."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0) * (len(_TURBO) - 1)
    i0 = np.floor(x).astype(int)
    i1 = np.minimum(i0 + 1, len(_TURBO) - 1)
    f = (x - i0)[..., None]
    return _TURBO[i0] * (1 - f) + _TURBO[i1] * f


def apply_depth_colormap(
    depth: np.ndarray, accumulation: np.ndarray | None = None, near_plane=None, far_plane=None
) -> np.ndarray:
    """Percentile-normalized turbo depth, optionally alpha-composited."""
    depth = np.asarray(depth, np.float32).squeeze()
    finite = depth[np.isfinite(depth) & (depth < 999.0)]
    lo = near_plane if near_plane is not None else (np.percentile(finite, 2) if finite.size else 0.0)
    hi = far_plane if far_plane is not None else (np.percentile(finite, 98) if finite.size else 1.0)
    norm = (depth - lo) / max(hi - lo, 1e-6)
    img = apply_turbo(1.0 - np.clip(norm, 0, 1))
    if accumulation is not None:
        img = img * np.asarray(accumulation).squeeze()[..., None]
    return img
