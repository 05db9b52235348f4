"""``jax.image.resize``'s bilinear, for the segmentation stack.

The JAX package resizes SAM's mask logits with ``jax.image.resize``
(``segmentation/sam.py:415-426``). The card machine has no JAX, and a float
``F.interpolate`` does not match it, so it is written out here:
``jax_resize_bilinear`` is ``jax.image.resize(x, shape, "bilinear")``, a
float32 weight matrix per resized axis (``jax/_src/image/scale.py``
``compute_weight_mat``), antialiased when it downscales, contracted with the
input. The image resizes (SAM's and CLIP's inputs, the render CLI's probe)
call Pillow, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch


def _jax_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, in float32: (in_size, out_size)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def jax_resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` (antialias on) for a float
    tensor: every axis whose size changes is contracted with its weight
    matrix, on ``x``'s device."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} has {len(shape)} axes, x has {x.ndim}")
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        w = torch.as_tensor(_jax_weight_mat(m, n), dtype=x.dtype, device=x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, dims=1), -1, d)
    return x
