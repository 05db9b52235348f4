"""The two bilinear resizes the segmentation stack takes from libraries.

The JAX package resizes SAM's and CLIP's input images with PIL
(``segmentation/sam.py:402-408``, ``grounding.py:165``) and SAM's mask logits
with ``jax.image.resize`` (``sam.py:415-426``). The card machine has neither
PIL nor JAX, and a float ``F.interpolate`` matches neither, so both are
written out here:

- ``pil_bilinear_uint8`` is Pillow's ``Image.resize(..., BILINEAR)`` on a
  uint8 image (``libImaging/Resample.c``): two passes, horizontal then
  vertical, each rounded to uint8; each output pixel's triangle filter is
  widened by the scale when downscaling; its coefficients are fixed point
  with 22 fractional bits, and each sum starts at a half and is clipped.
  The coefficients are computed in float64 as Pillow's C does, so the output
  is Pillow's bit for bit.
- ``jax_resize_bilinear`` is ``jax.image.resize(x, shape, "bilinear")``:
  a float32 weight matrix per resized axis (``jax/_src/image/scale.py``
  ``compute_weight_mat``), antialiased when it downscales, contracted with
  the input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRECISION_BITS = 22  # Pillow's 32 - 8 - 2


def _pil_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` (BILINEAR, support 1) and
    ``normalize_coeffs_8bpc``: per output pixel, the first input pixel and
    ``ksize`` fixed-point coefficients (0 past the pixel's support)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((t < 1.0) & (x[None] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # C's left-to-right sum
    k = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    kk = np.where(k < 0, np.trunc(-0.5 + k * (1 << PRECISION_BITS)), np.trunc(0.5 + k * (1 << PRECISION_BITS)))
    return xmin, kk.astype(np.int64)


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One of Pillow's 8-bit passes along ``axis`` (0 rows, 1 columns)."""
    in_size = img.shape[axis]
    if in_size == out_size:  # Pillow skips a pass whose size is unchanged
        return img
    xmin, kk = _pil_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]), in_size - 1)  # coefficient 0 where clipped
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)  # (in, other, C)
    kk = kk.astype(np.int32)  # Pillow's INT32 sums: at most 255 · 2^22 · (1 + rounding)
    acc = np.full((out_size, *src.shape[1:]), 1 << (PRECISION_BITS - 1), np.int32)
    for j in range(kk.shape[1]):  # a few filter taps: exact integer sums, in Pillow's order
        acc += src[idx[:, j]] * kk[:, j, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_uint8(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))`` for
    an (H, W) or (H, W, C) uint8 image; ``size`` is (width, height), as
    PIL's."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"pil_bilinear_uint8 takes uint8, got {img.dtype}")
    w, h = size
    x = img[..., None] if img.ndim == 2 else img
    out = _pil_pass(_pil_pass(x, 1, w), 0, h)  # horizontal, then vertical
    return out[..., 0] if img.ndim == 2 else out


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
