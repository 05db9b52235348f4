"""Animated-GIF writer (numpy + the native LZW), in place of PIL's GIF save.

The JAX package's render CLI falls back to
``Image.save(p, save_all=True, append_images=..., duration=int(1000 / fps),
loop=0)`` when it has no mp4 writer (``cli/render.py:224-228``). The port
writes the same file without PIL: GIF89a, a NETSCAPE2.0 loop count, one
graphic control extension per frame with the delay in centiseconds
(``int(duration / 10)``, as PIL stores it), and each frame as a 256-entry
local colour table and its LZW-compressed indices
(``native.lzw_encode``).

The palette is per frame, as PIL's save makes it. A frame with at most 256
colours keeps them exactly; otherwise median cut over the frame's colours
at 5 bits a channel gives 256 boxes, each entry the mean of its box's
pixels, and every colour takes its nearest entry, as PIL maps pixels.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Sequence

import numpy as np

from ..native import lzw_encode


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Split the (K, 3) colours (weights ``counts``) into at most ``n``
    boxes: the box with the most pixels among those with more than one
    colour is cut at the weighted median of its widest channel. Returns
    each colour's box, (K,)."""
    def weight(b):  # -1: a single colour, cannot be cut
        return counts[b].sum() if np.ptp(colors[b], axis=0).max() > 0 else -1.0

    boxes = [np.arange(len(colors))]
    weights = [weight(boxes[0])]
    while len(boxes) < n:
        k = int(np.argmax(weights))
        if weights[k] < 0:
            break
        b = boxes.pop(k)
        weights.pop(k)
        axis = int(np.argmax(np.ptp(colors[b], axis=0)))
        b = b[np.argsort(colors[b, axis], kind="stable")]
        cum = np.cumsum(counts[b])
        cut = min(int(np.searchsorted(cum, cum[-1] / 2.0)), len(b) - 2) + 1  # both halves non-empty
        for half in (b[:cut], b[cut:]):
            boxes.append(half)
            weights.append(weight(half))
    which = np.empty(len(colors), np.int64)
    for i, b in enumerate(boxes):
        which[b] = i
    return which


def quantize_adaptive(rgb: np.ndarray, n: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(palette (≤ n, 3) uint8, (H, W) uint8 indices) for one frame."""
    flat = rgb.reshape(-1, 3)
    key = (flat[:, 0].astype(np.int32) << 16) | (flat[:, 1].astype(np.int32) << 8) | flat[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) <= n:  # exact
        pal = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1).astype(np.uint8)
        return pal, inv.reshape(rgb.shape[:2]).astype(np.uint8)
    q = flat >> 3
    q15 = (q[:, 0].astype(np.int32) << 10) | (q[:, 1].astype(np.int32) << 5) | q[:, 2]
    counts = np.bincount(q15, minlength=1 << 15)
    bins = np.nonzero(counts)[0]
    centres = np.stack([bins >> 10, (bins >> 5) & 31, bins & 31], -1).astype(np.float64) * 8 + 4
    which = _median_cut(centres, counts[bins].astype(np.float64), n)
    # each box's entry is the mean of its pixels; each bin (by the mean of
    # its pixels) then takes its nearest entry, as PIL maps pixels
    sums = np.stack([np.bincount(q15, flat[:, c].astype(np.float64), minlength=1 << 15)[bins] for c in range(3)], -1)
    box_n = np.bincount(which, counts[bins], minlength=which.max() + 1)
    pal = np.stack([np.bincount(which, sums[:, c]) for c in range(3)], -1) / box_n[:, None]
    pal = np.clip(np.rint(pal), 0, 255)
    lut = np.zeros(1 << 15, np.uint8)
    bin_means = sums / counts[bins, None]
    for i in range(0, len(bins), 4096):  # (4096, 256) distances at a time
        d = -2 * bin_means[i : i + 4096] @ pal.T + (pal**2).sum(1)
        lut[bins[i : i + 4096]] = d.argmin(1)
    return pal.astype(np.uint8), lut[q15].reshape(rgb.shape[:2])


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i : i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out) + b"\x00"


def write_gif(path: str | Path, frames: Sequence[np.ndarray], duration_ms: int, loop: int = 0) -> None:
    """Write (H, W, 3) uint8 frames of one size as an animated GIF that shows
    each for ``duration_ms`` (stored in centiseconds, truncated, as PIL
    does) and loops ``loop`` times (0: forever)."""
    if not frames:
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0x70, 0, 0)  # no global colour table, 8-bit colour resolution
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    delay = int(duration_ms / 10)
    for f in frames:
        f = np.ascontiguousarray(f)
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"frame {f.shape} {f.dtype}: expected ({h}, {w}, 3) uint8")
        pal, idx = quantize_adaptive(f)
        table = np.zeros((256, 3), np.uint8)
        table[: len(pal)] = pal
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)  # local table of 2^(7+1) entries
        out += table.tobytes()
        out += b"\x08" + _sub_blocks(lzw_encode(idx, 8))
    out += b"\x3b"
    Path(path).write_bytes(bytes(out))
