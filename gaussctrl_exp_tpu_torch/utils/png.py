"""Minimal PNG writer and reader (stdlib ``zlib`` + ``struct`` + numpy).

The writer writes 8-bit RGB with filter type 0 on every row. The reader
reads the PNGs that scenes hold: 8-bit, non-interlaced, colour types 0, 2,
3, 4 and 6 (grey, RGB, palette, grey + alpha, RGBA) with row filters 0-4
(None, Sub, Up, Average, Paeth), and returns RGB as PIL's
``convert("RGB")`` does: alpha dropped, grey replicated, palette looked up.
Anything else (16-bit or sub-byte samples, interlaced) raises and names
the file.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def is_png(path: str | Path) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(len(_SIGNATURE)) == _SIGNATURE


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, bpp) filtered bytes.

    Each pixel's predictor reads its left, upper and upper-left neighbours
    (zero outside the image), so every pixel of one anti-diagonal r + x = d
    depends only on earlier ones: the diagonals are decoded in order, each
    as one vector over its pixels, whatever their rows' filters."""
    h, w, bpp = filt.shape
    if not ftype.any():
        return filt
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # one zero row and column in front
    f = filt.astype(np.int32)
    t = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        tr = t[r][:, None]
        pred = np.select([tr == 1, tr == 2, tr == 3, tr == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """Read a PNG as an (H, W, 3) uint8 RGB array."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header, palette = len(_SIGNATURE), [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if depth != 8 or ctype not in _CHANNELS or compression or filter_method or interlace:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace {interlace}: only 8-bit, "
            "non-interlaced grey, RGB, palette, grey + alpha and RGBA PNGs are read"
        )
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: row filter {int(rows[:, 0].max())} is not one of 0-4")
    px = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        if px.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE chunk's {len(palette)} entries")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])
