"""Video post-processing: spherical MP4 metadata + stereo stacking.

The port's own copy of ``gaussctrl_exp_tpu/utils/video.py`` (numpy and the
standard library only). ``insert_spherical_metadata`` injects the Google
spherical-video v1 uuid atom into ``moov/trak`` by raw ISO-BMFF box surgery
(the reference's gc_render.py:314-381); ``stack_stereo`` stacks the two
eyes of an omnidirectional-stereo (top-bottom) or VR180 (left-right) frame
as an array op, so it needs no ffmpeg.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# Google spatial-media spherical-video v1 uuid (public spec identifier)
SPHERICAL_UUID = bytes.fromhex("ffcc8263f8554a938814587a02521fdd")

_SPHERICAL_XML = """<rdf:SphericalVideo
xmlns:rdf='http://www.w3.org/1999/02/22-rdf-syntax-ns#'
xmlns:GSpherical='http://ns.google.com/videos/1.0/spherical/'>
<GSpherical:ProjectionType>equirectangular</GSpherical:ProjectionType>
<GSpherical:Spherical>True</GSpherical:Spherical>
<GSpherical:Stitched>True</GSpherical:Stitched>
<GSpherical:StitchingSoftware>gaussctrl_exp_tpu</GSpherical:StitchingSoftware>{stereo}
</rdf:SphericalVideo>"""

_STEREO_TAG = "\n<GSpherical:StereoMode>{mode}</GSpherical:StereoMode>"


def _walk_boxes(buf: bytes, start: int, end: int):
    """Yield (pos, size, tag) for top-level ISO-BMFF boxes in buf[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, tag = struct.unpack(">I4s", buf[pos : pos + 8])
        if size == 1:  # 64-bit largesize
            size = struct.unpack(">Q", buf[pos + 8 : pos + 16])[0]
        if size < 8:
            break
        yield pos, size, tag
        pos += size


def insert_spherical_metadata(path: Path, stereo_mode: str | None = None) -> None:
    """Insert the spherical-video uuid atom into ``moov/trak`` in-place.

    ``stereo_mode``: None, "top-bottom" (ODS) or "left-right" (VR180).
    Unlike the reference's seek-based version this rewrites the file from a
    full in-memory copy, so it also works when moov is not the final atom.
    """
    data = bytearray(Path(path).read_bytes())
    stereo = _STEREO_TAG.format(mode=stereo_mode) if stereo_mode else ""
    xml = _SPHERICAL_XML.format(stereo=stereo).encode()
    insert = struct.pack(">I4s16s", len(xml) + 24, b"uuid", SPHERICAL_UUID) + xml

    moov = next((b for b in _walk_boxes(data, 0, len(data)) if b[2] == b"moov"), None)
    if moov is None:
        raise ValueError(f"{path}: no moov atom found")
    mpos, msize, _ = moov
    trak = next(
        (b for b in _walk_boxes(data, mpos + 8, mpos + msize) if b[2] == b"trak"), None
    )
    if trak is None:
        raise ValueError(f"{path}: no trak atom inside moov")
    tpos, tsize, _ = trak

    # grow trak and moov headers, splice the uuid atom at the end of trak
    struct.pack_into(">I", data, mpos, msize + len(insert))
    struct.pack_into(">I", data, tpos, tsize + len(insert))
    out = data[: tpos + tsize] + insert + data[tpos + tsize :]
    Path(path).write_bytes(bytes(out))


def read_spherical_metadata(path: Path) -> bytes | None:
    """Return the spherical XML payload if present (for tests/round-trip)."""
    data = Path(path).read_bytes()
    moov = next((b for b in _walk_boxes(data, 0, len(data)) if b[2] == b"moov"), None)
    if moov is None:
        return None
    mpos, msize, _ = moov
    for tpos, tsize, tag in _walk_boxes(data, mpos + 8, mpos + msize):
        if tag != b"trak":
            continue
        for pos, size, btag in _walk_boxes(data, tpos + 8, tpos + tsize):
            if btag == b"uuid" and data[pos + 8 : pos + 24] == SPHERICAL_UUID:
                return bytes(data[pos + 24 : pos + size])
    return None


def stack_stereo(left: np.ndarray, right: np.ndarray, mode: str) -> np.ndarray:
    """Stack per-eye frames: ODS = left over right (vertical, gc_render.py:566),
    VR180 = left|right side by side (gc_render.py:585 hstacks [right, left] as
    inputs 1,0 → left first)."""
    if mode == "ods":
        return np.concatenate([left, right], axis=0)
    if mode == "vr180":
        return np.concatenate([left, right], axis=1)
    raise ValueError(f"unknown stereo mode {mode!r}")
