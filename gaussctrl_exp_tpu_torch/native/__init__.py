"""Native (C++) host code of the data loader, built with ``g++`` and bound
with ctypes.

Port of ``gaussctrl_exp_tpu/native/__init__.py`` over the port's own copies
of its sources: ``plyio.cpp`` (the PLY reader) and ``imageio.cpp`` (the
baseline JPEG decoder, the bilinear undistort remap and the threaded batch
loader, plus the writers PIL serves in the JAX package: a baseline JPEG
encoder and the GIF writer's LZW). Each library is built at first use into
``gaussctrl_exp_tpu_torch/_build/``, keyed by a hash of its source and
flags, through a temporary file renamed into place, so processes that build
the same library at once do not read a half-written one. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_EXTRA = {"plyio": [], "imageio": ["-pthread"]}
_libs: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """The library of ``native/<name>.cpp``, keyed by its bytes and flags."""
    flags = GXX_FLAGS + _EXTRA[name]
    h = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; returns it."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *_EXTRA[name], str(_DIR / f"{name}.cpp"), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {name}.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load(name: str, signatures: dict) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


_P, _I = ctypes.c_void_p, ctypes.c_int


def get_plyio() -> ctypes.CDLL:
    """The PLY reader library, built on first use."""
    return _load("plyio", {
        "ply_open": (_P, [ctypes.c_char_p]),
        "ply_num_vertices": (ctypes.c_long, [_P]),
        "ply_has_rgb": (_I, [_P]),
        "ply_read": (_I, [_P, _P, _P]),
        "ply_close": (None, [_P]),
    })


def get_imageio() -> ctypes.CDLL:
    """The image library (JPEG decode and encode, GIF LZW, undistort,
    threaded batch loader), built on first use."""
    return _load("imageio", {
        "img_open": (_P, [ctypes.c_char_p]),
        "img_width": (_I, [_P]),
        "img_height": (_I, [_P]),
        "img_copy": (None, [_P, _P]),
        "img_close": (None, [_P]),
        "img_decode": (_P, [_P, ctypes.c_long]),
        "jpeg_encode": (_P, [_P, _I, _I, _I]),
        "gif_lzw": (_P, [_P, ctypes.c_long, _I]),
        "buf_size": (ctypes.c_long, [_P]),
        "buf_copy": (None, [_P, _P]),
        "buf_free": (None, [_P]),
        "undistort_f32": (None, [_P, _I, _I, _I, _P, _P, _P, _P]),
        "load_undistort_batch": (_I, [ctypes.POINTER(ctypes.c_char_p), _I, _I, _I, _P, _P, _P, _P, _P, _I]),
    })


def _take(lib: ctypes.CDLL, handle) -> bytes:
    """The bytes of a buffer handle, which is freed."""
    try:
        out = np.empty(lib.buf_size(handle), np.uint8)
        lib.buf_copy(handle, out.ctypes.data_as(_P))
        return out.tobytes()
    finally:
        lib.buf_free(handle)


def _image(lib: ctypes.CDLL, handle, what) -> np.ndarray:
    if not handle:
        raise ValueError(f"{what}: not a baseline JPEG the native decoder reads")
    try:
        out = np.empty((lib.img_height(handle), lib.img_width(handle), 3), np.uint8)
        lib.img_copy(handle, out.ctypes.data_as(_P))
        return out
    finally:
        lib.img_close(handle)


def read_jpeg(path: str | Path) -> np.ndarray:
    """A baseline JPEG file as (H, W, 3) uint8 RGB."""
    lib = get_imageio()
    return _image(lib, lib.img_open(str(path).encode()), path)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes as (H, W, 3) uint8 RGB."""
    lib = get_imageio()
    buf = np.frombuffer(data, np.uint8)
    return _image(lib, lib.img_decode(buf.ctypes.data_as(_P), buf.size), "JPEG bytes")


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """An (H, W, 3) uint8 RGB image as baseline JPEG bytes: the standard
    tables at libjpeg's ``quality`` scaling, 4:2:0 chroma (PIL's defaults;
    PIL's default quality is 75)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality} is not in 1..100")
    lib = get_imageio()
    h, w, _ = rgb.shape
    return _take(lib, lib.jpeg_encode(rgb.ctypes.data_as(_P), w, h, int(quality)))


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's LZW code stream (clear code first, end-of-information last) of
    palette ``indices`` (uint8, each < 2 ** min_code_size)."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    lib = get_imageio()
    return _take(lib, lib.gif_lzw(idx.ctypes.data_as(_P), idx.size, int(min_code_size)))
