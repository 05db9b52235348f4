"""Native (C++) host code of the data loader, built with ``g++`` and bound
with ctypes.

Port of ``gaussctrl_exp_tpu/native/__init__.py`` over the port's own copies
of its sources: ``plyio.cpp`` (the PLY reader) and ``imageio.cpp`` (the
baseline JPEG decoder, the bilinear undistort remap and the threaded batch
loader). Each library is built at first use into
``gaussctrl_exp_tpu_torch/_build/``, keyed by a hash of its source and flags,
through a temporary file renamed into place, so processes that build the
same library at once do not read a half-written one. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

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
    """The image library (JPEG decode, undistort, threaded batch loader),
    built on first use."""
    return _load("imageio", {
        "undistort_f32": (None, [_P, _I, _I, _I, _P, _P, _P, _P]),
        "load_undistort_batch": (_I, [ctypes.POINTER(ctypes.c_char_p), _I, _I, _I, _P, _P, _P, _P, _P, _I]),
    })

