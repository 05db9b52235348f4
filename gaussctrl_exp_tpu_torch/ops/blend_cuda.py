"""Kernel B1, the tile blend forward, for CUDA tensors; its build and wrapper.

The kernel (``csrc/blend_fwd.cu``) replaces
``gaussctrl_exp_tpu/ops/blend_pallas.py:_fwd_kernel``. It computes what
``ops/blend.py``'s ``rasterize_tiles_plain`` computes. It is bound by fp32
operations (~20 + 2C per evaluated pixel–gaussian pair), not by bytes; the
design is one CTA per 16×16 tile, one thread per pixel, the tile's gaussians
staged through shared memory 256 at a time, and an early exit once every
pixel of the tile has stopped.

The source is compiled with ``nvcc`` at first use into a plain-C shared
library under ``gaussctrl_exp_tpu_torch/_build/``, keyed by a hash of the
source, and loaded with ``ctypes``. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .binning import TileBins
from .blend import BlendOutputs, rasterize_tiles_plain
from .projection import BLOCK

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "blend_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]
MAX_CHANNELS = 8

launches = 0  # kernel launches since the caller last set it to 0
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the blend kernel is built from source with nvcc")
    return path


def build() -> Path:
    """Compile ``csrc/blend_fwd.cu`` unless a library for this source exists."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"blend_fwd_{key}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.gctorch_blend_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rasterize_tiles(
    xys: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C), C ≤ 8
    opacs: torch.Tensor,  # (N,) or (N, 1)
    bins: TileBins,
    img_height: int,
    img_width: int,
) -> BlendOutputs:
    """Tile blend: the plain version for CPU tensors, kernel B1 for CUDA ones.

    On CUDA it launches the kernel or raises; it never falls back. The
    kernel is forward-only: inputs that require grad are refused.
    """
    global launches
    opacs = opacs.reshape(-1)
    if xys.device.type == "cpu":
        return rasterize_tiles_plain(xys, conics, colors, opacs, bins, img_height, img_width)
    if xys.device.type != "cuda":
        raise ValueError(f"no blend for device {xys.device}")
    if any(t.requires_grad for t in (xys, conics, colors, opacs)):
        raise NotImplementedError(
            "the CUDA blend is forward-only; its backward (kernel B2) comes with the training slice"
        )
    N, C = colors.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the blend kernel takes 1..{MAX_CHANNELS} channels, got {C}")
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    dev = xys.device
    f32, i32 = torch.float32, torch.int32
    _check("xys", xys, f32, (N, 2), dev)
    _check("conics", conics, f32, (N, 3), dev)
    _check("colors", colors, f32, (N, C), dev)
    _check("opacs", opacs, f32, (N,), dev)
    _check("gid", bins.gid, i32, (bins.n_isects,), dev)
    _check("tile_start", bins.tile_start, i32, (tiles_x * tiles_y,), dev)
    _check("tile_cnt", bins.tile_cnt, i32, (tiles_x * tiles_y,), dev)

    img = torch.empty((img_height, img_width, C), dtype=f32, device=dev)
    final_T = torch.empty((img_height, img_width), dtype=f32, device=dev)
    if img_height * img_width == 0:
        return BlendOutputs(img=img, final_T=final_T)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.gctorch_blend_fwd(
            xys.data_ptr(), conics.data_ptr(), colors.data_ptr(), opacs.data_ptr(),
            bins.gid.data_ptr(), bins.tile_start.data_ptr(), bins.tile_cnt.data_ptr(),
            img.data_ptr(), final_T.data_ptr(),
            img_height, img_width, tiles_x, tiles_y, C, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return BlendOutputs(img=img, final_T=final_T)
