"""Kernels B1 and B2, the tile blend forward and backward, for CUDA tensors.

B1 (``csrc/blend_fwd.cu``) replaces
``gaussctrl_exp_tpu/ops/blend_pallas.py:_fwd_kernel`` and computes what
``ops/blend.py``'s ``rasterize_tiles_plain`` computes. B2
(``csrc/blend_bwd.cu``) replaces ``_bwd_kernel`` with the slot→gaussian
reduction of ``_blend_core_bwd`` and computes what autograd through the plain
version computes (``blend_vjp_plain``). Both are bound by fp32 operations per
evaluated pixel–gaussian pair, not by bytes; both are one CTA per 16×16 tile,
one thread per pixel, with the tile's gaussians staged through shared memory
256 at a time, and a warp evaluates only the gaussians whose footprint's box
meets its two rows (``csrc/blend_common.cuh``). B2 sums each gaussian's
gradient over the warp with a butterfly, then over the warps and tiles with
one global atomic per warp, gaussian and field.

``BlendFunction`` puts them behind autograd: forward B1, backward B2. The
sources are compiled by ``cuda_build`` at first use, with the port's other
kernels; nothing is built at import.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .binning import TileBins
from .blend import BlendOutputs, blend_vjp_plain, rasterize_tiles_plain
from .projection import BLOCK

MAX_CHANNELS = 8
_ARGTYPES = {
    "blend_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "blend_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}

launches = 0  # B1 launches since the caller last set it to 0
bwd_launches = 0  # B2 launches since the caller last set it to 0


def _library(name: str) -> ctypes.CDLL:
    return cuda_build.load(name, _ARGTYPES[name])


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(xys, conics, colors, opacs, bins: TileBins, H: int, W: int):
    """Checks the blend's inputs; returns (N, C, tiles_x, tiles_y)."""
    N, C = colors.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the blend kernels take 1..{MAX_CHANNELS} channels, got {C}")
    tiles_x = (W + BLOCK - 1) // BLOCK
    tiles_y = (H + BLOCK - 1) // BLOCK
    dev = xys.device
    f32, i32 = torch.float32, torch.int32
    _check("xys", xys, f32, (N, 2), dev)
    _check("conics", conics, f32, (N, 3), dev)
    _check("colors", colors, f32, (N, C), dev)
    _check("opacs", opacs, f32, (N,), dev)
    _check("gid", bins.gid, i32, (bins.n_isects,), dev)
    _check("tile_start", bins.tile_start, i32, (tiles_x * tiles_y,), dev)
    _check("tile_cnt", bins.tile_cnt, i32, (tiles_x * tiles_y,), dev)
    return N, C, tiles_x, tiles_y


def blend_forward(xys, conics, colors, opacs, bins: TileBins, H: int, W: int) -> BlendOutputs:
    """Launch kernel B1 on CUDA tensors (no autograd)."""
    global launches
    _, C, tiles_x, tiles_y = _check_inputs(xys, conics, colors, opacs, bins, H, W)
    dev = xys.device
    img = torch.empty((H, W, C), dtype=torch.float32, device=dev)
    final_T = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W == 0:
        return BlendOutputs(img=img, final_T=final_T)
    lib = _library("blend_fwd")
    with torch.cuda.device(dev):
        err = lib.gctorch_blend_fwd(
            xys.data_ptr(), conics.data_ptr(), colors.data_ptr(), opacs.data_ptr(),
            bins.gid.data_ptr(), bins.tile_start.data_ptr(), bins.tile_cnt.data_ptr(),
            img.data_ptr(), final_T.data_ptr(),
            H, W, tiles_x, tiles_y, C, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return BlendOutputs(img=img, final_T=final_T)


def blend_backward(
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacs: torch.Tensor,  # (N,)
    bins: TileBins,
    img: torch.Tensor,  # (H, W, C) forward residual
    final_T: torch.Tensor,  # (H, W) forward residual
    g_img: torch.Tensor,  # (H, W, C) cotangent
    g_T: torch.Tensor,  # (H, W) cotangent
    img_height: int,
    img_width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blend's VJP: (d xys, d conics, d colors, d opacs).

    CPU tensors take the plain version (autograd through the plain blend,
    which recomputes its own residuals); CUDA tensors launch kernel B2 on the
    residuals given, or raise. It never falls back."""
    global bwd_launches
    H, W = img_height, img_width
    if xys.device.type == "cpu":
        return blend_vjp_plain(xys, conics, colors, opacs, bins, g_img, g_T, H, W)
    if xys.device.type != "cuda":
        raise ValueError(f"no blend backward for device {xys.device}")
    N, C, tiles_x, tiles_y = _check_inputs(xys, conics, colors, opacs, bins, H, W)
    dev = xys.device
    _check("img", img, torch.float32, (H, W, C), dev)
    _check("final_T", final_T, torch.float32, (H, W), dev)
    _check("g_img", g_img, torch.float32, (H, W, C), dev)
    _check("g_T", g_T, torch.float32, (H, W), dev)
    grads = torch.zeros((N, 6 + C), dtype=torch.float32, device=dev)
    if H * W > 0:
        lib = _library("blend_bwd")
        with torch.cuda.device(dev):
            err = lib.gctorch_blend_bwd(
                xys.data_ptr(), conics.data_ptr(), colors.data_ptr(), opacs.data_ptr(),
                bins.gid.data_ptr(), bins.tile_start.data_ptr(), bins.tile_cnt.data_ptr(),
                img.data_ptr(), final_T.data_ptr(), g_img.data_ptr(), g_T.data_ptr(),
                grads.data_ptr(), H, W, tiles_x, tiles_y, C,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"blend_bwd kernel launch failed with CUDA error {err}")
        bwd_launches += 1
    return grads[:, 0:2], grads[:, 2:5], grads[:, 6:], grads[:, 5]


class BlendFunction(torch.autograd.Function):
    """The CUDA blend under autograd: forward kernel B1, backward kernel B2.

    Saves the inputs, the bins and the forward's outputs as the residuals of
    the backward, as the JAX package's ``_blend_core_fwd`` does."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacs, bins: TileBins, H: int, W: int):
        out = blend_forward(xys, conics, colors, opacs, bins, H, W)
        ctx.save_for_backward(xys, conics, colors, opacs, out.img, out.final_T)
        ctx.bins, ctx.hw = bins, (H, W)
        return out.img, out.final_T

    @staticmethod
    def backward(ctx, g_img, g_T):
        xys, conics, colors, opacs, img, final_T = ctx.saved_tensors
        grads = blend_backward(xys, conics, colors, opacs, ctx.bins, img, final_T,
                               g_img.contiguous(), g_T.contiguous(), *ctx.hw)
        return (*grads, None, None, None)


def rasterize_tiles(
    xys: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C), C ≤ 8
    opacs: torch.Tensor,  # (N,) or (N, 1)
    bins: TileBins,
    img_height: int,
    img_width: int,
) -> BlendOutputs:
    """Tile blend: the plain version for CPU tensors, kernel B1 for CUDA ones,
    behind ``BlendFunction`` (backward B2) when an input requires grad.

    On CUDA it launches the kernels or raises; it never falls back."""
    opacs = opacs.reshape(-1)
    if xys.device.type == "cpu":
        return rasterize_tiles_plain(xys, conics, colors, opacs, bins, img_height, img_width)
    if xys.device.type != "cuda":
        raise ValueError(f"no blend for device {xys.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xys, conics, colors, opacs)):
        img, final_T = BlendFunction.apply(xys, conics, colors, opacs, bins, img_height, img_width)
        return BlendOutputs(img=img, final_T=final_T)
    return blend_forward(xys, conics, colors, opacs, bins, img_height, img_width)
