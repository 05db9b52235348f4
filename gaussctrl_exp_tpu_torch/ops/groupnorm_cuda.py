"""Kernel N1: GroupNorm, and optionally SiLU after it, of bf16 channels-last
activations with float32 scale and bias, for CUDA tensors.

N1 (``csrc/group_norm_nhwc.cu``) replaces no TPU kernel (Flax's GroupNorm
is left to XLA); it lets the UNet and the ControlNet keep their activations
NHWC on the card, where torch's CUDA ``group_norm`` takes only NCHW. It
computes what ``group_norm_plain`` computes: float32 statistics of each
(sample, group), the float32 scale and bias applied in float32 and rounded
once to the input's type (Flax's order), then SiLU of that rounded value,
rounded again. The source says what bounds it and how its design meets that.

``group_norm_nhwc`` launches N1 for a CUDA tensor and runs the plain version
for a CPU one; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

KERNEL = "gctorch_gn_nhwc"  # the prefix of its two kernels' names, as torch.profiler shows them
MAX_THREADS = 512  # a CTA's rows × C/8 threads
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

launches = 0  # calls of N1 (two kernels each) since the caller last set it to 0


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                     silu: bool = False) -> torch.Tensor:
    """``F.group_norm`` of ``x`` in float32 with the float32 ``weight`` and
    ``bias``, rounded to ``x``'s type, then SiLU where ``silu``."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps).to(x.dtype)
    return F.silu(y) if silu else y


def chunks(B: int, HW: int, C: int, sms: int) -> tuple[int, int, int]:
    """(K, P, R): each sample's H·W positions in K chunks of P, one CTA per
    chunk and sample: about two CTAs an SM and never more (one wave), at
    most ``sms`` chunks a sample (every CTA of the second pass merges its
    sample's K partials), and no fewer than R positions a chunk; R rows of
    C/8 threads a CTA, at most ``MAX_THREADS`` threads."""
    R = max(1, MAX_THREADS // (C // 8))
    K = max(1, min(2 * sms // B, sms, -(-HW // R)))
    P = max(min(R, HW), -(-HW // K))
    return -(-HW // P), P, R


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_nhwc: x is on {x.device}; N1 takes CUDA tensors")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"group_norm_nhwc: x is {x.dtype} {tuple(x.shape)}; N1 takes bf16 (B, C, H, W)")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError(f"group_norm_nhwc: x with strides {x.stride()} is not channels-last contiguous "
                         "on a 16-byte boundary")
    B, C = x.shape[:2]
    if C % 8 or C % groups or C > 8 * MAX_THREADS or groups > 32:
        raise ValueError(f"group_norm_nhwc: {C} channels in {groups} groups; N1 takes C a multiple of 8 and "
                         f"of the groups, up to {8 * MAX_THREADS}, in at most 32 groups")
    if not 1 <= B <= 65535 or x.shape[2] * x.shape[3] == 0:
        raise ValueError(f"group_norm_nhwc: shape {tuple(x.shape)} is empty or over the grid's 65535 samples")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (C,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"group_norm_nhwc: {name} is {p.dtype} {tuple(p.shape)} on {p.device}; N1 takes "
                             f"contiguous float32 ({C},) on {x.device}")


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) of ``x`` (B, C, H, W), channels-last: N1 on a CUDA
    tensor (bf16, C a multiple of 8 and of ``groups``, float32 ``weight``
    and ``bias``; raises on anything else), the plain version on a CPU one.
    The output is channels-last like ``x``."""
    global launches
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    _check(x, weight, bias, groups)
    B, C, H, W = x.shape
    K, P, R = chunks(B, H * W, C, torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty_like(x)
    part = torch.empty((B, K, groups, 2), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("group_norm_nhwc", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.gctorch_group_norm_nhwc(x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                          part.data_ptr(), B, H * W, C, groups, K, P, R, eps, int(silu),
                                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_nhwc kernel launch failed with CUDA error {err}")
    launches += 1
    return y
