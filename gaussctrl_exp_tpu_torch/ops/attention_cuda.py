"""Kernel B3, the flash-attention forward, for CUDA tensors.

B3 (``csrc/flash_attn_fwd.cu``) replaces
``gaussctrl_exp_tpu/diffusion/attention.py:_flash_sdpa`` (the library TPU
flash attention) and computes what ``sdpa_plain`` computes: the non-causal
``softmax(Q·Kᵀ·D^-½)·V`` of (B, H, S, D) queries against (B, H, T, D) keys
and values, with an fp32 softmax. bf16 runs on the tensor cores
(``mma.sync``), fp32 on scalar FMAs; both accumulate in fp32 and return the
input's type. It is bound by operations at the edit path's shapes; its source
says how its design meets that.

``diffusion/attention.py``'s ``_sdpa`` sends every CUDA call here and every
CPU call to ``sdpa_plain``. ``flash_attn`` launches the kernel or raises: it
never falls back.
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from . import cuda_build

MAX_HEAD_DIM = 160
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]

launches = 0  # B3 launches since the caller last set it to 0
copies = 0  # inputs the wrapper made contiguous (D not contiguous, or misaligned)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) scaled dot-product attention with an fp32 softmax: the
    JAX package's ``_sdpa`` math path, in its order of roundings."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _strided(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: D contiguous, and for bf16 every row
    start on a 4-byte boundary (the kernel loads pairs of values)."""
    global copies
    ok = t.stride(-1) == 1
    if t.dtype == torch.bfloat16:
        ok = ok and t.data_ptr() % 4 == 0 and all(s % 2 == 0 for s in t.stride()[:-1])
    if ok:
        return t
    warnings.warn(f"flash_attn: {name} with strides {t.stride()} is copied to a contiguous tensor",
                  stacklevel=3)
    copies += 1
    return t.contiguous()


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch kernel B3 on CUDA tensors q (B, H, S, D), k and v (B, H, T, D),
    all bf16 or all fp32, D a multiple of 8 up to 160. Returns (B, H, S, D) in
    the input's type, laid out as (B, S, H, D) so that merging the heads back
    is a view. Raises on anything else."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attn: {name} is on {t.device}; kernel B3 takes CUDA tensors "
                             "(diffusion.attention._sdpa sends CPU tensors to sdpa_plain)")
        if t.device != q.device:
            raise ValueError(f"flash_attn: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"flash_attn: {name} has dtype {t.dtype}; all of q, k, v must be "
                            "bfloat16 or all float32")
        if t.dim() != 4:
            raise ValueError(f"flash_attn: {name} has shape {tuple(t.shape)}, expected (B, H, L, D)")
    B, H, S, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, H, T, D) or tuple(v.shape) != (B, H, T, D):
        raise ValueError(f"flash_attn: k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if D % 8 != 0 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {D} is not a multiple of 8 in 8..{MAX_HEAD_DIM}")
    if S == 0 or T == 0 or B * H == 0:
        raise ValueError(f"flash_attn: empty attention q {tuple(q.shape)} k {tuple(k.shape)}")
    if B * H > 65535:
        raise ValueError(f"flash_attn: B·H = {B * H} exceeds the grid's 65535")
    q, k, v = _strided("q", q), _strided("k", k), _strided("v", v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = cuda_build.load("flash_attn_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.gctorch_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, S, T, D, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return out
