"""Kernel E1: the depth generator's epipolar cross-view term, one launch for
each mixing self-attention, for CUDA tensors.

E1 (``csrc/epipolar_attn.cu``) replaces no TPU kernel: the JAX package
leaves the term to XLA. It computes what
``diffusion/correspondence.epipolar_mix_plain`` computes (the plain version,
per ordered view pair a 9-tap gather, two einsums and a softmax): for every
row (g, a) of the CFG-doubled batch, ``mix · out_self + (1 − mix)`` times the
pair-mask-weighted mean over a's partners b of the softmax-weighted sum of
the 9 epipolar taps' values of view g·V + b, in float32 for bf16 and float32
inputs alike, rounded once to the input's type. The source says what bounds
it and how its design meets that.

The tables and the pair mask go to the kernel's form once, when the
processor is built: ``convert_tables`` (int32 indices, float32
log-weights) and ``partner_plan`` (each view's partners, their weights and
the divisor). ``takes`` says whether E1 takes a call; the processor
(``correspondence.make_multires_epipolar_processor``) sends every other call,
CPU tensors and calls that autograd records, to the plain version.
``epipolar_attn`` launches E1 or raises: it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import attention_cuda, cuda_build

TAPS = 9
MAX_HEAD_DIM = 160
MAX_HEADS = 32  # a warp holds a token's heads, each on 32 / H' lanes (H' the power of two ≥ H)
MAX_VECTORS = 10  # 16-byte vectors of a head that one lane holds
KERNEL = "gctorch_epipolar_e1"  # its name as torch.profiler shows it
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 15 + [ctypes.c_float] * 3 + [
    ctypes.c_void_p]

launches = 0  # E1 launches since the caller last set it to 0


def convert_tables(nbr_idx: torch.Tensor, nbr_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(V, V, S, 9) tap indices and weights → E1's int32 indices and float32
    log-weights log(max(w, 1e-12)), contiguous, on the tables' device."""
    idx = nbr_idx.to(torch.int32).contiguous()
    logw = torch.log(torch.clamp(nbr_w.float(), min=1e-12)).contiguous()
    return idx, logw


def partner_plan(pm: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (V, V) pair mask (its diagonal 0) → E1's partner plan on ``device``:
    int32 (V, V + 1) rows [n, b_0, ..., b_{n-1}, 0, ...] of each view's
    partners b in order (pm[a, b] ≠ 0), and float32 (V, V + 1) rows
    [max(Σ_b pm[a, b], 1), pm[a, b_0], ...]."""
    pm = np.asarray(pm)
    V = pm.shape[0]
    partners = np.zeros((V, V + 1), np.int32)
    weights = np.zeros((V, V + 1), np.float32)
    for a in range(V):
        bs = np.flatnonzero(pm[a])
        partners[a, 0], partners[a, 1 : 1 + len(bs)] = len(bs), bs
        weights[a, 0], weights[a, 1 : 1 + len(bs)] = max(float(pm[a].sum()), 1.0), pm[a, bs]
    return torch.as_tensor(partners, device=device), torch.as_tensor(weights, device=device)


def lanes_per_head(H: int) -> int:
    """Lanes of a warp that hold one head's channels: 32 over the power of
    two at or above H."""
    return 32 // (1 << (H - 1).bit_length())


def vectors_per_lane(H: int, D: int, dtype: torch.dtype) -> int:
    """16-byte vectors of a head's D channels that one lane holds."""
    per_head = D * (2 if dtype == torch.bfloat16 else 4) // 16
    return -(-per_head // lanes_per_head(H))


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether E1 takes the self-attention q, k, v (B, H, S, D): CUDA tensors
    of one type, bf16 or float32, D a multiple of 8 up to 160, at most 32
    heads whose channels fit a warp (``MAX_VECTORS`` a lane), and autograd not
    recording (E1 has no backward)."""
    if q.device.type != "cuda" or q.dtype not in (torch.bfloat16, torch.float32) or q.dim() != 4:
        return False
    if any(t.dtype != q.dtype or t.device != q.device or t.shape != q.shape for t in (k, v)):
        return False
    _, H, _, D = q.shape
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM or not 1 <= H <= MAX_HEADS or vectors_per_lane(H, D, q.dtype) > MAX_VECTORS:
        return False
    return not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad))


def epipolar_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_self: torch.Tensor, idx: torch.Tensor,
                  logw: torch.Tensor, partners: torch.Tensor, weights: torch.Tensor, mix: float) -> torch.Tensor:
    """Launch kernel E1 on the self-attention q, k, v (B, H, S, D) that
    ``takes`` takes, ``out_self`` its self-attention (same shape and type),
    the batch V = ``partners.shape[0]`` views a CFG group, with the tables
    (``convert_tables``: (V, V, S, 9)) and the plan (``partner_plan``). Reads
    every input in place (a misaligned one is copied and counted in
    ``attention_cuda.copies``). Returns (B, H, S, D) in the input's type, laid
    out as (B, S, H, D). Raises on anything else."""
    global launches
    if not takes(q, k, v):
        raise ValueError(f"epipolar_attn: kernel E1 does not take q {tuple(q.shape)} {q.dtype} on {q.device} with "
                         f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype} (or autograd records the call)")
    B, H, S, D = q.shape
    V = partners.shape[0]
    if out_self.shape != q.shape or out_self.dtype != q.dtype or out_self.device != q.device:
        raise ValueError(f"epipolar_attn: out_self {tuple(out_self.shape)} {out_self.dtype} does not match q")
    if B % V or B > 65535:
        raise ValueError(f"epipolar_attn: batch {B} is not CFG groups of {V} views (at most 65535 rows)")
    for name, t, dtype, shape in (("idx", idx, torch.int32, (V, V, S, TAPS)),
                                  ("logw", logw, torch.float32, (V, V, S, TAPS)),
                                  ("partners", partners, torch.int32, (V, V + 1)),
                                  ("weights", weights, torch.float32, (V, V + 1))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"epipolar_attn: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; E1 takes "
                             f"contiguous {dtype} {shape} on {q.device}")
    q, k, v, out_self = (attention_cuda._strided(n, t, "epipolar_attn")
                         for n, t in (("q", q), ("k", k), ("v", v), ("out_self", out_self)))
    out = attention_cuda._heads_last(B, S, H, D, q)
    lib = cuda_build.load("epipolar_attn", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.gctorch_epipolar_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out_self.data_ptr(), out.data_ptr(), idx.data_ptr(),
            logw.data_ptr(), partners.data_ptr(), weights.data_ptr(), B, H, S, D, V, lanes_per_head(H),
            vectors_per_lane(H, D, q.dtype), int(q.dtype == torch.bfloat16), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out_self.stride()[:3], *out.stride()[:3], D ** -0.5, mix, 1.0 - mix,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epipolar_attn kernel launch failed with CUDA error {err}")
    launches += 1
    return out
