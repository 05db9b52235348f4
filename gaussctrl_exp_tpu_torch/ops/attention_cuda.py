"""Kernels B3 (the flash-attention forward), B3a (AttnAlign's
self-attention) and B4, B5 (B3's backward) for CUDA tensors.

B3 (``csrc/flash_attn_fwd.cu``) replaces
``gaussctrl_exp_tpu/diffusion/attention.py:_flash_sdpa`` (the library TPU
flash attention) and computes what ``sdpa_plain`` computes: the non-causal
``softmax(Q·Kᵀ·D^-½)·V`` of (B, H, S, D) queries against (B, H, T, D) keys
and values, with an fp32 softmax. B4 (dK, dV) and B5 (dQ), in
``csrc/flash_attn_bwd.cu``, replace the library's backward kernels and
compute what autograd through ``sdpa_plain`` computes, from B3's per-row
log-sum-exp. bf16 runs on the tensor cores (``mma.sync``), fp32 on the
tensor cores as 3×TF32 (``csrc/tf32_mma.cuh``); all accumulate in fp32 and
return the input's type. B3a (``flash_attn_align``, in
``csrc/flash_attn_fwd.cu`` beside B3 and on B3's per-tile code) computes in
one launch what ``align_attn_plain`` computes: AttnAlign's weighted sum of a
view's self-attention and its attention to each reference view of its CFG
group. The sources say what bounds each kernel and how its design meets
that.

``diffusion/attention.py``'s ``_sdpa`` sends a CUDA call that autograd must
differentiate to ``FlashAttnFunction`` (B3 forward, B4 and B5 backward),
every other CUDA call to ``flash_attn`` and every CPU call to
``sdpa_plain``; its AttnAlign processor sends a CUDA self-attention to
``flash_attn_align``. The wrappers launch their kernel or raise: they never
fall back.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from . import cuda_build

MAX_HEAD_DIM = 160
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
_ALIGN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12 + [ctypes.c_float] * 4 + [
    ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 21
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])

launches = 0  # B3 launches since the caller last set it to 0
align_launches = 0  # B3a launches, likewise
dkv_launches = 0  # B4 launches, likewise
dq_launches = 0  # B5 launches, likewise
copies = 0  # inputs the wrappers made contiguous (D not contiguous, or misaligned)
# the kernels' names as torch.profiler shows them, under a prefix that no
# library kernel holds: B3 (with B3a), B3a, B4 and B5, B4 with B5, and all
B3_KERNEL, B4_KERNEL, B5_KERNEL = "gctorch_attn_fwd_b3", "gctorch_attn_bwd_b4", "gctorch_attn_bwd_b5"
B3A_KERNEL = "gctorch_attn_fwd_b3a"
BWD_KERNELS, ATTN_KERNELS = "gctorch_attn_bwd", "gctorch_attn_"


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) scaled dot-product attention with an fp32 softmax: the
    JAX package's ``_sdpa`` math path, in its order of roundings."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def align_weights(coeff: float, n_ref: int) -> tuple[float, float, float]:
    """AttnAlign's fp32 weights, as B3a takes them: a view's own pass
    (``coeff``), its own pass where the view is one of the references
    (``coeff + (1 − coeff)/n_ref``: its pass over its own keys is the same
    pass), and each other reference view's (``(1 − coeff)/n_ref``)."""
    w_ref = (1.0 - coeff) / n_ref
    return float(np.float32(coeff)), float(np.float32(coeff + w_ref)), float(np.float32(w_ref))


def align_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, coeff: float, n_ref: int,
                     groups: int) -> torch.Tensor:
    """B3a's plain version: AttnAlign's self-attention of (B, H, S, D)
    q, k, v laid out as ``groups`` CFG groups of V = B / groups views whose
    first ``n_ref`` are the references. ``sdpa_plain`` of the self pass and
    of one pass per reference view (its K and V broadcast over its group),
    then one fp32 sum in B3a's order, rounded once to the input's type: the
    self pass by its weight, then the references in order, a view's own
    reference pass by 0 (B3a leaves it out: its weight is in the self
    pass's)."""
    B, H, S, D = q.shape
    V = B // groups
    w_self, w_dup, w_ref = align_weights(coeff, n_ref)
    view = (torch.arange(B, device=q.device) % V)[:, None, None, None]
    total = sdpa_plain(q, k, v).float() * torch.where(view < n_ref, w_dup, w_self)
    kg, vg = k.reshape(groups, V, H, S, D), v.reshape(groups, V, H, S, D)
    for r in range(n_ref):
        k_r = kg[:, r : r + 1].expand(kg.shape).reshape(B, H, S, D)
        v_r = vg[:, r : r + 1].expand(vg.shape).reshape(B, H, S, D)
        total = total + sdpa_plain(q, k_r, v_r).float() * torch.where(view == r, 0.0, w_ref)
    return total.to(q.dtype)


def reads_in_place(shape, strides, data_ptr: int, dtype: torch.dtype) -> bool:
    """Whether the kernels read a tensor of this shape, strides (elements)
    and address as it lies: B3, B4 and B5 copy rows 16 bytes at a time
    (``cp.async``), bf16 and fp32 alike, so D must be contiguous and every
    row start on a 16-byte boundary. That is the address a multiple of 16
    bytes and the stride of every dimension longer than 1 a multiple of 16
    bytes' elements."""
    per_16 = 16 // (2 if dtype == torch.bfloat16 else 4)
    return (strides[-1] == 1 and data_ptr % 16 == 0
            and all(st % per_16 == 0 for n, st in zip(shape[:-1], strides[:-1]) if n > 1))


def _strided(name: str, t: torch.Tensor, fn: str = "flash_attn") -> torch.Tensor:
    """``t`` as the kernel reads it: ``t`` itself where ``reads_in_place``,
    else a contiguous copy in a fresh (aligned) allocation, counted in
    ``copies``."""
    global copies
    if reads_in_place(t.shape, t.stride(), t.data_ptr(), t.dtype):
        return t
    warnings.warn(f"{fn}: {name} with strides {t.stride()} at {t.data_ptr() % 16} bytes past a 16-byte "
                  "boundary is copied to a contiguous tensor", stacklevel=3)
    copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _check(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(B, H, S, T, D) of CUDA q (B, H, S, D), k and v (B, H, T, D) that the
    kernels take; raises on anything else."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}; the attention kernels take CUDA tensors "
                             "(diffusion.attention._sdpa sends CPU tensors to sdpa_plain)")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}; all of q, k, v must be "
                            "bfloat16 or all float32")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected (B, H, L, D)")
    B, H, S, D = q.shape
    T = k.shape[2]
    if tuple(k.shape) != (B, H, T, D) or tuple(v.shape) != (B, H, T, D):
        raise ValueError(f"{fn}: k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if D % 8 != 0 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {D} is not a multiple of 8 in 8..{MAX_HEAD_DIM}")
    if S == 0 or T == 0 or B * H == 0:
        raise ValueError(f"{fn}: empty attention q {tuple(q.shape)} k {tuple(k.shape)}")
    if B * H > 65535:
        raise ValueError(f"{fn}: B·H = {B * H} exceeds the grid's 65535")
    return B, H, S, T, D


def _heads_last(B: int, L: int, H: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, L, D) tensor laid out as (B, L, H, D), so that merging
    the heads back is a view."""
    return torch.empty((B, L, H, D), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               return_lse: bool = False):
    """Launch kernel B3 on CUDA tensors q (B, H, S, D), k and v (B, H, T, D),
    all bf16 or all fp32, D a multiple of 8 up to 160. Returns (B, H, S, D) in
    the input's type, laid out as (B, S, H, D); with ``return_lse`` also each
    query row's log-sum-exp of its scaled scores, fp32 (B, H, S), which the
    backward kernels read. Raises on anything else."""
    global launches
    B, H, S, T, D = _check("flash_attn", q, k, v)
    q, k, v = _strided("q", q), _strided("k", k), _strided("v", v)
    out = _heads_last(B, S, H, D, q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    lib = cuda_build.load("flash_attn_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.gctorch_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, H, S, T, D, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out


def _fwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attn_fwd", _ARGTYPES)
    lib.gctorch_flash_attn_align.argtypes = _ALIGN_ARGTYPES
    lib.gctorch_flash_attn_align.restype = ctypes.c_int
    lib.gctorch_flash_attn_ctas.argtypes = [ctypes.c_int] * 3
    return lib


def flash_attn_align(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, coeff: float, n_ref: int,
                     groups: int) -> torch.Tensor:
    """Launch kernel B3a on CUDA tensors q, k, v (B, H, S, D), all bf16 or
    all fp32, D a multiple of 8 up to 160, the batch laid out as ``groups``
    CFG groups of V = B / groups views whose first ``n_ref`` are the
    references: each view's coeff·attn(its own K, V) + (1 − coeff)/n_ref ·
    Σ_r attn(reference r's K, V), what ``align_attn_plain`` computes. K and
    V are read in place. Returns (B, H, S, D) in the input's type, laid out
    as (B, S, H, D). Raises on anything else, and where autograd would
    record the call: B3a has no backward."""
    global align_launches
    if q.dim() != 4 or k.dim() != 4 or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attn_align: q {tuple(q.shape)} and k {tuple(k.shape)} are not a "
                         "self-attention (B, H, S, D) with S = T")
    if groups < 1 or q.shape[0] % groups:
        raise ValueError(f"flash_attn_align: batch {q.shape[0]} is not {groups} CFG groups of equal size")
    V = q.shape[0] // groups
    if not 1 <= n_ref <= V:
        raise ValueError(f"flash_attn_align: {n_ref} reference views, but {V} views a group")
    B, H, S, _, D = _check("flash_attn_align", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("flash_attn_align: kernel B3a has no backward; call it under torch.no_grad()")
    q, k, v = _strided("q", q), _strided("k", k), _strided("v", v)
    out = _heads_last(B, S, H, D, q)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        err = lib.gctorch_flash_attn_align(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, D, V, n_ref,
            int(q.dtype == torch.bfloat16), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D ** -0.5, *align_weights(coeff, n_ref), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_align kernel launch failed with CUDA error {err}")
    align_launches += 1
    return out


def ctas_per_sm(D: int, bf16: bool, align: bool) -> int:
    """CTAs of B3 (or of B3a, ``align``) resident on an SM of the current
    card at head width D, by the CUDA occupancy calculator."""
    return _fwd_lib().gctorch_flash_attn_ctas(D, int(bf16), int(align))


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attn_bwd", _BWD_ARGTYPES)
    lib.gctorch_flash_attn_bwd_dkv_splits.argtypes = [ctypes.c_int] * 7
    lib.gctorch_flash_attn_bwd_sum_launches.restype = ctypes.c_longlong
    return lib


def dkv_splits(B: int, H: int, S: int, T: int, D: int, sms: int, bf16: bool = False) -> int:
    """Over how many CTAs B4 (bf16 or fp32) splits each key block's queries
    on a card of ``sms`` SMs, by the rule of ``csrc/flash_attn_bwd.cu``
    (``gctorch_flash_attn_bwd_dkv_splits``)."""
    return _bwd_lib().gctorch_flash_attn_bwd_dkv_splits(B, H, S, T, D, int(bf16), sms)


def dkv_sum_launches() -> int:
    """Launches of B4's second pass, which sums the partials of its query
    splits, since the kernel library was loaded."""
    return _bwd_lib().gctorch_flash_attn_bwd_sum_launches()


def _launch_bwd(which: int, q, k, v, dout, lse, delta, dq, dk, dv, splits: int = 1) -> None:
    B, H, S, D = q.shape
    T = k.shape[2]
    lib = _bwd_lib()
    # the partial dK and dV of each split: fp32, on the caller's stream
    ws = torch.empty((2 * splits, B, H, T, D), dtype=torch.float32, device=q.device) if splits > 1 else None
    with torch.cuda.device(q.device):
        err = lib.gctorch_flash_attn_bwd(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr() if dq is not None else None,
            dk.data_ptr() if dk is not None else None, dv.data_ptr() if dv is not None else None,
            B, H, S, T, D, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *(dq.stride()[:3] if dq is not None else (0, 0, 0)),
            *(dk.stride()[:3] if dk is not None else (0, 0, 0)),
            *(dv.stride()[:3] if dv is not None else (0, 0, 0)),
            D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
            ws.data_ptr() if ws is not None else None, splits,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd kernel {'B4' if which == 0 else 'B5'} launch failed "
                           f"with CUDA error {err}")


def _bwd_inputs(fn, q, k, v, out, lse, dout, delta):
    B, H, S, T, D = _check(fn, q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} {t.dtype} on {t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"{fn}: lse {tuple(lse.shape)} {lse.dtype} is not fp32 (B, H, S) on {q.device}")
    delta = delta_of(out, dout) if delta is None else delta.float().contiguous()
    return (_strided("q", q), _strided("k", k), _strided("v", v), _strided("dout", dout), lse.contiguous(), delta)


def delta_of(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO ∘ O) in fp32, (B, H, S) contiguous: what the backward
    subtracts from dP (the JAX wrapper computes it in XLA outside its
    kernels, as here)."""
    return (dout.float() * out.float()).sum(-1).contiguous()


def flash_attn_bwd_dkv(q, k, v, out, lse, dout, delta=None, _splits=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B4: dK and dV (B, H, T, D), laid out (B, T, H, D), of the
    attention B3 computed as ``out`` with log-sum-exp ``lse``, for the output
    cotangent ``dout``; ``delta`` is ``delta_of(out, dout)``, computed here
    when not given. Each key block's queries are split over ``dkv_splits``
    CTAs (``_splits`` sets the count, for the tests)."""
    global dkv_launches
    q, k, v, dout, lse, delta = _bwd_inputs("flash_attn_bwd_dkv", q, k, v, out, lse, dout, delta)
    B, H, S, D = q.shape
    T = k.shape[2]
    if _splits is None:
        _splits = dkv_splits(B, H, S, T, D, torch.cuda.get_device_properties(q.device).multi_processor_count,
                             q.dtype == torch.bfloat16)
    dk, dv = _heads_last(B, T, H, D, k), _heads_last(B, T, H, D, k)
    _launch_bwd(0, q, k, v, dout, lse, delta, None, dk, dv, _splits)
    dkv_launches += 1
    return dk, dv


def flash_attn_bwd_dq(q, k, v, out, lse, dout, delta=None) -> torch.Tensor:
    """Launch kernel B5: dQ (B, H, S, D), laid out (B, S, H, D)."""
    global dq_launches
    q, k, v, dout, lse, delta = _bwd_inputs("flash_attn_bwd_dq", q, k, v, out, lse, dout, delta)
    B, H, S, D = q.shape
    dq = _heads_last(B, S, H, D, q)
    _launch_bwd(1, q, k, v, dout, lse, delta, dq, None, None)
    dq_launches += 1
    return dq


class FlashAttnFunction(torch.autograd.Function):
    """Attention with a gradient on the card: B3 forward (with the
    log-sum-exp), B4 and B5 backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attn(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        delta = delta_of(out, dout)
        dk, dv = flash_attn_bwd_dkv(q, k, v, out, lse, dout, delta)
        dq = flash_attn_bwd_dq(q, k, v, out, lse, dout, delta)
        return dq, dk, dv
