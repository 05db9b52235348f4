"""Attention with pluggable processors, and the SD1.x transformer blocks.

Port of ``gaussctrl_exp_tpu/diffusion/attention.py``. A processor is a
function ``processor(q, k, v, is_cross) → out`` over (B, H, L, D) heads,
passed through the module call. ``make_cross_view_processor`` is the
reference's CrossViewAttnProcessor ("AttnAlign"): in self-attention, with the
batch laid out as ``unet_chunk_size`` CFG groups × V views, every view's
queries also attend to the keys and values of reference views 0..3 of its
group, and the output is ``coeff·self + (1−coeff)·mean(ref0..ref3)``;
cross-attention (text) is untouched.

``_sdpa`` sends every call on a CUDA tensor to kernel B3, self and cross,
whatever its shape: through ``ops/attention_cuda.FlashAttnFunction`` (B3
forward, B4 and B5 backward) when autograd records the call, else through
``flash_attn``. Every call on a CPU tensor goes to the plain version
``sdpa_plain``, which autograd differentiates. AttnAlign's self-attention on
CUDA tensors is one launch of kernel B3a (``flash_attn_align``); on the CPU
it is the JAX processor's five ``_sdpa`` calls and combine
(``cross_view_attention``).

Modules take (B, C, H, W) / (B, L, C) tensors whose attribute names mirror the
Flax ones (``to_q``, ``to_out_0``, ``ff.proj``, ``transformer_blocks_0``), so
that carrying weights across is a mechanical rename (``params.py``). Flax's
defaults come across: LayerNorm ε = 1e-6, Transformer2D's GroupNorm ε = 1e-6,
and ``jax.nn.gelu``'s tanh approximation in the GEGLU feed-forward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_cuda
from ..ops.attention_cuda import sdpa_plain
from ..utils import trace
from .layers import GroupNorm, LayerNorm, Linear

Processor = Callable[..., torch.Tensor]


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) scaled dot-product attention (fp32 softmax)."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return attention_cuda.FlashAttnFunction.apply(q, k, v)
        return attention_cuda.flash_attn(q, k, v)
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v)
    raise ValueError(f"no attention for device {q.device}")


def default_processor(q, k, v, is_cross: bool) -> torch.Tensor:
    return _sdpa(q, k, v)


def cross_view_attention(q, k, v, self_attn_coeff: float, num_ref_views: int = 4,
                         unet_chunk_size: int = 2) -> torch.Tensor:
    """AttnAlign's self-attention as the JAX processor composes it: five
    ``_sdpa`` calls (self, then one per reference view) and their combine."""
    B, H, S, D = q.shape
    V = B // unet_chunk_size  # views per CFG group
    out_self = _sdpa(q, k, v)

    # K/V of reference view r, broadcast to every view of the group
    kg = k.reshape(unet_chunk_size, V, H, S, D)
    vg = v.reshape(unet_chunk_size, V, H, S, D)
    ref_outs = []
    for r in range(num_ref_views):
        k_r = kg[:, r : r + 1].expand(kg.shape).reshape(B, H, S, D)
        v_r = vg[:, r : r + 1].expand(vg.shape).reshape(B, H, S, D)
        ref_outs.append(_sdpa(q, k_r, v_r))
    out_ref = torch.stack(ref_outs).mean(0)
    return self_attn_coeff * out_self + (1.0 - self_attn_coeff) * out_ref


def make_cross_view_processor(
    self_attn_coeff: float, num_ref_views: int = 4, unet_chunk_size: int = 2
) -> Processor:
    """AttnAlign. A self-attention on CUDA tensors is one launch of kernel
    B3a, counted ``attn.align.fused``; on the CPU, ``cross_view_attention``,
    counted ``attn.align.split``. A cross-attention is one ``_sdpa`` call."""

    def processor(q, k, v, is_cross: bool) -> torch.Tensor:
        if is_cross:
            return _sdpa(q, k, v)
        if q.device.type == "cuda":
            trace.count("attn.align.fused")
            return attention_cuda.flash_attn_align(q, k, v, self_attn_coeff, num_ref_views, unet_chunk_size)
        trace.count("attn.align.split")
        return cross_view_attention(q, k, v, self_attn_coeff, num_ref_views, unet_chunk_size)

    return processor


class Attention(nn.Module):
    """Multi-head attention matching diffusers' Attention (to_q/k/v, to_out)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False)
        self.to_v = Linear(kv_dim, inner, bias=False)
        self.to_out_0 = Linear(inner, query_dim)

    def forward(self, hidden_states, context=None, processor: Optional[Processor] = None):
        is_cross = context is not None
        ctx = hidden_states if context is None else context
        q = self.to_q(hidden_states)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        B, S, inner = q.shape
        T = k.shape[1]

        def split(x, L):  # a strided view: B3 reads the heads in place
            return x.view(B, L, self.heads, self.dim_head).transpose(1, 2)

        out = (processor or default_processor)(split(q, S), split(k, T), split(v, T), is_cross)
        out = out.transpose(1, 2).reshape(B, S, inner)
        return self.to_out_0(out)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers ff.net.0.proj + ff.net.2), with the
    tanh-approximate GELU of ``jax.nn.gelu``'s default."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = Linear(dim, inner * 2)
        self.out = Linear(inner, dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """attn1 (self, processor-pluggable) → attn2 (cross) → GEGLU ff."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, processor=None):
        x = x + self.attn1(self.norm1(x), processor=processor)
        x = x + self.attn2(self.norm2(x), context=context, processor=processor)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm → proj_in → transformer blocks → proj_out + residual, on
    (B, C, H, W): the output keeps the input's layout; for a channels-last
    input the moves to and from (B, HW, C) are views."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 cross_attention_dim: int = 768):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        for i in range(depth):
            self.add_module(f"transformer_blocks_{i}",
                            BasicTransformerBlock(channels, heads, dim_head, cross_attention_dim))
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context, processor=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"transformer_blocks_{i}")(h, context, processor)
        h = self.proj_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)  # x first: the sum keeps x's layout
