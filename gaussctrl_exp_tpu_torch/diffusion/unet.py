"""Stable-Diffusion 1.x UNet with ControlNet residual inputs, in PyTorch.

Port of ``gaussctrl_exp_tpu/diffusion/unet.py``: 4-channel latents, block
channels (320, 640, 1280, 1280), 2 resnets per block, depth-1 transformers
with 8 heads, cross-attention dim 768, SiLU + GroupNorm(32, ε = 1e-5).
Modules take (B, C, H, W) tensors in either memory layout and keep it; on the
card the edit pipeline stores them channels-last (``layers.to_channels_last``),
the layout of cuDNN's Hopper convolutions. Their names mirror the Flax ones
(``down_0_resnet_1``, ``mid_attn_0``, ``up_2_upsample.conv``).
``controlnet_residuals`` takes the (down residuals, mid residual) pair of
``controlnet.py`` and adds them where diffusers adds them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Transformer2D
from .layers import Conv2d, GroupNorm, Linear

BLOCK_OUT = (320, 640, 1280, 1280)  # SD1.x defaults
LAYERS_PER_BLOCK = 2
HEADS = 8
CROSS_DIM = 768


def timestep_embedding(timesteps: torch.Tensor, dim: int = 320) -> torch.Tensor:
    """Sinusoidal embedding (diffusers Timesteps: flip_sin_to_cos=True,
    downscale_freq_shift=0), float32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(10000.0) * idx / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=1e-5)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-5)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2× (``jax.image.resize(..., "nearest")`` at an exact factor
    of 2 repeats every pixel) and a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _attn(ch: int, heads: int, cross_dim: int) -> Transformer2D:
    return Transformer2D(ch, heads, max(ch // heads, 1), cross_attention_dim=cross_dim)


class UNet2DCondition(nn.Module):
    """SD1.x UNet (dims configurable so tests can use a tiny instance).

    ``compute_dtype`` is Flax's ``dtype``: the type the UNet computes in,
    whatever its parameters' type (``layers.py`` casts each weight at its
    use). ``None`` computes in the parameters' type, so a UNet cast to bf16
    as a whole (the edit path) computes in bf16."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4, block_out: tuple = BLOCK_OUT,
                 layers_per_block: int = LAYERS_PER_BLOCK, heads: int = HEADS,
                 cross_dim: int = CROSS_DIM, temb_dim: int = 1280,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block_out, self.layers_per_block = tuple(block_out), layers_per_block
        n = len(self.block_out)
        c0 = self.block_out[0]
        self.time_embedding_linear_1 = Linear(c0, temb_dim)
        self.time_embedding_linear_2 = Linear(temb_dim, temb_dim)
        self.conv_in = Conv2d(in_channels, c0, 3, padding=1)

        res_ch, ch = [c0], c0  # channels of the skip stack
        for bi, cout in enumerate(self.block_out):
            for li in range(layers_per_block):
                self.add_module(f"down_{bi}_resnet_{li}", ResnetBlock(ch, cout, temb_dim))
                ch = cout
                if bi < n - 1:
                    self.add_module(f"down_{bi}_attn_{li}", _attn(ch, heads, cross_dim))
                res_ch.append(ch)
            if bi < n - 1:
                self.add_module(f"down_{bi}_downsample", Downsample(ch))
                res_ch.append(ch)

        self.mid_resnet_0 = ResnetBlock(ch, ch, temb_dim)
        self.mid_attn_0 = _attn(ch, heads, cross_dim)
        self.mid_resnet_1 = ResnetBlock(ch, ch, temb_dim)

        for bi, cout in enumerate(reversed(self.block_out)):
            for li in range(layers_per_block + 1):
                self.add_module(f"up_{bi}_resnet_{li}", ResnetBlock(ch + res_ch.pop(), cout, temb_dim))
                ch = cout
                if bi > 0:
                    self.add_module(f"up_{bi}_attn_{li}", _attn(ch, heads, cross_dim))
            if bi < n - 1:
                self.add_module(f"up_{bi}_upsample", Upsample(ch))

        self.conv_norm_out = GroupNorm(32, ch, eps=1e-5)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, 4, h, w)
        timesteps: torch.Tensor,  # (B,) int
        encoder_hidden_states: torch.Tensor,  # (B, 77, cross_dim)
        processor=None,
        controlnet_residuals: Optional[Tuple[Sequence[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        n = len(self.block_out)
        ctx = encoder_hidden_states.to(dtype)
        temb = timestep_embedding(timesteps, self.block_out[0]).to(dtype)
        temb = self.time_embedding_linear_2(F.silu(self.time_embedding_linear_1(temb)))

        h = self.conv_in(sample.to(dtype))
        res_stack = [h]
        for bi in range(n):
            for li in range(self.layers_per_block):
                h = getattr(self, f"down_{bi}_resnet_{li}")(h, temb)
                if bi < n - 1:
                    h = getattr(self, f"down_{bi}_attn_{li}")(h, ctx, processor)
                res_stack.append(h)
            if bi < n - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                res_stack.append(h)

        h = self.mid_resnet_0(h, temb)
        h = self.mid_attn_0(h, ctx, processor)
        h = self.mid_resnet_1(h, temb)

        if controlnet_residuals is not None:
            down_res, mid_res = controlnet_residuals
            res_stack = [r + c for r, c in zip(res_stack, down_res)]
            h = h + mid_res

        for bi in range(n):
            for li in range(self.layers_per_block + 1):
                h = torch.cat([h, res_stack.pop()], dim=1)
                h = getattr(self, f"up_{bi}_resnet_{li}")(h, temb)
                if bi > 0:
                    h = getattr(self, f"up_{bi}_attn_{li}")(h, ctx, processor)
            if bi < n - 1:
                h = getattr(self, f"up_{bi}_upsample")(h)

        return self.conv_out(self.conv_norm_out(h, silu=True))
