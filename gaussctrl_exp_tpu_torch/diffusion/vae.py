"""SD1.x VAE (AutoencoderKL) encoder and decoder, in PyTorch.

Port of ``gaussctrl_exp_tpu/diffusion/vae.py``: block channels
(128, 256, 512, 512), 4-channel latents scaled by 0.18215, GroupNorm(32,
ε = 1e-6) and SiLU, a single-head mid-block self-attention whose softmax runs
in fp32. The encoder's stride-2 downsample pads (0, 1) on each spatial axis,
as the JAX package's ``padding=((0, 1), (0, 1))``; the decoder upsamples by
nearest 2×. The mid-block attention (C = 512) is plain ``torch.matmul``: the
JAX package computes it outside any Pallas kernel too. Its norms, convs and
linear layers are those of ``layers.py``, so that float32 norm parameters
meet a bf16 activation as Flax's do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm, Linear

SCALING_FACTOR = 0.18215
VAE_BLOCK_OUT = (128, 256, 512, 512)


class VaeResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out_0 = Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = (torch.matmul(q, k.transpose(1, 2)) * C**-0.5).float()
        probs = torch.softmax(logits, dim=-1).to(q.dtype)  # fp32 softmax under bf16
        h = self.to_out_0(torch.matmul(probs, v))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, block_out: tuple = VAE_BLOCK_OUT):
        super().__init__()
        self.block_out = tuple(block_out)
        n = len(self.block_out)
        self.conv_in = Conv2d(3, self.block_out[0], 3, padding=1)
        ch = self.block_out[0]
        for bi, cout in enumerate(self.block_out):
            for li in range(2):
                self.add_module(f"down_{bi}_resnet_{li}", VaeResnet(ch, cout))
                ch = cout
            if bi < n - 1:  # padding (0, 1) per axis, applied in forward
                self.add_module(f"down_{bi}_downsample", Conv2d(ch, ch, 3, stride=2, padding=0))
        self.mid_resnet_0 = VaeResnet(ch, ch)
        self.mid_attn = VaeAttention(ch)
        self.mid_resnet_1 = VaeResnet(ch, ch)
        self.conv_norm_out = GroupNorm(32, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 8, 3, padding=1)
        self.quant_conv = Conv2d(8, 8, 1)

    def forward(self, x):  # (B, 3, H, W) in [-1, 1]
        n = len(self.block_out)
        h = self.conv_in(x)
        for bi in range(n):
            for li in range(2):
                h = getattr(self, f"down_{bi}_resnet_{li}")(h)
            if bi < n - 1:
                h = getattr(self, f"down_{bi}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(h)  # mean ‖ logvar


class Decoder(nn.Module):
    def __init__(self, block_out: tuple = VAE_BLOCK_OUT):
        super().__init__()
        self.block_out = tuple(block_out)
        n = len(self.block_out)
        ch = self.block_out[-1]
        self.post_quant_conv = Conv2d(4, 4, 1)
        self.conv_in = Conv2d(4, ch, 3, padding=1)
        self.mid_resnet_0 = VaeResnet(ch, ch)
        self.mid_attn = VaeAttention(ch)
        self.mid_resnet_1 = VaeResnet(ch, ch)
        for bi, cout in enumerate(reversed(self.block_out)):
            for li in range(3):
                self.add_module(f"up_{bi}_resnet_{li}", VaeResnet(ch, cout))
                ch = cout
            if bi < n - 1:
                self.add_module(f"up_{bi}_upsample", Conv2d(ch, ch, 3, padding=1))
        self.conv_norm_out = GroupNorm(32, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 3, 3, padding=1)

    def forward(self, z):  # (B, 4, h, w)
        n = len(self.block_out)
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for bi in range(n):
            for li in range(3):
                h = getattr(self, f"up_{bi}_resnet_{li}")(h)
            if bi < n - 1:
                h = getattr(self, f"up_{bi}_upsample")(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out: tuple = VAE_BLOCK_OUT):
        super().__init__()
        self.encoder = Encoder(block_out)
        self.decoder = Decoder(block_out)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Image in [-1, 1] (B, 3, H, W) → scaled latent: the posterior's mode,
        or a sample drawn with ``generator`` when one is given."""
        dtype = self.encoder.conv_in.weight.dtype
        mean, logvar = self.encoder(x.to(dtype)).chunk(2, dim=1)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device).to(mean)
            mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
        return mean * SCALING_FACTOR

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.decoder.conv_in.weight.dtype
        return self.decoder((z / SCALING_FACTOR).to(dtype))
