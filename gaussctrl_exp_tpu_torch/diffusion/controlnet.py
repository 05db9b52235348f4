"""ControlNet (depth) for the SD1.x UNet, in PyTorch.

Port of ``gaussctrl_exp_tpu/diffusion/controlnet.py``: a copy of the UNet's
down and mid trunk, a conditioning-embedding conv stack for the 3-channel
disparity hint, and zero-initialised 1×1 projections for every residual it
feeds back into the UNet, all scaled by ``conditioning_scale``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .unet import BLOCK_OUT, CROSS_DIM, HEADS, LAYERS_PER_BLOCK, Downsample, ResnetBlock, _attn, timestep_embedding

COND_CHANS = (16, 32, 96, 256)


class ConditioningEmbedding(nn.Module):
    """3-channel hint image → base-channel feature at latent resolution (/8)."""

    def __init__(self, chans: tuple = COND_CHANS, out_ch: int = 320):
        super().__init__()
        self.n = len(chans) - 1
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        for i in range(self.n):
            self.add_module(f"blocks_{2 * i}", nn.Conv2d(chans[i], chans[i], 3, padding=1))
            self.add_module(f"blocks_{2 * i + 1}", nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.conv_out = nn.Conv2d(chans[-1], out_ch, 3, padding=1)

    def forward(self, hint):
        h = F.silu(self.conv_in(hint))
        for i in range(2 * self.n):
            h = F.silu(getattr(self, f"blocks_{i}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, block_out: tuple = BLOCK_OUT, layers_per_block: int = LAYERS_PER_BLOCK,
                 heads: int = HEADS, cross_dim: int = CROSS_DIM, temb_dim: int = 1280,
                 cond_chans: tuple = COND_CHANS):
        super().__init__()
        self.block_out, self.layers_per_block = tuple(block_out), layers_per_block
        n = len(self.block_out)
        c0 = self.block_out[0]
        self.time_embedding_linear_1 = nn.Linear(c0, temb_dim)
        self.time_embedding_linear_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(4, c0, 3, padding=1)
        self.controlnet_cond_embedding = ConditioningEmbedding(tuple(cond_chans), c0)

        zero_ch, ch = [c0], c0  # channels of each zero-conv
        for bi, cout in enumerate(self.block_out):
            for li in range(layers_per_block):
                self.add_module(f"down_{bi}_resnet_{li}", ResnetBlock(ch, cout, temb_dim))
                ch = cout
                if bi < n - 1:
                    self.add_module(f"down_{bi}_attn_{li}", _attn(ch, heads, cross_dim))
                zero_ch.append(ch)
            if bi < n - 1:
                self.add_module(f"down_{bi}_downsample", Downsample(ch))
                zero_ch.append(ch)
        for zi, c in enumerate(zero_ch):
            self.add_module(f"controlnet_down_blocks_{zi}", nn.Conv2d(c, c, 1))
        self.n_zero = len(zero_ch)

        self.mid_resnet_0 = ResnetBlock(ch, ch, temb_dim)
        self.mid_attn_0 = _attn(ch, heads, cross_dim)
        self.mid_resnet_1 = ResnetBlock(ch, ch, temb_dim)
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def zero_convs(self) -> list[nn.Conv2d]:
        """The convs that Flax initialises to zero."""
        return ([getattr(self, f"controlnet_down_blocks_{i}") for i in range(self.n_zero)]
                + [self.controlnet_mid_block, self.controlnet_cond_embedding.conv_out])

    def forward(
        self,
        sample: torch.Tensor,  # (B, 4, h, w) latent
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        hint: torch.Tensor,  # (B, 3, H, W) conditioning image, H = 8h
        conditioning_scale: float = 1.0,
        processor=None,
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        dtype = self.conv_in.weight.dtype
        n = len(self.block_out)
        ctx = encoder_hidden_states.to(dtype)
        temb = timestep_embedding(timesteps, self.block_out[0]).to(dtype)
        temb = self.time_embedding_linear_2(F.silu(self.time_embedding_linear_1(temb)))

        h = self.conv_in(sample.to(dtype)) + self.controlnet_cond_embedding(hint.to(dtype))
        feats = [h]
        for bi in range(n):
            for li in range(self.layers_per_block):
                h = getattr(self, f"down_{bi}_resnet_{li}")(h, temb)
                if bi < n - 1:
                    h = getattr(self, f"down_{bi}_attn_{li}")(h, ctx, processor)
                feats.append(h)
            if bi < n - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                feats.append(h)
        down_res = [getattr(self, f"controlnet_down_blocks_{i}")(f) for i, f in enumerate(feats)]

        h = self.mid_resnet_0(h, temb)
        h = self.mid_attn_0(h, ctx, processor)
        h = self.mid_resnet_1(h, temb)
        mid_res = self.controlnet_mid_block(h)
        return [r * conditioning_scale for r in down_res], mid_res * conditioning_scale
