"""Layers that compute in their input's type, as Flax's ``dtype`` does.

A Flax module built with ``dtype=jnp.bfloat16`` keeps its parameters in
float32 (``param_dtype``) and computes in bf16: ``Dense`` and ``Conv`` cast
their input and their kernel and bias to bf16 at each use
(``promote_dtype``); ``GroupNorm`` and ``LayerNorm`` take their statistics of
the input in float32, apply the float32 scale and bias in float32, and round
the result to bf16. The layers here do the same with PyTorch's modules, the
input's type standing for the compute type: a float32 parameter meets a
bf16 input as a differentiable cast, so its gradient arrives in float32.

Where the parameters already have the input's type (the float32 generator,
or the edit path's bf16 weights) every cast is the identity and each layer is
its ``torch.nn`` parent, bit for bit. The state-dict names are the parent's.

The edit path's bf16 stack (``cast_keeping_norms``) stores its Linear and
Conv weights in bf16, which gives the bits of Flax's round-to-nearest cast at
use, and keeps its norms' scale and bias float32, as Flax does. On the card
its UNet and ControlNet also store their conv weights channels-last
(``to_channels_last``), so that cuDNN's NHWC convolutions read them as they
lie and the activations stay NHWC from conv to conv; ``GroupNorm`` then
takes kernel N1 (``ops/groupnorm_cuda.py``), with the SiLU after it fused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import groupnorm_cuda
from ..utils import trace


def _like(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    return None if p is None else p.to(x.dtype)


def cast_keeping_norms(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` with every parameter cast to ``dtype`` in place, except the
    scale and bias of its GroupNorms and LayerNorms, which are made float32:
    a bf16 activation then meets them on the float path of ``GroupNorm`` and
    ``LayerNorm`` below, as Flax's norms apply float32 parameters."""
    for m in module.modules():
        to = torch.float32 if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) else dtype
        for p in m.parameters(recurse=False):
            p.data = p.data.to(to)
    return module


def to_channels_last(module: nn.Module) -> nn.Module:
    """``module`` with every conv weight re-stored channels-last in place
    (the parameters stay the same objects)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
    return module


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _like(self.weight, x), _like(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _like(self.weight, x), _like(self.bias, x))


class GroupNorm(nn.GroupNorm):
    """``silu=True`` applies SiLU to the (rounded) output. A bf16
    channels-last input with float32 scale and bias, which autograd does not
    record, takes ``groupnorm_cuda.group_norm_nhwc`` (N1 on the card, its
    plain version on the CPU) and counts ``sd.norm.nhwc``; every other input
    the path below, where a CUDA one counts ``sd.norm.nchw``."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if (x.dtype == torch.bfloat16 and self.weight.dtype == self.bias.dtype == torch.float32
                and x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
                and not (torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad))):
            trace.count("sd.norm.nhwc")
            return groupnorm_cuda.group_norm_nhwc(x, self.weight, self.bias, self.num_groups, self.eps, silu)
        if x.device.type == "cuda":
            trace.count("sd.norm.nchw")
        if self.weight.dtype == x.dtype:
            y = super().forward(x)
            return F.silu(y) if silu else y
        return groupnorm_cuda.group_norm_plain(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)
