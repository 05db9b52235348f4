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
use, and keeps its norms' scale and bias float32, as Flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _like(self.weight, x), _like(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _like(self.weight, x), _like(self.bias, x))


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)
