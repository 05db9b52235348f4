"""The triplane cross-view term's work (``triplane_attention.py``'s
processor in each self-attention at the geometry's grid), counted from
shapes, in bf16 as the edit stack computes it: the floor is fixed by the
work, not by how a program pools it.

For one mixing self-attention over B rows (V views, both CFG groups) of S
tokens, width C = heads × D, planes of r × r cells:

* bytes: the values v read once (2 · B·S·C); the three planes' float32 sums
  and counts written and read once each (2 · 3 · 4 · r²·(C + 1)); the
  geometry, V·S float32 points, read once (4 · 3 · V·S); the features
  written once (2 · B·S·C); the attention of the queries to them
  (``attention.py``: q, the features as keys and values, its output); the
  self-attention's output read and the layer's output written (2 · 2 ·
  B·S·C);
* operations: the attention's two products (``attention.py``); the pooling's
  adds, the bilinear taps and the mix are elementwise and not counted, as
  the edit stack's counts leave elementwise work out.
"""

from __future__ import annotations

import torch

from ..reference import sd as ref
from .attention import attention_bytes, attention_ops
from .peaks import PEAK_BF16_OPS_S, roofline_s

PLANES = 3


def layers(mcfg: dict, grid: int) -> list[tuple[int, int]]:
    """(S, C) of each self-attention whose length is the grid's (grid²), in
    the ControlNet's and then the UNet's order: the layers that mix the term."""
    out: list = []

    def rec(qh, kh, vh, is_cross):
        B, H, S, D = qh.shape
        if not is_cross and S == grid * grid:
            out.append((S, H * D))
        return ref.sdpa(qh, kh, vh)

    h, meta = mcfg["latent"], dict(device="meta")
    P = ref.Params()
    lat, t = torch.empty((2, 4, h, h), **meta), torch.zeros(2, dtype=torch.long, **meta)
    ctx, hint = torch.empty((2, 77, mcfg["cross_dim"]), **meta), torch.empty((2, 3, mcfg["image"], mcfg["image"]), **meta)
    res = ref.controlnet(P, mcfg, lat, t, ctx, hint, 1.0, rec)
    ref.unet(P, mcfg, lat, t, ctx, rec, res)
    return out


def layer_bytes(B: int, V: int, S: int, C: int, heads: int, res: int) -> int:
    act = 2 * B * S * C  # one bf16 activation of the layer
    planes = 2 * PLANES * 4 * res * res * (C + 1)
    geometry = 4 * 3 * V * S
    attn = attention_bytes((B, heads, S, S, C // heads), 2)
    return act + planes + geometry + act + attn + 2 * act


def layer_ops(B: int, S: int, C: int, heads: int) -> int:
    return attention_ops((B, heads, S, S, C // heads))


def step_bound_s(mcfg: dict, B: int, V: int, grid: int, res: int) -> float:
    """The floor of one ε call's triplane terms: each layer's operations at
    the bf16 peak or its bytes at HBM's rate, the larger, summed."""
    heads = mcfg["heads"]
    return sum(roofline_s(layer_ops(B, S, C, heads), layer_bytes(B, V, S, C, heads, res), PEAK_BF16_OPS_S)
               for S, C in layers(mcfg, grid))
