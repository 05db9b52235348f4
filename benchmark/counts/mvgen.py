"""Operations of the depth generator's ε call, counted on the plain
reference at the cell's shapes on the meta device (``FlopCounterMode``: 2
per multiply-add of every matrix product and convolution), and the bound of
its attention calls (kernel B3 in float32).

The processor under count is plain attention, its calls recorded with their
(B, H, S, T, D): the attention's operations (``counts/attention.py``) are
taken out of the total and bounded at the exact float32 rate of 3×TF32, as
B3 computes a float32 product as three TF32 ones; the rest of the UNet runs
its products in float32 outside the tensor cores (TF32 off). The epipolar
term is counted by ``epipolar.py`` from the pairs each call attends.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import mvgen as ref
from ..reference.sd import Params, sdpa
from .attention import attention_bytes, attention_ops
from .peaks import roofline_s
from .sam import PEAK_F32_EXACT_OPS_S  # 3×TF32


def eps(cfg: dict, views: int) -> tuple[int, list]:
    """(operations of the UNet outside attention, attention shapes) of one
    CFG-doubled ε call over ``views`` views."""
    B, L = 2 * views, cfg["latent"]
    shapes: list = []

    def proc(qh, kh, vh, is_cross):
        b, h, s, d = qh.shape
        shapes.append((b, h, s, kh.shape[2], d))
        return sdpa(qh, kh, vh)

    meta = dict(device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.unet(Params(), cfg, torch.empty((B, cfg["in_channels"], L, L), **meta),
                 torch.zeros(B, dtype=torch.long, **meta), torch.empty((B, 77, cfg["cross_dim"]), **meta), proc)
    return fc.get_total_flops() - sum(attention_ops(s) for s in shapes), shapes


def attention_bound_s(shapes) -> float:
    """The attention calls' floor: operations at 3×TF32 or float32 bytes at HBM's rate, each call."""
    return sum(roofline_s(attention_ops(s), attention_bytes(s, 4), PEAK_F32_EXACT_OPS_S) for s in shapes)
