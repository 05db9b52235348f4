"""Operations of the edit stack, counted on the reference at the cell's shapes.

The reference runs on the meta device (no data, no time) under
``torch.utils.flop_counter.FlopCounterMode``, which counts 2 operations per
multiply-add of every matrix product and convolution; the attention calls
are recorded with their (B, H, S, T, D) as they are made. Elementwise work
(norms, activations, softmax, the scheduler) is not counted: it is small
beside the products and does not run on the tensor cores.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import sd as ref


def _recording(processor, shapes: list):
    def rec(qh, kh, vh, is_cross):
        B, H, S, D = qh.shape
        T = kh.shape[2]
        calls = 1 if is_cross or processor is ref.plain_processor else 1 + 4
        shapes.extend([(B, H, S, T, D)] * calls)
        return processor(qh, kh, vh, is_cross)

    return rec


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _count(fn) -> tuple[int, list]:
    shapes: list = []
    with FlopCounterMode(display=False) as fc:
        fn(shapes)
    return fc.get_total_flops(), shapes


def eps(mcfg: dict, batch: int, attn_align: bool, coeff: float = 0.6) -> tuple[int, list]:
    """(operations, attention shapes) of one ControlNet + UNet call at ``batch``."""
    h = mcfg["latent"]
    P = ref.Params()
    proc = ref.attn_align(coeff) if attn_align else ref.plain_processor

    def run(shapes):
        p = _recording(proc, shapes)
        lat, t = _meta(batch, 4, h, h), torch.zeros(batch, dtype=torch.long, device="meta")
        ctx, hint = _meta(batch, 77, mcfg["cross_dim"]), _meta(batch, 3, mcfg["image"], mcfg["image"])
        res = ref.controlnet(P, mcfg, lat, t, ctx, hint, 1.0, p)
        ref.unet(P, mcfg, lat, t, ctx, p, res)

    return _count(run)


def decode_ops(mcfg: dict, batch: int) -> int:
    s = mcfg["latent"]
    return _count(lambda _: ref.vae_decode(ref.Params(), mcfg, _meta(batch, 4, s, s)))[0]


def encode_ops(mcfg: dict, batch: int) -> int:
    s = mcfg["image"]
    return _count(lambda _: ref.vae_encode(ref.Params(), mcfg, _meta(batch, 3, s, s)))[0]
