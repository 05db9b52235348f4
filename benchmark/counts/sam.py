"""Operations and bytes of LangSAM's networks, counted on the reference at the
cell's shapes on the meta device (``torch.utils.flop_counter``: 2 per
multiply-add of every matrix product and convolution, the relative-position
products of the encoder's attention included; norms, softmax, GELU and the
resizes not counted).

SAM's encoder at 1024² (ViT-H) is 5.96e12 operations: its windowed blocks
project the 4,900 tokens of the padded grid, as the program does. The
encode's floor is the larger of its operations at a third of the TF32 rate
(an exact float32 product as three TF32 ones) and its bytes (weights, input
and output once) at HBM's rate.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import clip as ref_clip
from ..reference import sam as ref_sam
from ..reference.sd import Params
from .peaks import PEAK_TF32_OPS_S, roofline_s

PEAK_F32_EXACT_OPS_S = PEAK_TF32_OPS_S / 3  # 3×TF32, PERF.md's bound of exact float32 products


def _ops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def encode_ops(cfg: dict) -> int:
    S = cfg["img_size"]
    return _ops(lambda: ref_sam.encode(Params(), cfg, _meta(1, 3, S, S)))


def encode_bytes(cfg: dict) -> int:
    """float32 weights of the image encoder, its input and its output, each once."""
    enc = sum(math.prod(s) for n, (s, _) in ref_sam.param_spec(cfg).items() if n.startswith("image_encoder."))
    hw = cfg["img_size"] // cfg["patch_size"]
    return 4 * (enc + 3 * cfg["img_size"] ** 2 + hw * hw * cfg["prompt_dim"])


def encode_bound_s(cfg: dict) -> float:
    return roofline_s(encode_ops(cfg), encode_bytes(cfg), PEAK_F32_EXACT_OPS_S)


def decode_ops(cfg: dict) -> int:
    """The prompt encoder and mask decoder for one box (linear in the boxes)."""
    hw = cfg["img_size"] // cfg["patch_size"]
    return _ops(lambda: ref_sam.decode(Params(), cfg, _meta(hw, hw, cfg["prompt_dim"]), _meta(1, 4)))


def clip_image_ops(cfg: dict) -> int:
    """The vision tower and its projection for one image (the text's features are computed once a run)."""
    S = cfg["vision"]["image_size"]
    return _ops(lambda: ref_clip.patch_embeddings(Params(), cfg, _meta(1, 3, S, S)))
