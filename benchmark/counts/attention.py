"""The attention forward's bound (kernel B3): non-causal softmax attention of
(B, H, S, T, D) does 4·B·H·S·T·D operations (two products) and reads q, k, v
and writes o once. In bf16 the products run on the tensor cores."""

from __future__ import annotations

from .peaks import PEAK_BF16_OPS_S, PEAK_F32_OPS_S, roofline_s


def attention_ops(shape) -> int:
    B, H, S, T, D = shape
    return 4 * B * H * S * T * D


def attention_bytes(shape, itemsize: int = 2) -> int:
    B, H, S, T, D = shape
    return itemsize * B * H * D * (2 * S + 2 * T)


def attention_bound_s(shape, bf16: bool = True) -> float:
    peak = PEAK_BF16_OPS_S if bf16 else PEAK_F32_OPS_S
    return roofline_s(attention_ops(shape), attention_bytes(shape, 2 if bf16 else 4), peak)
