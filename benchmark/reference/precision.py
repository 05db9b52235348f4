"""Operand rounding for the plain references: the precision they compute in.

The references compute every product in float32 with TF32 off. A control
computes the same arithmetic with the operands of each product (matrix
product, convolution, attention) rounded to a lower type first: ``bf16``
(the step below float32) or ``fp8`` (float8 e4m3 with one scale per tensor,
the step below bfloat16). Sums, norms and softmax stay float32.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "bf16", "fp8")
E4M3_MAX = 448.0
_mode = ["fp32"]


@contextlib.contextmanager
def precision(mode: str):
    """Compute the references' products in ``mode`` inside the block."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
    old = _mode[0]
    _mode[0] = mode
    try:
        yield
    finally:
        _mode[0] = old


def mode() -> str:
    return _mode[0]


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the current mode's operand type, returned in float32."""
    m = _mode[0]
    if m == "fp32":
        return x
    if m == "bf16":
        return x.to(torch.bfloat16).float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32_off() -> None:
    """Full float32 products on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
