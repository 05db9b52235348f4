"""The attention wrapper's layout rule (``ops/attention_cuda.reads_in_place``
and ``_strided``) on the CPU: B3, B4 and B5 copy bf16 and fp32 rows 16
bytes at a time, so the kernels read a tensor in place only where D is
contiguous and every row starts on a 16-byte boundary; anything else is
copied and counted."""

import pytest
import torch

from gaussctrl_exp_tpu_torch.diffusion.attention import Attention
from gaussctrl_exp_tpu_torch.ops import attention_cuda
from gaussctrl_exp_tpu_torch.ops.attention_cuda import _strided, reads_in_place


def _head_split_views(channels: int, heads: int = 8, context_dim: int = 768):
    """q, k, v of an SD1.x attention block as its processor receives them:
    self-attention over 64 tokens and cross-attention to 77 text tokens, in
    bf16."""
    torch.manual_seed(0)
    attn = Attention(channels, heads=heads, dim_head=channels // heads, cross_attention_dim=context_dim)
    attn_self = Attention(channels, heads=heads, dim_head=channels // heads)
    seen = []

    def capture(q, k, v, is_cross):
        seen.append((q, k, v))
        return q

    x = torch.randn(2, 64, channels)
    ctx = torch.randn(2, 77, context_dim)
    with torch.no_grad():
        attn_self.to(torch.bfloat16)(x.bfloat16(), processor=capture)
        attn.to(torch.bfloat16)(x.bfloat16(), ctx.bfloat16(), processor=capture)
    return seen


@pytest.mark.parametrize("channels,d", [(320, 40), (640, 80), (1280, 160)])
def test_unet_head_split_views_are_read_in_place(channels, d):
    for q, k, v in _head_split_views(channels):
        for t in (q, k, v):
            assert t.shape[-1] == d and not t.is_contiguous()
            assert reads_in_place(t.shape, t.stride(), t.data_ptr(), t.dtype)
            before = attention_cuda.copies
            assert _strided("q", t) is t
            assert attention_cuda.copies == before


def test_an_offset_view_is_copied_to_an_aligned_tensor():
    """A contiguous bf16 view 8 bytes past a 16-byte boundary: contiguous()
    would hand back the same misaligned memory; the copy is fresh."""
    base = torch.randn(2 * 3 * 50 * 40 + 4).bfloat16()
    t = base[4:].view(2, 3, 50, 40)
    assert t.is_contiguous() and t.data_ptr() % 16 == 8
    assert not reads_in_place(t.shape, t.stride(), t.data_ptr(), t.dtype)
    before = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        c = _strided("k", t)
    assert attention_cuda.copies == before + 1
    assert c.data_ptr() % 16 == 0 and c.is_contiguous() and torch.equal(c, t)


@pytest.mark.parametrize("shape,strides,ptr,dtype,ok", [
    ((2, 8, 64, 40), (20480, 40, 320, 1), 0, torch.bfloat16, True),  # head split of (2, 64, 320)
    ((2, 8, 64, 40), (20480, 40, 320, 1), 4, torch.bfloat16, False),  # 4-byte aligned only
    ((2, 3, 64, 36), (6912, 36, 108, 1), 0, torch.bfloat16, False),  # row stride 36: not a multiple of 8
    ((1, 1, 64, 40), (7, 5, 40, 1), 0, torch.bfloat16, True),  # strides of length-1 dimensions never used
    ((2, 8, 64, 40), (20480, 40, 1, 64), 0, torch.bfloat16, False),  # D not contiguous
    ((2, 3, 50, 40), (6000, 2000, 40, 1), 4, torch.float32, False),  # fp32 rows are copied 16 bytes at a time too
    ((2, 3, 50, 40), (6000, 2000, 1, 50), 0, torch.float32, False),
])
def test_layout_rule(shape, strides, ptr, dtype, ok):
    assert reads_in_place(shape, strides, ptr, dtype) is ok


@pytest.mark.parametrize("shape,strides,ptr,ok", [
    ((2, 8, 64, 40), (20480, 40, 320, 1), 0, True),  # head split of (2, 64, 320)
    ((2, 3, 50, 40), (6000, 2000, 40, 1), 4, False),  # 4 bytes past a 16-byte boundary
    ((2, 3, 50, 40), (6000, 2000, 40, 1), 16, True),
    ((2, 3, 50, 24), (3630, 1210, 242, 1), 0, False),  # row stride 242: rows 8 bytes apart from 16
    ((1, 1, 50, 24), (3, 3, 24, 1), 0, True),  # strides of length-1 dimensions never used
    ((2, 3, 50, 40), (6000, 2000, 1, 50), 0, False),  # D not contiguous
])
def test_layout_rule_fp32_copied_16_bytes_at_a_time(shape, strides, ptr, ok):
    """B3, B4 and B5 copy fp32 rows 16 bytes at a time: rows must start on
    16-byte boundaries, as bf16 rows must."""
    assert reads_in_place(shape, strides, ptr, torch.float32) is ok


def test_fp32_backward_inputs_are_copied_where_misaligned():
    """The wrappers' input check, in the forward and the backward alike,
    copies a misaligned fp32 tensor and leaves an aligned one alone."""
    from gaussctrl_exp_tpu_torch.ops.attention_cuda import _strided

    base = torch.randn(2 * 3 * 50 * 40 + 4)
    t = base[1:-3].view(2, 3, 50, 40)
    assert t.data_ptr() % 16 == 4
    before = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        c = _strided("k", t)
    assert attention_cuda.copies == before + 1 and c.data_ptr() % 16 == 0 and torch.equal(c, t)
    aligned = base[4:].view(2, 3, 50, 40)
    assert _strided("k", aligned) is aligned
