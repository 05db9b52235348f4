"""The triplane term's counted bytes and operations (``counts/triplane.py``)
against a hand count at one shape, and its layer list against the edit
stack's self-attentions at SD 1.x's widths."""

from __future__ import annotations

import pytest

from benchmark.counts import triplane
from benchmark.counts.peaks import PEAK_BF16_OPS_S

SD = dict(block_out=(320, 640, 1280, 1280), layers_per_block=2, heads=8, cross_dim=768, cond_chans=(16, 32, 96, 256),
          latent=64, image=512)


def test_seven_mixing_layers_at_64_squared():
    # the ControlNet's down block 0 (2), the UNet's down block 0 (2) and up block 3 (3)
    assert triplane.layers(SD, 64) == [(4096, 320)] * 7
    assert triplane.layers(SD, 32) == [(1024, 640)] * 7  # the other grids are not the geometry's
    assert triplane.layers(SD, 16) == [(256, 1280)] * 7


def test_layer_bytes_and_ops_by_hand():
    B, V, S, C, heads, r = 18, 9, 4096, 320, 8, 32
    act = 2 * 18 * 4096 * 320  # 47,185,920: one bf16 activation
    planes = 2 * 3 * 4 * 32 * 32 * 321  # sums and counts, float32, written and read: 7,888,896
    geometry = 4 * 3 * 9 * 4096  # 442,368
    attention = 2 * 18 * 8 * 40 * (2 * 4096 + 2 * 4096)  # q, the features twice, the output: 188,743,680
    assert triplane.layer_bytes(B, V, S, C, heads, r) == 4 * act + planes + geometry + attention == 385_818_624
    # two products of 18 × 8 heads × 4096 × 4096 × 40 multiply-adds
    assert triplane.layer_ops(B, S, C, heads) == 4 * 18 * 8 * 4096 * 4096 * 40 == 386_547_056_640


def test_a_step_is_bound_by_its_operations():
    ops = triplane.layer_ops(18, 4096, 320, 8)
    assert triplane.step_bound_s(SD, 18, 9, 64, 32) == pytest.approx(7 * ops / PEAK_BF16_OPS_S)  # 2.74 ms
