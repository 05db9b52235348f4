"""The epipolar term's counted bytes and operations (``counts/epipolar.py``)
against a hand count at one shape, its layer list against the UNet's
self-attentions, and the depth generator's ε count (``counts/mvgen.py``) at
SD 1.x's widths."""

from __future__ import annotations

import pytest

from benchmark.counts import epipolar, mvgen
from benchmark.counts.peaks import PEAK_BYTES_S

SD = dict(block_out=(320, 640, 1280, 1280), layers_per_block=2, heads=8, cross_dim=768, in_channels=5, latent=64)


def test_pair_bytes_and_ops_by_hand():
    # 64² grid at width 320: q, K_b, V_b read and the output written, 4 bytes
    # an entry: 4 × 4096 × 320 × 4 = 20,971,520; the table, 9 indices and 9
    # weights a token at 4 bytes: 4096 × 18 × 4 = 294,912
    assert epipolar.pair_bytes(4096, 320) == 20_971_520 + 294_912
    # 9 logits and 9 weighted values a token, 320 multiply-adds each: 4096 × 18 × 320 × 2
    assert epipolar.pair_ops(4096, 320) == 47_185_920


def test_layers_are_the_unets_self_attentions():
    got = epipolar.layers(SD)
    assert len(got) == 16  # 2 × 3 down, 1 mid, 3 × 3 up
    assert sorted(set(got)) == [(64, 1280), (256, 1280), (1024, 640), (4096, 320)]
    assert [S for S, _ in got].count(4096) == 5 and [S for S, _ in got].count(64) == 1


def test_a_step_of_twelve_pairs_is_bound_by_its_bytes():
    pairs = 2 * 12  # both CFG groups, every ordered pair of 4 views
    n = epipolar.step_bytes(SD, pairs)
    assert n == pairs * sum(epipolar.pair_bytes(S, C) for S, C in epipolar.layers(SD))
    assert epipolar.step_bound_s(SD, pairs) == pytest.approx(n / PEAK_BYTES_S)


def test_eps_count_at_sd_widths():
    ops, shapes = mvgen.eps(SD, 4)
    # 16 self- and 16 cross-attentions at CFG batch 8, 8 heads
    assert len(shapes) == 32 and (8, 8, 4096, 4096, 40) in shapes and (8, 8, 4096, 77, 40) in shapes
    assert 5.3e12 < ops < 5.5e12  # the products outside attention: 5.418e12 (6.43e12 with it)
