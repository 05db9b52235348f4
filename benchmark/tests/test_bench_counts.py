"""The frozen counts pinned on known shapes, so that a roofline or mfu share
cannot read above 100 % from a miscount."""

from __future__ import annotations

import json
import math

import pytest
import torch

from benchmark import harness, scene
from benchmark.counts import blend, peaks, sd, splat
from benchmark.counts.attention import attention_bound_s, attention_ops
from benchmark.runners._edit import model_cfg
from benchmark.reference import sd as ref_sd
from benchmark.reference import splat as ref_splat


@pytest.fixture(scope="module")
def sd15():
    return model_cfg(json.loads((harness.BENCH / "configs" / "sd15-cn-depth.json").read_text()))


def test_peaks():
    assert (peaks.PEAK_BF16_OPS_S, peaks.PEAK_F32_OPS_S, peaks.PEAK_BYTES_S) == (989e12, 67e12, 3.35e12)
    assert peaks.roofline_s(67e12, 0, peaks.PEAK_F32_OPS_S) == 1.0
    assert peaks.roofline_s(0, 3.35e12, peaks.PEAK_F32_OPS_S) == 1.0


def test_attention_bound_reproduces_the_edit_paths_b3_shape():
    # B3's bound at the generation step's 64² self-attention, bf16 (PERF.md: 0.39085 ms)
    assert attention_ops((18, 8, 4096, 4096, 40)) == 4 * 18 * 8 * 4096 * 4096 * 40
    assert attention_bound_s((18, 8, 4096, 4096, 40)) * 1e3 == pytest.approx(0.39085, abs=5e-6)


@pytest.mark.parametrize("part,millions", [("unet", 859.520964), ("controlnet", 361.27912), ("vae", 83.653863),
                                           ("text", 123.06048)])
def test_sd_parameter_counts(sd15, part, millions):
    spec = ref_sd.param_spec(sd15)[part]
    assert sum(math.prod(s) for s, _ in spec.values()) / 1e6 == pytest.approx(millions, abs=1e-6)


def test_generation_step_counts(sd15):
    ops, shapes = sd.eps(sd15, 18, attn_align=True)
    # 16 UNet and 7 ControlNet transformer blocks: 5 B3 calls per self-attention, 1 per cross-attention
    assert len(shapes) == 23 * 6
    assert shapes.count((18, 8, 4096, 4096, 40)) == 2 * 5 * 2 + 3 * 5
    assert ops / 1e12 == pytest.approx(31.9065440256, rel=1e-9)
    assert sum(attention_bound_s(s) for s in shapes) * 1e3 == pytest.approx(16.2966, rel=1e-4)
    assert sd.decode_ops(sd15, 9) / 1e12 == pytest.approx(22.630670401536, rel=1e-9)


def test_inversion_step_counts(sd15):
    ops, shapes = sd.eps(sd15, 1, attn_align=False)
    assert len(shapes) == 46 and ops / 1e12 == pytest.approx(1.08656541696, rel=1e-9)
    assert sd.encode_ops(sd15, 1) / 1e12 == pytest.approx(1.116658466816, rel=1e-9)


def small_frame():
    cfg = dict(num_gaussians=300, capacity=300, sh_degree=3, num_views=2, image_size=48, focal=60.0)
    g = scene.make_gaussians(cfg, 5, "cpu")
    cam = scene.make_cameras(cfg, 5)[0]
    out = ref_splat.render(g, cam, 30000, torch.ones(3), depth=False)
    return g, cam, out


def test_blend_pairs_by_brute_force():
    """Walked and composited pairs against a per-pixel loop over each tile's list."""
    g, cam, out = small_frame()
    p, (ids, starts, counts) = out["proj"], out["bins"]
    got = blend.pairs(p["xys"], p["conic"], out["opac"], out["bins"], cam["W"], cam["H"])
    walked = composited = 0
    W = cam["W"]
    nx = (W + 15) // 16
    for t in range(counts.numel()):
        lst = ids[starts[t]: starts[t] + counts[t]].tolist()
        for pix in range(256):
            x, y = (t % nx) * 16 + pix % 16, (t // nx) * 16 + pix // 16
            T = 1.0
            for gi in lst:
                walked += 1
                dx, dy = p["xys"][gi, 0].item() - x, p["xys"][gi, 1].item() - y
                a_, b_, c_ = p["conic"][gi].tolist()
                s = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
                al = min(0.999, out["opac"][gi].item() * math.exp(-s))
                if s < 0 or al < 1 / 255:
                    continue
                if T * (1 - al) <= 1e-4:
                    break
                composited += 1
                T *= 1 - al
    assert got["walked"] == walked and got["composited"] == composited
    assert got["composited"] <= got["evaluated"] <= got["walked"]


def test_blend_ops_and_bytes():
    assert blend.blend_ops(3, 10, 4) == 17 * 10 + (4 + 6) * 4
    assert blend.blend_ops(3, 10, 4, backward=True) == 17 * 10 + (34 + 12) * 4
    assert blend.blend_bytes(2, 3, 5, 16, 16) == 4 * (2 * 9 + 5 + 2 + 256 * 4)


def test_splat_step_counts():
    assert splat.frame_ops(10) == 3530
    assert splat.loss_ops(512, 512, 8, 32) > 0
    assert splat.step_ops(10, 100, 7, 9, 11) == 3 * 3530 + 7 + 9 + 11 + 12 * 59 * 100
