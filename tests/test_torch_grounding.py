"""PyTorch port vs the JAX package: CLIP text→box grounding
(``gaussctrl_exp_tpu_torch/segmentation/grounding.py``, ``clip_vision.py``).

The heat map and box code is numpy on both sides and must agree exactly.
The CLIP towers are held against transformers' Flax CLIP on a tiny torch
``CLIPModel`` saved to a temporary directory, which the JAX package reads
through its ``from_pt=True`` branch (see ``torch_seg_tiny.jax_clip_grounder``
for the patch side).
"""

import json

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.segmentation import grounding as jg
from gaussctrl_exp_tpu_torch.segmentation import grounding as tg
from gaussctrl_exp_tpu_torch.segmentation.clip_vision import CLIPModel, CLIPVisionConfig, load_clip
from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_seg_tiny import jax_clip_grounder, write_tiny_clip

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 on both sides, summed in other orders (measured ≤ 8e-7 of the
# largest entry on the patch embeddings and text features)
CLIP_RTOL = 1e-5


def _heat(seed, shape=(9, 11)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_similarity_heatmap_is_jax_exactly():
    rng = np.random.default_rng(0)
    p, t = rng.standard_normal((6, 7, 5)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    p[2, 3] = 0.0  # a zero patch: the 1e-8 floor
    np.testing.assert_array_equal(tg.similarity_heatmap(p, t), jg.similarity_heatmap(p, t))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_are_jax_exactly(seed):
    mask = np.random.default_rng(seed).uniform(size=(13, 17)) > 0.55
    got = tg._connected_components(mask)
    np.testing.assert_array_equal(got, jg._connected_components(mask))
    assert got.max() > 2


@pytest.mark.parametrize("case", ["random", "ties", "flat", "culled", "capped"])
def test_heatmap_to_boxes_is_jax_exactly(case):
    heat, kw = _heat(3), {}
    if case == "ties":  # equal scores keep argsort(...)[::-1]'s order
        heat = np.zeros((8, 8), np.float32)
        heat[1, 1] = heat[5, 5] = heat[1, 6] = 1.0
        kw = dict(rel_threshold=0.5, min_area=1)
    elif case == "flat":
        heat = np.full((8, 8), 0.5, np.float32)
    elif case == "culled":
        kw = dict(rel_threshold=0.5, min_area=4)
    elif case == "capped":
        kw = dict(rel_threshold=0.3, min_area=1, max_boxes=2)
    gb, gs = tg.heatmap_to_boxes(heat, **kw)
    wb, ws = jg.heatmap_to_boxes(heat, **kw)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws)
    assert gb.dtype == wb.dtype == np.float32
    if case == "ties":
        assert len(gb) == 3


def test_clip_patch_box_provider_is_jax_exactly():
    """The provider on seeded encoders: the same boxes, phrases and scores,
    in image pixels, the text embedding cached."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((4, 6, 8)).astype(np.float32)
    texts = {"bear": rng.standard_normal(8).astype(np.float32)}
    calls = []

    def embed_text(text):
        calls.append(text)
        return texts[text]

    kw = dict(rel_threshold=0.6, min_area=1)
    port = tg.ClipPatchBoxProvider(lambda img: table, embed_text, **kw)
    ref = jg.ClipPatchBoxProvider(lambda img: table, texts.__getitem__, **kw)
    img = np.zeros((60, 90, 3), np.uint8)
    for _ in range(2):
        got, want = port(img, "bear"), ref(img, "bear")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    assert calls == ["bear"] and len(got[0]) > 0


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_tiny_clip(tmp_path_factory.mktemp("clip"))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=CLIP_RTOL * float(np.abs(want).max()), err_msg=what)


def test_load_clip_grounder_matches_flax_clip(clip_dir):
    """Patch embeddings, text features and boxes on a float render and a
    uint8 image. The box comparison is exact where no heat value lies within
    the tolerance of its threshold; where one does, the thresholded cells
    must agree away from it."""
    ref = jax_clip_grounder(clip_dir, rel_threshold=0.6, min_area=1)
    port = tg.load_clip_grounder(str(clip_dir), rel_threshold=0.6, min_area=1, device="cpu")
    rng = np.random.default_rng(5)
    compared = 0
    images = [rng.uniform(-0.05, 1.05, (64, 80, 3)).astype(np.float32), rng.integers(0, 256, (50, 50, 3), dtype=np.uint8)]
    for img in images:
        want_p, got_p = ref.embed_patches(img), port.embed_patches(img)
        assert got_p.shape == want_p.shape == (4, 4, 24)
        _close(got_p, want_p, "patch embeddings")
        for text in ("a bear", "the statue of a bear"):
            want_t, got_t = ref.embed_text(text), port.embed_text(text)
            assert got_t.shape == want_t.shape == (24,)
            _close(got_t, want_t, "text features")
            heat = jg.similarity_heatmap(want_p, want_t)
            thr = heat.min() + 0.6 * (heat.max() - heat.min())
            tol = CLIP_RTOL * float(np.abs(heat).max()) * 10
            got_heat = tg.similarity_heatmap(got_p, got_t)
            near = np.abs(heat - thr) <= tol
            np.testing.assert_array_equal((got_heat >= thr)[~near], (heat >= thr)[~near])
            if not near.any():
                got, want = port(img, text), ref(img, text)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
                np.testing.assert_allclose(got[2], want[2], rtol=0, atol=tol)
                compared += 1
    assert compared > 0


def test_clip_pixels_are_the_jax_preprocessing():
    """CLIP's input: truncation to uint8, PIL's bilinear resize, CLIP's
    mean and std, NCHW."""
    from PIL import Image

    img = np.random.default_rng(6).uniform(0, 1, (40, 52, 3)).astype(np.float32)
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(u8).resize((28, 28), Image.BILINEAR), np.float32) / 255.0
    want = ((want - tg.CLIP_MEAN) / tg.CLIP_STD).transpose(2, 0, 1)[None]
    np.testing.assert_array_equal(tg.clip_pixels(img, 28), want)


def test_text_features_pool_at_the_first_eos_unless_eos_is_2():
    """transformers' Flax CLIP pools at the argmax of the ids when the
    config's eos_token_id is 2 (the older configs), else at the first id
    equal to it."""
    text = CLIPTextConfig(vocab_size=50, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                          num_attention_heads=2, max_position_embeddings=8)
    vision = CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
                              image_size=14, patch_size=7)
    torch.manual_seed(0)
    ids = torch.tensor([[0, 5, 40, 7, 9, 9, 9, 9], [0, 9, 3, 9, 9, 9, 9, 9]])
    for eos, pos in ((2, [2, 1]), (9, [4, 1])):
        m = CLIPModel(text, vision, 12, eos_token_id=eos).eval()
        with torch.no_grad():
            h = m.text_model(ids)
            want = m.text_projection(h[torch.arange(2), torch.tensor(pos)])
            torch.testing.assert_close(m.get_text_features(ids), want, rtol=0, atol=0)


def test_load_clip_reads_a_transformers_directory(clip_dir, tmp_path):
    """The config's fields and transformers' defaults for those it leaves
    out; a non-quick_gelu tower is refused."""
    m = load_clip(clip_dir, device="cpu")
    assert m.vision_config == CLIPVisionConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                                               num_attention_heads=4, image_size=28, patch_size=7)
    assert m.eos_token_id == 49407 and m.text_projection.weight.shape == (24, 32)
    assert not m.training and all(not p.requires_grad for p in m.parameters())
    cfg = json.loads((clip_dir / "config.json").read_text())
    cfg["vision_config"]["hidden_act"] = "gelu"
    bad = tmp_path / "gelu"
    bad.mkdir()
    (bad / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="quick_gelu"):
        load_clip(bad, device="cpu")
