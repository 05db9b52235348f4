"""PyTorch port vs the JAX package: SAM, its checkpoint loader, its input
preprocessing (Pillow's bilinear in both packages), the logits' resize and
LangSAM (``gaussctrl_exp_tpu_torch/segmentation/``, ``utils/resize.py``).

Seeded numpy inputs go through the JAX function and the port's, at tiny
widths on one CPU thread. SAM's weights go across through
``sam_state_dict_from_flax`` (or a ``.pth`` written from the JAX tree).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.segmentation import lang_sam as jlang_sam
from gaussctrl_exp_tpu.segmentation import sam as jsam
from gaussctrl_exp_tpu_torch.segmentation import lang_sam, sam
from gaussctrl_exp_tpu_torch.segmentation.convert import load_sam, sam_config_from_state_dict, sam_state_dict_from_flax
from gaussctrl_exp_tpu_torch.utils.resize import jax_resize_bilinear
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_seg_tiny import PADDED, TINY, jax_langsam_logits, jax_sam_params, jax_upscaled_logits, write_sam_pth

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 on both sides, summed in other orders: SAM's embedding and logits
# (measured ≤ 2e-6 of the embedding's largest entry, 5e-7 on the logits)
SAM_RTOL = 1e-5
# the two resizes and everything after them (measured ≤ 2.4e-7)
RESIZE_ATOL = 1e-6
# a mask may differ from JAX's only where the JAX logit is within this
# share of its largest magnitude of 0 (the logits agree to ~5e-6 of it)
MASK_MARGIN = 1e-4
CONFIGS = {"tiny": TINY, "padded": PADDED}


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg in CONFIGS.items():
        params = jax_sam_params(cfg, seed=len(out))
        m = sam.SAM(sam.SAMConfig(**cfg))
        m.load_state_dict(sam_state_dict_from_flax(params), strict=True)
        out[name] = (params, m.eval())
    return out


@functools.lru_cache(maxsize=None)
def _jax_fn(name: str, method: str, multimask: bool = False):
    """The JAX SAM's ``method`` at CONFIGS[name], jitted (eager Flax
    compiles every op for every shape)."""
    m = jsam.SAM(jsam.SAMConfig(**CONFIGS[name]))
    if method == "predict_boxes":
        return jax.jit(lambda p, emb, boxes: m.apply(p, emb, boxes, multimask, method=jsam.SAM.predict_boxes))
    return jax.jit(lambda p, *a: m.apply(p, *a, method=getattr(jsam.SAM, method)))


def _image(cfg, seed):
    return np.random.default_rng(seed).standard_normal((1, cfg["img_size"], cfg["img_size"], 3)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_image_matches_jax(models, name):
    params, m = models[name]
    cfg = CONFIGS[name]
    img = _image(cfg, 3)
    want = _jax_fn(name, "encode_image")(params, jnp.asarray(img))
    with torch.no_grad():
        got = m.encode_image(torch.as_tensor(img))
    hw = cfg["img_size"] // cfg["patch_size"]
    assert got.shape == (1, hw, hw, cfg["prompt_dim"])
    _close(got, want, SAM_RTOL, "image embedding")


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_predict_boxes_matches_jax(models, name, multimask):
    params, m = models[name]
    cfg = CONFIGS[name]
    hw = cfg["img_size"] // cfg["patch_size"]
    emb = np.random.default_rng(4).standard_normal((3, hw, hw, cfg["prompt_dim"])).astype(np.float32)
    boxes = np.array([[8, 8, 40, 48], [0, 0, cfg["img_size"], cfg["img_size"]], [30.5, 2, 33, 61]], np.float32)
    want_m, want_iou = _jax_fn(name, "predict_boxes", multimask)(params, jnp.asarray(emb), jnp.asarray(boxes))
    with torch.no_grad():
        got_m, got_iou = m.predict_boxes(torch.as_tensor(emb), torch.as_tensor(boxes), multimask)
    assert got_m.shape == (3, 3 if multimask else 1, 4 * hw, 4 * hw)
    _close(got_m, want_m, SAM_RTOL, "low-res logits")
    _close(got_iou, want_iou, SAM_RTOL, "iou")


def test_prompt_encoder_matches_jax(models):
    """Point prompts (positive, negative, padding), boxes and the dense
    positional grid."""
    params, m = models["tiny"]
    rng = np.random.default_rng(12)
    points = rng.uniform(0, 64, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    boxes = np.array([[8, 8, 40, 48], [1, 2, 60, 33]], np.float32)
    jm = jsam.SAM(jsam.SAMConfig(**TINY))
    want_sparse, want_dense = jm.apply(params, jnp.asarray(points), jnp.asarray(labels), jnp.asarray(boxes),
                                       method=lambda s, p, l, b: s.prompt_encoder(p, l, b))
    want_pe = jm.apply(params, method=lambda s: s.prompt_encoder.dense_pe())
    with torch.no_grad():
        sparse, dense = m.prompt_encoder(torch.as_tensor(points), torch.as_tensor(labels), torch.as_tensor(boxes))
        pe = m.prompt_encoder.dense_pe()
    assert sparse.shape == (2, 5, TINY["prompt_dim"])
    _close(sparse, want_sparse, SAM_RTOL, "sparse prompt")
    _close(dense.detach(), want_dense, 0, "dense prompt")
    _close(pe, want_pe, SAM_RTOL, "dense positional grid")


def test_sam_config_is_read_from_the_weights(models):
    for name, cfg in CONFIGS.items():
        sd = sam_state_dict_from_flax(models[name][0])
        assert sam_config_from_state_dict(sd, decoder_heads=cfg["decoder_heads"]) == sam.SAMConfig(**cfg)
    with torch.device("meta"):
        for c in (sam.SAMConfig(), sam.vit_l_config(), sam.vit_b_config()):  # segment_anything's three
            assert sam_config_from_state_dict(sam.SAM(c).state_dict()) == c


def test_load_sam_reads_a_segment_anything_pth(models, tmp_path):
    """A .pth keyed as segment_anything's (the JAX package's
    flax_to_torch_keys, plus pixel statistics and the mask downscaler)
    loads with strict=True and gives the JAX outputs."""
    params, _ = models["padded"]
    path = write_sam_pth(tmp_path / "sam.pth", params)
    m = load_sam(path, sam.SAMConfig(**PADDED), device="cpu")
    assert not m.training and all(not p.requires_grad for p in m.parameters())
    img = _image(PADDED, 5)
    boxes = np.array([[4, 6, 70, 50]], np.float32)
    want = _jax_fn("padded", "__call__")(params, jnp.asarray(img), jnp.asarray(boxes))
    with torch.no_grad():
        got = m(torch.as_tensor(img), torch.as_tensor(boxes))
    _close(got[0], want[0], SAM_RTOL, "masks")
    _close(got[1], want[1], SAM_RTOL, "iou")
    # without a config: the weights' shapes (8 decoder heads assumed)
    assert load_sam(path, device="cpu").cfg == sam.SAMConfig(**dict(PADDED, decoder_heads=8))


def test_load_sam_refuses_an_unknown_key(models, tmp_path):
    path = write_sam_pth(tmp_path / "sam.pth", models["tiny"][0])
    sd = torch.load(path, weights_only=True)
    sd["image_encoder.blocks.0.attn.extra.weight"] = torch.zeros(2)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="unconverted SAM keys.*attn.extra"):
        load_sam(path, sam.SAMConfig(**TINY), device="cpu")


def test_load_sam_refuses_a_missing_card(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so cuda is not refused")
    path = write_sam_pth(tmp_path / "sam.pth", models["tiny"][0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_sam(path)


# ------------------------------------------------------------------ resizes


@pytest.mark.parametrize("hw, size", [((512, 512), (1024, 1024)), ((512, 512), (224, 224)),
                                      ((375, 500), (1024, 768)), ((37, 53), (29, 71)), ((64, 48), (64, 17))])
def test_sam_preprocess_is_jax_bit_for_bit(hw, size):
    """The longest side resized to the model input's (Pillow's bilinear,
    up and down), normalised and padded, as the JAX package does."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want, want_scale = jsam.preprocess_image(img, max(size))
    got, scale = sam.preprocess_image(img, max(size))
    assert scale == want_scale and got.dtype == np.float32 and got.shape == (1, max(size), max(size), 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 128, 128), (2, 3, 20, 28), (2, 3, 32, 17), (2, 1, 7, 64)])
def test_jax_resize_bilinear_matches_jax(shape):
    x = np.random.default_rng(6).standard_normal((*shape[:2], 32, 32)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "bilinear"))
    np.testing.assert_allclose(jax_resize_bilinear(torch.as_tensor(x), shape).numpy(), want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("out_hw", [(64, 64), (48, 56), (37, 64)])
def test_postprocess_masks_matches_jax(out_hw):
    """256 → 1024-style upsample, crop, resize to (H, W), threshold at 0,
    here from a 16² logit grid at a 64² model input."""
    low = np.random.default_rng(7).standard_normal((2, 3, 16, 16)).astype(np.float32)
    scale = 64 / max(out_hw)
    want_logits = jax_upscaled_logits(low, scale, out_hw, 64)
    got_logits = sam.upscale_logits(torch.as_tensor(low), scale, out_hw, 64).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=RESIZE_ATOL)
    want = np.asarray(jsam.postprocess_masks(jnp.asarray(low), scale, out_hw, 64))
    got = sam.postprocess_masks(torch.as_tensor(low), scale, out_hw, 64).numpy()
    assert got.dtype == bool and got.shape == (2, 3, *out_hw)
    away = np.abs(want_logits) > MASK_MARGIN * np.abs(want_logits).max()
    np.testing.assert_array_equal(got[away], want[away])


@pytest.mark.parametrize("hw", [(48, 56), (64, 64), (33, 20)])
def test_preprocess_image_matches_jax(hw):
    img = np.random.default_rng(8).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want, want_scale = jsam.preprocess_image(img, 64)
    got, scale = sam.preprocess_image(img, 64)
    assert scale == want_scale
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ LangSAM


def _langsams(models, provider_pair):
    params, m = models["tiny"]
    return (lang_sam.LangSAM(m, box_provider=provider_pair[0]),
            jlang_sam.LangSAM(params, jsam.SAMConfig(**TINY), box_provider=provider_pair[1]))


def _assert_predict_matches(port, ref, img, text):
    got = port.predict(img, text)
    want = ref.predict(img, text)
    boxes, logits = jax_langsam_logits(ref, img, text)
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[2]) == list(want[2]) and np.array_equal(got[3], want[3])
    assert got[0].dtype == bool and got[0].shape == want[0].shape == (len(boxes), *img.shape[:2])
    away = np.abs(logits) > MASK_MARGIN * np.abs(logits).max()
    np.testing.assert_array_equal(got[0][away], want[0][away])
    assert away.mean() > 0.99
    return got


def test_lang_sam_with_the_whole_frame_matches_jax(models):
    port, ref = _langsams(models, (lang_sam.FullImageBox(), jlang_sam.FullImageBox()))
    img = np.random.default_rng(9).integers(0, 256, (48, 56, 3), dtype=np.uint8)
    masks, boxes, phrases, _ = _assert_predict_matches(port, ref, img, "a bear statue")
    assert boxes.tolist() == [[0, 0, 56, 48]] and phrases == ["a bear statue"]


def test_lang_sam_with_precomputed_boxes_matches_jax(models, tmp_path):
    (tmp_path / "boxes.json").write_text(json.dumps({"frame_00001.png": [[4, 4, 30, 30], [10, 10, 40, 44]]}))
    port_boxes = lang_sam.PrecomputedBoxes(tmp_path / "boxes.json")
    with pytest.raises(KeyError):
        port_boxes(np.zeros((4, 4, 3), np.uint8), "object")
    pair = (port_boxes.bind("frame_00001.png"),
            jlang_sam.PrecomputedBoxes(tmp_path / "boxes.json").bind("frame_00001.png"))
    port, ref = _langsams(models, pair)
    img = np.random.default_rng(10).integers(0, 256, (48, 48, 3), dtype=np.uint8)
    masks, boxes, _, _ = _assert_predict_matches(port, ref, img, "object")
    assert masks.shape == (2, 48, 48) and boxes.shape == (2, 4)


def test_lang_sam_without_boxes_gives_no_mask(models):
    port, _ = _langsams(models, (lambda img, text: (np.zeros((0, 4), np.float32), [], np.zeros(0, np.float32)), None))
    masks, boxes, phrases, _ = port.predict(np.zeros((20, 30, 3), np.uint8), "nothing")
    assert masks.shape == (0, 20, 30) and boxes.shape == (0, 4) and phrases == []
    np.testing.assert_array_equal(port.as_mask_provider()(np.zeros((20, 30, 3), np.float32), "nothing"),
                                  np.zeros((20, 30), np.float32))


def test_as_mask_provider_on_a_float_image_matches_jax(models):
    """A float render is truncated to uint8 (not rounded), as the JAX
    package does, and the box masks are united."""
    two = lambda img, text: (np.array([[2, 3, 30, 40], [20, 1, 60, 30]], np.float32), [text] * 2,  # noqa: E731
                             np.ones(2, np.float32))
    port, ref = _langsams(models, (two, two))
    rgb = np.random.default_rng(11).uniform(-0.1, 1.1, (48, 64, 3)).astype(np.float32)
    got = port.as_mask_provider()(rgb, "bear")
    want = ref.as_mask_provider()(rgb, "bear")
    _, logits = jax_langsam_logits(ref, (np.clip(rgb, 0, 1) * 255).astype(np.uint8), "bear")
    assert got.dtype == np.float32 and got.shape == (48, 64) and set(np.unique(got)) <= {0.0, 1.0}
    away = np.abs(logits).min(axis=0) > MASK_MARGIN * np.abs(logits).max()
    np.testing.assert_array_equal(got[away], want[away])
    assert 0 < got.mean() < 1
