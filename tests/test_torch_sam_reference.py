"""The port's SAM and CLIP grounding against the benchmark's plain reference
(``benchmark/reference/sam.py``, ``clip.py``), on seeded random weights at
tiny widths on one CPU thread: the image encoder (a windowed block whose
10 × 10 grid pads to 12, and a global block), the box decoder, the
grounder's patch embeddings, text features, heat map and boxes, LangSAM's
mask, the reference's Pillow resize, and SAM ViT-H's size.

The reference follows segment_anything's decoder LayerNorm ε (1e-5) where
the port uses 1e-6; the exact comparisons give the reference the port's ε
(``decoder_ln_eps``), and one test bounds what the departure moves."""

import math

import numpy as np
import pytest
import torch

from benchmark.common import make_weights, tokenize
from benchmark.reference import clip as ref_clip
from benchmark.reference import sam as ref_sam
from benchmark.reference.sd import Params
from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig
from gaussctrl_exp_tpu_torch.segmentation import grounding
from gaussctrl_exp_tpu_torch.segmentation.clip_vision import CLIPModel, CLIPVisionConfig, load_clip
from gaussctrl_exp_tpu_torch.segmentation.lang_sam import LangSAM
from gaussctrl_exp_tpu_torch.segmentation.sam import SAM, SAMConfig
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_seg_tiny import write_tiny_clip

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a 10 × 10 patch grid in windows of 4 (padded to 12), block 1 global
SAM_TINY = dict(img_size=80, patch_size=8, encoder_dim=32, encoder_depth=2, encoder_heads=2, encoder_global_attn=(1,),
                window_size=4, prompt_dim=32, decoder_depth=2, decoder_heads=8, decoder_downsample=2, num_multimask=3,
                mlp_ratio=4.0)
# the port's decoder: an MLP of 8·prompt_dim below prompt_dim 256, LayerNorm ε 1e-6
REF_SAM = dict(SAM_TINY, decoder_mlp_dim=256, decoder_ln_eps=1e-6)
CLIP_TINY = dict(vision=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                             image_size=56, patch_size=7),
                 text=dict(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, max_position_embeddings=77),
                 projection_dim=24)
GROUNDING = dict(rel_threshold=0.75, min_area=2, max_boxes=8)
# float32 on both sides, summed in other orders (measured ≤ 1.2e-6 of the largest entry)
RTOL = 1e-5
# a mask pixel may differ only where the reference's union logit lies within this share of its largest magnitude of 0
MASK_MARGIN = 1e-4
HEAT_MARGIN = 1e-4  # boxes compared only where no heat-map cell lies within this share of its range of the threshold
TEXT = "bear statue"
SAM_H_PARAMETERS = 641_085_924


def _close(got, want, rtol=RTOL):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def _sam(seed):
    W = make_weights(ref_sam.param_spec(REF_SAM), seed, "sam", "cpu")
    m = SAM(SAMConfig(**SAM_TINY))
    m.load_state_dict(W, strict=True)
    return m.eval(), Params(W)


def _clip(seed):
    W = make_weights(ref_clip.param_spec(CLIP_TINY), seed, "clip", "cpu")
    m = CLIPModel(CLIPTextConfig(**CLIP_TINY["text"]), CLIPVisionConfig(**CLIP_TINY["vision"]),
                  CLIP_TINY["projection_dim"], eos_token_id=2)
    m.load_state_dict(W, strict=True)
    return m.eval(), Params(W)


def _frame(seed, hw=(64, 64)):
    """A smooth float frame in [0, 1] (bilinear noise), as a render is."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand((1, 3, 8, 8), generator=g)
    return torch.nn.functional.interpolate(low, hw, mode="bilinear").clamp(0, 1)[0].permute(1, 2, 0).numpy()


BOXES = torch.tensor([[4.0, 8.0, 50.0, 60.0], [20.0, 2.0, 79.0, 40.0], [0.0, 0.0, 80.0, 80.0]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_predict_boxes_match_the_reference(seed):
    m, P = _sam(seed)
    x = torch.randn((1, 80, 80, 3), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        emb = m.encode_image(x)
        low, iou = m.predict_boxes(emb.expand(len(BOXES), -1, -1, -1), BOXES)
        want = ref_sam.encode(P, REF_SAM, x.permute(0, 3, 1, 2))
        low_ref, iou_ref = ref_sam.decode(P, REF_SAM, want[0], BOXES)
    _close(emb, want)
    _close(low, low_ref)
    _close(iou, iou_ref)


def test_the_decoders_layer_norm_departure_is_small():
    """At segment_anything's ε the reference's logits move by far less than
    the benchmark's logit limits (measured ≤ 9.3e-5 of the largest)."""
    m, P = _sam(1)
    x = torch.randn((1, 80, 80, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        low, _ = m.predict_boxes(m.encode_image(x).expand(len(BOXES), -1, -1, -1), BOXES)
        want, _ = ref_sam.decode(P, dict(REF_SAM, decoder_ln_eps=ref_sam.DEC_EPS),
                                 ref_sam.encode(P, REF_SAM, x.permute(0, 3, 1, 2))[0], BOXES)
    _close(low, want, rtol=5e-4)


def test_the_relative_positions_matter():
    """The random relative-position tables move the reference's encode, so
    a program that drops them cannot match it."""
    _, P = _sam(0)
    x = torch.randn((1, 3, 80, 80), generator=torch.Generator().manual_seed(0))
    zeroed = Params({k: torch.zeros_like(v) if "rel_pos" in k else v for k, v in P.t.items()})
    with torch.no_grad():
        a, b = ref_sam.encode(P, REF_SAM, x), ref_sam.encode(zeroed, REF_SAM, x)
    assert float((a - b).abs().max()) > 100 * RTOL * float(a.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grounder_matches_the_reference(seed):
    m, P = _clip(seed)
    g = grounding.clip_grounder(m, tokenize, **GROUNDING)
    rgb = _frame(seed)
    patches, text = g.embed_patches(rgb), g.embed_text(TEXT)
    with torch.no_grad():
        want = ref_clip.patch_embeddings(P, CLIP_TINY, ref_clip.pixels(torch.as_tensor(rgb), 56))[0]
        want_text = ref_clip.text_features(P, CLIP_TINY, torch.as_tensor(tokenize([TEXT])))[0]
        heat = ref_clip.heat_map(want, want_text)
    _close(patches, want)
    _close(text, want_text)
    _close(grounding.similarity_heatmap(patches, text), heat)
    ref = ref_clip.boxes(heat.numpy(), rgb.shape[:2], margin=HEAT_MARGIN, **GROUNDING)
    boxes, _, scores = g(rgb, TEXT)
    assert not ref["near"] and len(boxes) > 0
    np.testing.assert_array_equal(boxes, ref["boxes"])
    _close(scores, ref["scores"])


@pytest.mark.parametrize("seed", range(6))
def test_reference_boxes_are_the_programs_on_one_heat_map(seed):
    """The reference's components (smallest-label propagation) and the
    program's (a scan) give the same boxes and scores on the same map."""
    heat = np.random.default_rng(seed).standard_normal((16, 16)).astype(np.float32)
    kw = dict(GROUNDING, rel_threshold=0.4 + 0.1 * (seed % 4), max_boxes=3 + seed)
    gb, gs = grounding.heatmap_to_boxes(heat, **kw)
    ref = ref_clip.boxes(heat, (16, 16), margin=0.0, **kw)
    np.testing.assert_array_equal(gb, ref["boxes"])
    np.testing.assert_array_equal(gs, ref["scores"].astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_provider_matches_the_reference(seed):
    """LangSAM's union mask against the reference's grounding, SAM and
    upscaling of the same frame, away from the margin."""
    sam, Ps = _sam(seed)
    clip, Pc = _clip(seed)
    rgb = _frame(seed + 10)
    mask = LangSAM(sam, grounding.clip_grounder(clip, tokenize, **GROUNDING)).as_mask_provider()(rgb, TEXT)
    img = ref_sam.to_uint8(torch.as_tensor(rgb))
    with torch.no_grad():
        heat = ref_clip.heat_map(ref_clip.patch_embeddings(Pc, CLIP_TINY, ref_clip.pixels(img, 56))[0],
                                 ref_clip.text_features(Pc, CLIP_TINY, torch.as_tensor(tokenize([TEXT])))[0])
        ref = ref_clip.boxes(heat.numpy(), img.shape[:2], margin=HEAT_MARGIN, **GROUNDING)
        assert not ref["near"] and len(ref["boxes"]) > 0
        x, scale = ref_sam.preprocess(img, 80)
        low, _ = ref_sam.decode(Ps, REF_SAM, ref_sam.encode(Ps, REF_SAM, x), torch.as_tensor(ref["boxes"]) * scale)
        union = ref_sam.upscale(low, scale, img.shape[:2], 80)[:, 0].amax(0)
    sure = union.abs() > MASK_MARGIN * union.abs().max()
    assert mask.dtype == np.float32 and 0 < mask.mean() < 1
    assert torch.equal(torch.as_tensor(mask > 0)[sure], (union > 0)[sure])
    assert float(sure.float().mean()) > 0.99


def test_sam_h_parameter_count():
    with torch.device("meta"):
        m = SAM(SAMConfig())
    assert sum(p.numel() for p in m.parameters()) == SAM_H_PARAMETERS
    # the reference's list also holds the prompt encoder's positional gaussian, a buffer
    spec = ref_sam.param_spec(dict(vars(SAMConfig()), decoder_mlp_dim=2048))
    assert sum(math.prod(s) for s, _ in spec.values()) == SAM_H_PARAMETERS + 2 * 128
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {k: s for k, (s, _) in spec.items()}


def test_clip_grounder_is_load_clip_grounders(tmp_path):
    """``load_clip_grounder`` is ``clip_grounder`` on the directory's model and tokenizer."""
    from gaussctrl_exp_tpu_torch.diffusion.tokenizer import CLIPTokenizer

    root = write_tiny_clip(tmp_path / "clip")
    a = grounding.load_clip_grounder(str(root), device="cpu")
    b = grounding.clip_grounder(load_clip(root, "cpu"), CLIPTokenizer.from_pretrained(str(root)))
    assert (a.rel_threshold, a.min_area, a.max_boxes) == (b.rel_threshold, b.min_area, b.max_boxes) == (0.75, 2, 8)
    for seed in range(3):
        rgb = _frame(seed, (40, 48))
        np.testing.assert_array_equal(a.embed_patches(rgb), b.embed_patches(rgb))
        got, want = a(rgb, "a bear"), b(rgb, "a bear")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(a.embed_text("a bear"), b.embed_text("a bear"))
