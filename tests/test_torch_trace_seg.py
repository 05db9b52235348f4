"""The segmentation layer's spans and counters (``segmentation/lang_sam.py``,
``grounding.py``) in a masked ``render_reverse`` on the CPU: every ``seg.*``
span nests inside the view's ``invert.mask`` with its ``sync`` and
``device`` flags, and the counters add up to what the grounder found."""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
from gaussctrl_exp_tpu_torch.segmentation.clip_vision import CLIPModel, CLIPVisionConfig
from gaussctrl_exp_tpu_torch.segmentation.grounding import clip_grounder
from gaussctrl_exp_tpu_torch.segmentation.lang_sam import LangSAM
from gaussctrl_exp_tpu_torch.segmentation.sam import SAM, SAMConfig
from gaussctrl_exp_tpu_torch.utils import trace
from test_torch_trace import VIEWS, S, Views, _gaussians, _tokenize, _tree
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SAM_TINY = SAMConfig(img_size=48, patch_size=8, encoder_dim=32, encoder_depth=2, encoder_heads=2,
                     encoder_global_attn=(1,), window_size=4, prompt_dim=32, decoder_heads=8)
SYNC = {"seg.clip.to_host", "seg.mask.to_host"}
DEVICE = {"seg.clip.patches", "seg.sam.encode", "seg.sam.decode", "seg.mask.upscale"}
GROUND = ["seg.clip.patches", "seg.clip.to_host", "seg.boxes"]
SAM_SPANS = ["seg.sam.prep", "seg.sam.encode", "seg.sam.decode", "seg.mask.upscale", "seg.mask.to_host"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


class NoBoxes:
    """A box provider that finds nothing: SAM is skipped."""

    def __call__(self, image, text):
        return np.zeros((0, 4), np.float32), [], np.zeros(0, np.float32)


def _grounder():
    torch.manual_seed(0)
    clip = CLIPModel(CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2),
                     CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                                      image_size=56, patch_size=7), projection_dim=16)
    return clip_grounder(clip.eval(), _tokenize)


@pytest.mark.parametrize("provider", ["clip", "none"])
def test_seg_spans_nest_in_invert_mask_and_counters_add_up(monkeypatch, provider):
    flags = {}
    span = trace.span

    def noting(name, unit=None, device=None, sync=False):
        flags.setdefault(name, set()).add((device is not None, sync))
        return span(name, unit, device, sync)

    monkeypatch.setattr(trace, "span", noting)
    torch.manual_seed(0)
    provide = _grounder() if provider == "clip" else NoBoxes()
    found = []

    def counting(image, text):
        out = provide(image, text)
        found.append(len(out[0]))
        return out

    ls = LangSAM(SAM(SAM_TINY).eval(), counting)
    cfg = EditConfig(reverse_prompt="a bear", langsam_obj="bear statue", num_inference_steps=1, latent_size=S // 8)
    pipe = GaussCtrlEditPipeline(cfg, models=init_random_models(1, "cpu", **TINY), mask_provider=ls.as_mask_provider(),
                                 tokenizer=_tokenize, device="cpu")
    trace.enable()
    pipe.render_reverse(_gaussians(), Views(), SplatModelConfig(sh_degree=1))
    spans = trace.records()
    by_id, kids = _tree(spans)
    masks = [s for s in spans if s.name == "invert.mask"]
    assert [by_id[s.parent].unit for s in masks] == list(range(VIEWS))  # each inside its view
    for s in spans:
        if s.name.startswith("seg."):
            p = by_id[s.parent]
            while p.name != "invert.mask":
                p = by_id[p.parent]
    for m, n in zip(masks, found):
        assert kids[m.id] == ["seg.ground"] + (SAM_SPANS if n else [])
    grounds = [s for s in spans if s.name == "seg.ground"]
    assert all(kids[g.id] == (GROUND if provider == "clip" else []) for g in grounds)
    for name, seen in flags.items():
        if name.startswith("seg."):
            assert seen == {(name in DEVICE, name in SYNC)}, name
    seg = {n for n in flags if n.startswith("seg.")}
    assert seg == ({"seg.ground", *GROUND, *SAM_SPANS} if provider == "clip" else {"seg.ground"})
    with_boxes = sum(1 for n in found if n)
    assert trace.counters()["seg.images"] == VIEWS == len(found)
    assert trace.counters().get("seg.no_box", 0) == VIEWS - with_boxes
    assert trace.counters().get("seg.boxes", 0) == sum(found)
    assert len([s for s in spans if s.name == "seg.sam.encode"]) == with_boxes
    assert (with_boxes > 0) == (provider == "clip")
    assert sorted(pipe.masks) == list(range(VIEWS))
