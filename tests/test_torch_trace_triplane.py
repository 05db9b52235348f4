"""The TriPlane processor's spans and counters (``triplane_attention.py``,
``pipeline.py``) in a tiny ``edit_images`` on the CPU: in each generation ε
call, one ``attn.triplane`` span holding one ``attn.triplane.planes`` for
each self-attention at the geometry's grid (UNet and ControlNet alike), the
counter ``attn.triplane`` counting them and ``attn.triplane.tokens`` the
B·S·3 tokens each pools; one host span ``edit.geometry`` a chunk, inside
``edit.prepare``; and none of them on the AttnAlign path."""

import pytest

from gaussctrl_exp_tpu_torch.diffusion.attention import Attention
from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
from gaussctrl_exp_tpu_torch.utils import trace
from test_torch_trace import S, VIEWS, Views, _gaussians, _tokenize, _tree
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEW_SPANS = {"attn.triplane", "attn.triplane.planes", "edit.geometry"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


def _edit(processor, steps=2):
    """A tiny edit with ``processor`` over ``VIEWS`` views, traced; the
    self-attention calls at the geometry's grid per ε, counted by hooks."""
    models = init_random_models(1, "cpu", **TINY)
    cfg = EditConfig(edit_prompt="a bear statue", reverse_prompt="a bear", num_inference_steps=steps, chunk_size=2,
                     latent_size=S // 8, attn_processor=processor, triplane_plane_res=4)
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=_tokenize, device="cpu")
    dm = Views()
    pipe.render_reverse(_gaussians(), dm, SplatModelConfig(sh_degree=1))
    grid = (S // 8) ** 2
    at_grid = []
    for net in (models.unet, models.controlnet):
        for name, m in net.named_modules():
            if isinstance(m, Attention) and name.endswith("attn1"):
                m.register_forward_pre_hook(lambda mod, a, kw: at_grid.append(a[0].shape)
                                            if a[0].shape[1] == grid else None, with_kwargs=True)
    trace.enable()
    pipe.edit_images(dm)
    return pipe, at_grid


def test_triplane_spans_and_counters():
    pipe, at_grid = _edit("triplane")
    spans = trace.records()
    by_id, kids = _tree(spans)
    chunks = [s for s in spans if s.name == "edit.chunk"]
    assert len(chunks) == 2
    for c in chunks:
        (prep,) = [s for s in spans if s.name == "edit.prepare" and s.parent == c.id]
        assert kids[prep.id] == ["edit.geometry"]
    geo = [s for s in spans if s.name == "edit.geometry"]
    assert len(geo) == len(chunks) and all(s.events is None and not s.sync for s in geo)
    assert all(s.unit == pipe.cfg.ref_view_num + pipe.cfg.chunk_size for s in geo)

    eps = [s for s in spans if s.name == "sd.eps" and by_id[s.parent].name == "sd.generate"]
    tri = [s for s in spans if s.name == "attn.triplane"]
    # at the tiny stack's top grid: the UNet's down block 0 (1) and last up block (2), the ControlNet's down block 0 (1)
    per_eps = len(at_grid) // len(eps)
    assert len(eps) == 2 * 2 and per_eps == 4 and len(at_grid) == per_eps * len(eps)
    assert len(tri) == len(at_grid)  # one a self-attention at the grid, none elsewhere
    for s in tri:
        assert kids[s.id] == ["attn.triplane.planes"] and s.unit == (S // 8) ** 2
        p = by_id[s.parent]
        while p.name != "sd.eps":
            p = by_id[p.parent]
        assert by_id[p.parent].name == "sd.generate"
    B, L = at_grid[0][0], at_grid[0][1]
    assert B == 2 * (pipe.cfg.ref_view_num + pipe.cfg.chunk_size)
    c = trace.counters()
    assert c["attn.triplane"] == len(tri)
    assert c["attn.triplane.tokens"] == len(tri) * B * L * 3
    assert not any(s.sync for s in spans if s.name in NEW_SPANS)


def test_attn_align_opens_none_of_them():
    _edit("attn_align", steps=1)
    spans = trace.records()
    assert not NEW_SPANS & {s.name for s in spans}
    assert not [k for k in trace.counters() if k.startswith("attn.triplane")]
    assert trace.counters()["edit.chunks"] == 2 and VIEWS == 4
