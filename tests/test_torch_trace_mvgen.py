"""The depth generator's spans and counters (``diffusion/mv_generator.py``,
``correspondence.py``) in a tiny ``sample`` on the CPU: ``mvgen.sample``
holds ``mvgen.prepare`` (the host copy of the depths, the tables) and a
``mvgen.eps`` and ``mvgen.step`` per step; each mixing self-attention's
cross-view part is one ``attn.epipolar`` span inside the step's ε call; the
counters count the steps, the views, the ordered pairs attended, the
rows the pair mask left alone and the mixing self-attentions that took the
plain composition (all of them on the CPU); nothing is recorded before ``enable()`` and
no device span records an event under a profiler alone; and the edit loop's
"correspondence" processor gives the same spans."""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.diffusion.attention import Transformer2D
from gaussctrl_exp_tpu_torch.diffusion.mv_generator import MVGeneratorConfig, init_depth_generator
from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig
from gaussctrl_exp_tpu_torch.utils import trace
from test_torch_trace import S, Views, _gaussians, _tokenize, _tree
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

V, L, STEPS = 3, 8, 2
DEVICE = {"mvgen.sample", "mvgen.tables", "mvgen.eps", "attn.epipolar"}
SYNC = {"mvgen.depth_to_host", "mvgen.tables"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


def _generator(min_overlap=0.2):
    return init_depth_generator(0, latent=L, block_out=(32, 64), heads=2, cross_dim=16, layers_per_block=1,
                                cfg=MVGeneratorConfig(latent_size=L, num_steps=STEPS, min_overlap=min_overlap),
                                device="cpu")


def _sample(gen):
    dm = Views(V)
    g = torch.Generator().manual_seed(0)
    depths = [3.5 + 0.5 * torch.rand((S, S, 1), generator=g) for _ in range(V)]
    ctx = torch.randn((2, V, 77, 16), generator=g)
    return gen.sample(ctx[0], ctx[1], depths, [dm.camera(i) for i in range(V)], generator=g)


def _mixing_layers(unet) -> int:
    """Self-attentions at a grid that has a table: every one of the tiny UNet's."""
    return sum(isinstance(m, Transformer2D) for m in unet.modules())


@pytest.mark.parametrize("min_overlap", [0.2, 1.01], ids=["pairs_kept", "every_view_isolated"])
def test_sample_spans_nest_and_counters_add_up(monkeypatch, min_overlap):
    flags = {}
    span = trace.span

    def noting(name, unit=None, device=None, sync=False):
        flags.setdefault(name, set()).add((device is not None, sync))
        return span(name, unit, device, sync)

    monkeypatch.setattr(trace, "span", noting)
    gen = _generator(min_overlap)
    kept = []
    prepare = gen.prepare
    gen.prepare = lambda d, c: kept.append(prepare(d, c)) or kept[-1]
    trace.enable()
    _sample(gen)
    spans = trace.records()
    by_id, kids = _tree(spans)
    (top,) = [s for s in spans if s.name == "mvgen.sample"]
    assert top.parent is None and top.unit == V
    assert kids[top.id] == ["mvgen.prepare"] + ["mvgen.eps", "mvgen.step"] * STEPS
    (prep,) = [s for s in spans if s.name == "mvgen.prepare"]
    assert kids[prep.id] == ["mvgen.depth_to_host", "mvgen.tables"]
    eps = [s for s in spans if s.name == "mvgen.eps"]
    layers = _mixing_layers(gen.unet)
    for e in eps:
        assert kids[e.id] == ["attn.epipolar"] * layers
    for name, seen in flags.items():
        if name.startswith(("mvgen.", "attn.epipolar")):
            assert seen == {(name in DEVICE, name in SYNC)}, name
    pm = kept[0][2] * (1.0 - np.eye(V))
    pairs, alone = int((pm != 0).sum()), int((pm.sum(1) == 0).sum())
    assert (pairs, alone) == ((V * (V - 1), 0) if min_overlap < 1 else (0, V))
    per_call = 2 * layers * STEPS  # CFG groups × mixing layers × steps
    # on the CPU every mixing self-attention takes the plain composition
    assert trace.counters() == {"mvgen.steps": STEPS, "mvgen.views": V, "attn.epipolar.pairs": pairs * per_call,
                                "attn.epipolar.isolated": alone * per_call, "attn.epipolar.split": layers * STEPS}


def test_nothing_recorded_before_enable_and_no_device_event_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    gen = _generator()
    _sample(gen)
    assert trace.records() == [] and trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _sample(gen)
    spans = trace.records()
    assert {s.name for s in spans} >= DEVICE and all(s.events is None for s in spans)
    assert trace.counters()["mvgen.steps"] == STEPS


def test_edit_correspondence_processor_spans():
    models = init_random_models(1, "cpu", **TINY)
    cfg = EditConfig(edit_prompt="a bear statue", reverse_prompt="a bear", num_inference_steps=1, chunk_size=2,
                     latent_size=S // 8, attn_processor="correspondence")
    pipe = GaussCtrlEditPipeline(cfg, models=models, tokenizer=_tokenize, device="cpu")
    dm = Views()
    pipe.render_reverse(_gaussians(), dm, SplatModelConfig(sh_degree=1))
    trace.enable()
    pipe.edit_images(dm)
    spans = trace.records()
    by_id, _ = _tree(spans)
    epi = [s for s in spans if s.name == "attn.epipolar"]
    assert epi
    for s in epi:  # each inside a generation step's ε call
        p = by_id[s.parent]
        while p.name != "sd.eps":
            p = by_id[p.parent]
    Vc = cfg.ref_view_num + cfg.chunk_size  # the chunk's views, the references first
    chunks = trace.counters()["edit.chunks"]
    assert len(epi) % chunks == 0
    assert trace.counters()["attn.epipolar.pairs"] == len(epi) * 2 * Vc * (Vc - 1)
    assert trace.counters()["attn.epipolar.isolated"] == 0
