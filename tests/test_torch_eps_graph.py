"""When ``SDControlNetPipeline._eps`` replays a CUDA graph, on the CPU.

A call engages a graph only with no processor and on the card; every CPU
call stays eager, counts ``sd.eps.eager`` and captures nothing. Graphs are
keyed by the device, each input's shape and dtype, the ControlNet's scale
and the TF32 switches, kept at most ``EPS_GRAPHS`` a pipeline (the least
recently used dropped first), and all dropped when the models' parameters
are no longer the storage they were captured with. The captures and
replays themselves, bit for bit against the eager path, are card tests in
``tests/test_torch_kernels.py``.
"""

import copy

import pytest
import torch

from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor, make_cross_view_processor
from gaussctrl_exp_tpu_torch.diffusion.layers import cast_keeping_norms
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import (
    EPS_GRAPHS,
    GraphCache,
    SDControlNetPipeline,
    SDModels,
    eps_graph_key,
    eps_graphed,
    init_random_models,
)
from gaussctrl_exp_tpu_torch.utils import trace
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


@pytest.fixture(scope="module")
def tiny():
    return init_random_models(3, "cpu", **TINY)


def _inputs(B=1, h=8, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn((B, h, h, 4), generator=g).to(dtype)
    t = torch.full((B,), 501, dtype=torch.long)
    ctx = torch.randn((B, 77, TINY["cross_dim"]), generator=g)
    hint = torch.rand((B, 8 * h, 8 * h, 3), generator=g)
    return lat, t, ctx, hint


def test_cpu_calls_stay_eager_count_eager_and_never_capture(tiny):
    pipe = SDControlNetPipeline(tiny)
    lat, _, ctx, hint = _inputs()
    trace.enable()
    z0 = pipe.invert(lat, ctx, hint, num_steps=3)
    assert torch.isfinite(z0).all()
    assert trace.counters() == {"sd.eps.eager": 3}
    assert not pipe.graphs.entries and pipe.graphs.pool is None
    spans = trace.records()
    eps = [s for s in spans if s.name == "sd.eps"]
    assert len(eps) == 3
    for e in eps:
        assert [s.name for s in spans if s.parent == e.id] == ["sd.controlnet", "sd.unet"]


@pytest.mark.parametrize("device", ["cuda", "cuda:1", "cpu"])
@pytest.mark.parametrize("processor", ["none", "default", "cross_view"])
def test_a_graph_engages_only_without_a_processor_on_the_card(device, processor):
    proc = dict(none=None, default=default_processor, cross_view=make_cross_view_processor(0.6))[processor]
    assert eps_graphed(torch.device(device), proc) == (proc is None and device != "cpu")


def _changed(name: str):
    """The inputs and the scale of ``_inputs()`` at 1.0, with one thing changed."""
    lat, t, ctx, hint = _inputs()
    return dict(
        same=((lat + 1, t + 300, ctx * 2, hint / 2), 1.0),
        batch=(_inputs(B=2), 1.0),
        latent_size=(_inputs(h=16), 1.0),
        latent_dtype=((lat.bfloat16(), t, ctx, hint), 1.0),
        t_dtype=((lat, t.int(), ctx, hint), 1.0),
        ctx_width=((lat, t, torch.zeros(1, 77, 16), hint), 1.0),
        hint_dtype=((lat, t, ctx, hint.double()), 1.0),
        cond_scale=((lat, t, ctx, hint), 0.5),
    )[name]


@pytest.mark.parametrize("name", ["same", "batch", "latent_size", "latent_dtype", "t_dtype", "ctx_width",
                                  "hint_dtype", "cond_scale"])
def test_graph_key_follows_shapes_dtypes_and_scale_not_values(name):
    base = eps_graph_key(*_inputs(), 1.0)
    args, scale = _changed(name)
    assert (eps_graph_key(*args, scale) == base) == (name == "same")


@pytest.mark.parametrize("switch", ["cudnn", "matmul"])
def test_graph_key_follows_the_tf32_switches(switch):
    owner = torch.backends.cudnn if switch == "cudnn" else torch.backends.cuda.matmul
    before = owner.allow_tf32
    base = eps_graph_key(*_inputs(), 1.0)
    try:
        owner.allow_tf32 = not before
        assert eps_graph_key(*_inputs(), 1.0) != base
    finally:
        owner.allow_tf32 = before
    assert eps_graph_key(*_inputs(), 1.0) == base


def test_graph_cache_hits_misses_evicts_and_drops_on_new_params():
    cache = GraphCache(2)
    params = (1, 2, 3)
    assert cache.get("a", params) is None and cache.params == params
    cache.pool = "pool"
    cache.put("a", "graph a")
    cache.put("b", "graph b")
    assert cache.get("a", params) == "graph a"  # a is now the most recent
    cache.put("c", "graph c")  # evicts b, the least recently used
    assert list(cache.entries) == ["a", "c"] and cache.get("b", params) is None
    assert cache.get("c", (1, 2, 3)) == "graph c" and cache.pool == "pool"
    assert cache.get("c", (1, 2, 4)) is None  # a parameter moved: every graph goes, and the pool
    assert not cache.entries and cache.pool is None and cache.params == (1, 2, 4)
    assert EPS_GRAPHS == SDControlNetPipeline(None).graphs.size


def test_param_ptrs_follow_the_storage_the_graphs_read(tiny):
    models = SDModels(copy.deepcopy(tiny.unet), copy.deepcopy(tiny.controlnet), tiny.vae)
    pipe = SDControlNetPipeline(models)
    first = pipe.param_ptrs()
    assert pipe.param_ptrs() == first
    n = len(list(models.unet.parameters())) + len(list(models.controlnet.parameters()))
    assert len(first) == 2 + n

    # weights copied in place: the same storage, which the graphs read as it is
    models.unet.load_state_dict({k: v + 1 for k, v in models.unet.state_dict().items()})
    assert pipe.param_ptrs() == first

    w = models.controlnet.conv_in.weight
    w.data = w.data.clone()  # moved
    moved = pipe.param_ptrs()
    assert moved != first

    cast_keeping_norms(models.unet, torch.bfloat16)  # cast: every Linear and Conv weight moves
    cast = pipe.param_ptrs()
    assert cast != moved

    models.unet = copy.deepcopy(models.unet)  # a model replaced
    assert pipe.param_ptrs() != cast
