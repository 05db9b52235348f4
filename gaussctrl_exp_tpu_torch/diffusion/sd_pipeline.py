"""StableDiffusion-ControlNet pipeline: prompt encoding, DDIM inversion and
classifier-free-guided generation.

Port of ``gaussctrl_exp_tpu/diffusion/sd_pipeline.py``. The JAX package's
``lax.scan`` loops are Python loops; the scheduler carry stays float32
whatever the models' type. The public functions keep the JAX package's
NHWC shapes (images (B, H, W, 3), latents (B, h, w, 4)); the models take
(B, C, H, W) tensors. On the card the pipeline stores the UNet's and the
ControlNet's conv weights channels-last (``layers.to_channels_last``) and
hands them the NHWC latents and hint as channels-last views, so that the
stack runs NHWC end to end, as cuDNN's Hopper convolutions and kernel N1
(GroupNorm + SiLU) take it; the VAE stays NCHW. Every method runs without
autograd.

On the card, an ε evaluation with no attention processor (the inversion, the
inpainting loop) replays a CUDA graph of the ControlNet + UNet captured once
per input signature: at B = 1 a step is ~1,900 small launches, which the
host dispatches slower than the device runs them. A call with a processor
(the cross-view generation, whose processors are rebuilt per chunk) and
every CPU call run eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import attention_cuda, groupnorm_cuda
from ..utils import trace
from .controlnet import ControlNet
from .layers import cast_keeping_norms, to_channels_last
from .schedulers import DDIMInverseScheduler, DDIMScheduler, SchedulerConfig
from .text_encoder import CLIPTextConfig, CLIPTextModel
from .unet import UNet2DCondition
from .vae import AutoencoderKL

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to ±2


@dataclasses.dataclass
class SDModels:
    unet: UNet2DCondition
    controlnet: ControlNet
    vae: AutoencoderKL
    text_encoder: Optional[CLIPTextModel] = None
    tokenizer: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype


def _flax_init(module: nn.Module, generator: torch.Generator, zero: tuple = ()) -> nn.Module:
    """Flax's default initialisers in place: lecun-normal (truncated normal,
    fan-in) kernels and zero biases for convs and linear layers, unit scales
    for the norms, N(0, 0.02²) embeddings; then the modules in ``zero`` set
    to zero, as Flax's ``kernel_init=zeros``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
        for m in zero:
            m.weight.zero_()
            m.bias.zero_()
    return module


def _random_module(fn, device, generator, zero=lambda m: ()) -> nn.Module:
    with torch.device("meta"):
        module = fn()
    module = module.to_empty(device=device)
    return _flax_init(module, generator, zero(module)).requires_grad_(False).eval()


def random_text_encoder(cfg: CLIPTextConfig, seed: int, device) -> CLIPTextModel:
    gen = torch.Generator(device=device).manual_seed(seed)
    return _random_module(lambda: CLIPTextModel(cfg), device, gen)


def init_random_models(
    seed: int = 0,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
    block_out=None,
    vae_block_out=None,
    heads: int = None,
    cross_dim: int = None,
    layers_per_block: int = None,
    text_config: Optional[CLIPTextConfig] = None,
) -> SDModels:
    """Random-weight stack with the architecture of the real one, for tests
    and dry runs; SD-1.x widths by default, tiny ones for tests
    (``block_out=(32, 64)``, …). Weights follow Flax's initialisers, drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device``; the
    ControlNet's zero-convs and its conditioning embedding's ``conv_out``
    start at zero as in Flax. The UNet, ControlNet and VAE run in ``dtype``,
    their norms' scale and bias float32 (``layers.cast_keeping_norms``).
    The text encoder (float32, as the JAX package's) is CLIP ViT-L/14 at
    ``cross_dim`` 768, else a 2-layer tower of width ``cross_dim``, unless
    ``text_config`` says otherwise."""
    from .unet import BLOCK_OUT, CROSS_DIM, HEADS, LAYERS_PER_BLOCK
    from .vae import VAE_BLOCK_OUT

    device = resolve_device(device)
    block_out = tuple(block_out or BLOCK_OUT)
    vae_block_out = tuple(vae_block_out or VAE_BLOCK_OUT)
    heads = heads or HEADS
    cross_dim = cross_dim or CROSS_DIM
    layers_per_block = layers_per_block or LAYERS_PER_BLOCK
    if text_config is None:
        text_config = CLIPTextConfig() if cross_dim == 768 else CLIPTextConfig(
            hidden_size=cross_dim, intermediate_size=4 * cross_dim, num_hidden_layers=2,
            num_attention_heads=max(cross_dim // 8, 1))
    kw = dict(block_out=block_out, layers_per_block=layers_per_block, heads=heads,
              cross_dim=cross_dim, temb_dim=block_out[-1])
    gen = torch.Generator(device=device).manual_seed(seed)
    unet = _random_module(lambda: UNet2DCondition(**kw), device, gen)
    controlnet = _random_module(lambda: ControlNet(**kw), device, gen, lambda m: m.zero_convs())
    vae = _random_module(lambda: AutoencoderKL(vae_block_out), device, gen)
    text = _random_module(lambda: CLIPTextModel(text_config), device, gen)
    return SDModels(*(cast_keeping_norms(m, dtype) for m in (unet, controlnet, vae)), text)


@torch.no_grad()
def encode_prompt_ids(models: SDModels, input_ids) -> torch.Tensor:
    """(B, 77) token ids → (B, 77, hidden) CLIP hidden states."""
    device = models.text_encoder.text_model.final_layer_norm.weight.device
    return models.text_encoder(torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device))


def simple_tokenize(texts, max_len: int = 77) -> np.ndarray:
    """Hash-based placeholder tokenizer for weightless tests (real runs use
    the CLIP BPE tokenizer of the checkpoint, tokenizer.py). Python's string
    hash is salted per process: pass a tokenizer of your own where two
    processes must agree."""
    ids = np.zeros((len(texts), max_len), np.int32)
    for i, t in enumerate(texts):
        toks = [49406] + [hash(w) % 49000 for w in t.lower().split()][: max_len - 2] + [49407]
        ids[i, : len(toks)] = toks
    return ids


def tokenize(models: SDModels, texts, max_len: int = 77) -> np.ndarray:
    """The checkpoint's CLIP BPE tokenizer when the models carry one, else
    the hash placeholder."""
    if models.tokenizer is not None:
        return models.tokenizer(texts, max_len=max_len)
    return simple_tokenize(texts, max_len)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


EPS_GRAPHS = 4  # ε graphs a pipeline keeps: the inversion's B = 1, inpainting's CFG B = 2, two spare


def eps_graphed(device: torch.device, processor) -> bool:
    """Whether an ε evaluation on ``device`` with ``processor`` replays a
    CUDA graph: only without a processor (one built per chunk may hold
    per-chunk geometry) and on the card."""
    return processor is None and device.type == "cuda"


def eps_graph_key(latents, t, ctx, hint, cond_scale: float) -> tuple:
    """What an ε graph is captured for: the device, the shape and dtype of
    each input, the ControlNet's scale (baked into the graph), and the TF32
    switches that choose the float32 convolutions and products."""
    return (latents.device, *((tuple(x.shape), x.dtype) for x in (latents, t, ctx, hint)), float(cond_scale),
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@dataclasses.dataclass
class EpsGraph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # the static latents, t, ctx and hint the graph reads
    output: torch.Tensor  # the static NHWC ε it writes
    launches: int  # B3 launches in the graph
    copies: int  # inputs B3's wrapper copied in it
    norm_launches: int  # N1 launches in it
    counts: dict  # the tracer's counts its capture made (the norms' paths), which each replay counts again


class GraphCache:
    """At most ``size`` graphs by key, the least recently used dropped
    first, all in one memory pool. ``params`` fingerprints the parameters
    the graphs read: when a lookup brings another, every graph is dropped."""

    def __init__(self, size: int):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.params = None
        self.pool = None  # torch.cuda.graph_pool_handle(), taken at the first capture

    def get(self, key, params):
        if params != self.params:
            self.entries.clear()
            self.params, self.pool = params, None
            return None
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        if len(self.entries) > self.size:
            self.entries.popitem(last=False)


class SDControlNetPipeline:
    """Deterministic DDIM inversion + CFG generation with ControlNet hints."""

    def __init__(self, models: SDModels, sched_cfg: SchedulerConfig = SchedulerConfig()):
        self.m = models
        self.scheduler = DDIMScheduler(sched_cfg)
        self.inverse_scheduler = DDIMInverseScheduler(sched_cfg)
        self.graphs = GraphCache(EPS_GRAPHS)
        self._params = (None, None, [])  # the UNet, the ControlNet and their parameters
        # the layout the UNet and the ControlNet run in: where they live decides
        self.layout = torch.contiguous_format
        if models is not None and models.device.type == "cuda":
            to_channels_last(models.unet)
            to_channels_last(models.controlnet)
            self.layout = torch.channels_last

    def param_ptrs(self) -> tuple:
        """The models and the storage of each of their parameters: what the
        graphs read. A parameter moved or cast (``p.data = ...``, ``.to``)
        or a model replaced changes it; weights copied in place
        (``load_state_dict``) do not, and the graphs read them as they are."""
        unet, cn = self.m.unet, self.m.controlnet
        if self._params[0] is not unet or self._params[1] is not cn:
            self._params = (unet, cn, [*unet.parameters(), *cn.parameters()])
        return (id(unet), id(cn), *(p.data_ptr() for p in self._params[2]))

    @torch.no_grad()
    def _eps(self, latents, t, ctx, hint, cond_scale, processor=None) -> torch.Tensor:
        """ε of the UNet with the ControlNet's residuals, NHWC in and out:
        replayed from the graph of the inputs' signature where
        ``eps_graphed``, captured at the signature's first call; else eager.
        A replay returns a copy of the graph's output, so ε outlives the
        next call."""
        with trace.span("sd.eps", device=latents.device):
            if not eps_graphed(latents.device, processor):
                trace.count("sd.eps.eager")
                return self._eps_eager(latents, t, ctx, hint, cond_scale, processor)
            key = eps_graph_key(latents, t, ctx, hint, cond_scale)
            g = self.graphs.get(key, self.param_ptrs())
            if g is None:
                trace.count("sd.eps.graph_capture")
                return self._capture(key, latents, t, ctx, hint, cond_scale)
            trace.count("sd.eps.graph_replay")
            for buf, x in zip(g.inputs, (latents, t, ctx, hint)):
                buf.copy_(x)
            g.graph.replay()
            attention_cuda.launches += g.launches
            attention_cuda.copies += g.copies
            groupnorm_cuda.launches += g.norm_launches
            for name, n in g.counts.items():
                trace.count(name, n)
            return g.output.clone()

    def _eps_eager(self, latents, t, ctx, hint, cond_scale, processor=None) -> torch.Tensor:
        # NHWC → (B, C, H, W): a view on the card (channels-last), a copy on the CPU
        lat, hint_c = (x.permute(0, 3, 1, 2).contiguous(memory_format=self.layout) for x in (latents, hint))
        with trace.span("sd.controlnet"):
            down_res, mid_res = self.m.controlnet(lat, t, ctx, hint_c, cond_scale, processor=processor)
        with trace.span("sd.unet"):
            eps = self.m.unet(lat, t, ctx, processor=processor, controlnet_residuals=(down_res, mid_res))
        return _nhwc(eps)

    def _capture(self, key, latents, t, ctx, hint, cond_scale) -> torch.Tensor:
        """Warm up on a side stream (B3's library loaded, its kernel
        attributes and every library's plans and workspaces set), capture
        the evaluation of static copies of the inputs into the graphs'
        pool, and return the warm-up's ε: B3's and N1's counters count only
        the warm-up's launches, as an eager call's, and the tracer only its
        counts."""
        dev = latents.device
        inputs = tuple(x.clone(memory_format=torch.contiguous_format) for x in (latents, t, ctx, hint))
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            eps = self._eps_eager(*inputs, cond_scale)
            if self.graphs.pool is None:
                self.graphs.pool = torch.cuda.graph_pool_handle()
            launches, copies, norms = attention_cuda.launches, attention_cuda.copies, groupnorm_cuda.launches
            graph = torch.cuda.CUDAGraph()
            # thread_local: the viewer's thread may render (allocate, copy to
            # the host) while this one captures; "global" would fail its calls.
            # No thread may draw from the default CUDA generator meanwhile:
            # the capture takes it over (the viewer draws nothing)
            with trace.tally() as counts, torch.cuda.graph(graph, pool=self.graphs.pool, stream=side,
                                                           capture_error_mode="thread_local"):
                out = self._eps_eager(*inputs, cond_scale)
            captured = (attention_cuda.launches - launches, attention_cuda.copies - copies,
                        groupnorm_cuda.launches - norms)
            attention_cuda.launches, attention_cuda.copies, groupnorm_cuda.launches = launches, copies, norms
        main.wait_stream(side)
        self.graphs.put(key, EpsGraph(graph, inputs, out, *captured, counts))
        return eps

    @torch.no_grad()
    def image_to_latent(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → scaled latents (B, H/8, W/8, 4)."""
        with trace.span("sd.encode", device=images.device):
            x = images.float() * 2.0 - 1.0
            return _nhwc(self.m.vae.encode(_nchw(x), generator))

    @torch.no_grad()
    def latent_to_image(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 4) latents → (B, 8h, 8w, 3) images in [0, 1], in the
        models' type."""
        with trace.span("sd.decode", device=latents.device):
            x = self.m.vae.decode(_nchw(latents))
            return _nhwc(torch.clamp(x * 0.5 + 0.5, 0.0, 1.0))

    @torch.no_grad()
    def invert(self, latents, ctx, hint, num_steps: int = 20, cond_scale: float = 1.0,
               processor=None) -> torch.Tensor:
        """DDIM inversion at guidance 0; float32 carry."""
        ts = self.inverse_scheduler.set_timesteps(num_steps)
        with trace.span("sd.invert"):
            lat = latents.float()
            for t in ts:
                tt = torch.full((lat.shape[0],), int(t), dtype=torch.long, device=lat.device)
                eps = self._eps(lat, tt, ctx, hint, cond_scale, processor)
                lat = self.inverse_scheduler.step(eps, int(t), lat)
            return lat

    @torch.no_grad()
    def generate(self, latents, ctx_cond, ctx_uncond, hint, guidance_scale: float,
                 num_steps: int = 20, cond_scale: float = 1.0, processor=None) -> torch.Tensor:
        """Batched CFG: the two halves [uncond; cond] go through the models
        together (the doubled batch the cross-view processor's
        ``unet_chunk_size=2`` accounts for); float32 carry."""
        ts = self.scheduler.set_timesteps(num_steps)
        with trace.span("sd.generate"):
            lat = latents.float()
            B = lat.shape[0]
            ctx2 = torch.cat([ctx_uncond, ctx_cond], dim=0)
            hint2 = torch.cat([hint, hint], dim=0)
            for t in ts:
                tt = torch.full((2 * B,), int(t), dtype=torch.long, device=lat.device)
                eps2 = self._eps(torch.cat([lat, lat], dim=0), tt, ctx2, hint2, cond_scale, processor)
                eps_u, eps_c = eps2.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                lat = self.scheduler.step(eps, int(t), lat)
            return lat
