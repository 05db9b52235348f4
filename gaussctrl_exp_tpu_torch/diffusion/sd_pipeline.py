"""StableDiffusion-ControlNet pipeline: prompt encoding, DDIM inversion and
classifier-free-guided generation.

Port of ``gaussctrl_exp_tpu/diffusion/sd_pipeline.py``. The JAX package's
``lax.scan`` loops are Python loops; the scheduler carry stays float32
whatever the models' type. The public functions keep the JAX package's
NHWC shapes (images (B, H, W, 3), latents (B, h, w, 4)); the models run NCHW
inside. Every method runs without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..utils import trace
from .controlnet import ControlNet
from .layers import cast_keeping_norms
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


class SDControlNetPipeline:
    """Deterministic DDIM inversion + CFG generation with ControlNet hints."""

    def __init__(self, models: SDModels, sched_cfg: SchedulerConfig = SchedulerConfig()):
        self.m = models
        self.scheduler = DDIMScheduler(sched_cfg)
        self.inverse_scheduler = DDIMInverseScheduler(sched_cfg)

    @torch.no_grad()
    def _eps(self, latents, t, ctx, hint, cond_scale, processor=None) -> torch.Tensor:
        """ε of the UNet with the ControlNet's residuals, NHWC in and out."""
        with trace.span("sd.eps", device=latents.device):
            lat, hint_c = _nchw(latents), _nchw(hint)
            with trace.span("sd.controlnet"):
                down_res, mid_res = self.m.controlnet(lat, t, ctx, hint_c, cond_scale, processor=processor)
            with trace.span("sd.unet"):
                eps = self.m.unet(lat, t, ctx, processor=processor, controlnet_residuals=(down_res, mid_res))
            return _nhwc(eps)

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
