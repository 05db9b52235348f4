"""Depth-conditioned multi-view latent generator: sampling and training.

Port of ``gaussctrl_exp_tpu/diffusion/mv_generator.py``, the rebuild of the
reference's MVDiffusion-style experiment:

  * the inverse-normalised depth enters as a fifth latent channel
    (``inverse_depth_latent``; the UNet's ``conv_in`` takes 4 + 1 channels,
    everything else is the SD1.x UNet of ``unet.py``);
  * one multi-resolution epipolar processor (``correspondence.py``) holds a
    (V, V, S, 9) neighbour table per attention resolution and an overlap
    pair mask (``prepare``);
  * sampling runs the CFG-doubled [uncond; cond] batch, group-major, as the
    rest of the package's ``unet_chunk_size = 2`` convention;
  * the training step is the ε-prediction MSE at a random timestep, its
    gradient taken by autograd through the UNet: on the card every
    self- and cross-attention's backward runs kernels B4 and B5
    (``ops/attention_cuda.FlashAttnFunction``), as the JAX package's
    ``jax.value_and_grad`` runs the library TPU flash attention's backward.
    ``init_depth_generator(dtype=torch.bfloat16)`` trains with float32
    parameters and a bf16 UNet, as Flax's ``dtype``: that step runs B3, B4
    and B5 in bf16.

Public shapes are the JAX package's NHWC: latents (B, L, L, 4), depth
latents (V, L, L, 1); the UNet runs NCHW inside. ``jax.random`` has no
counterpart: ``train_step`` draws the timesteps and the noise from an
explicit ``torch.Generator``, and ``train_step_at`` takes them as given.

Spans (``utils/trace.py``): ``mvgen.sample`` (device) holds
``mvgen.prepare``, which holds ``mvgen.depth_to_host`` (sync: the depths
copied to the host) and ``mvgen.tables`` (device, and sync: the tables at
each resolution, the overlap ratio, the pair mask read on the host and the
depth latents), then per step ``mvgen.eps`` (device: the CFG-doubled UNet
call) and ``mvgen.step`` (the guidance and the scheduler's update). Counters
``mvgen.steps`` and ``mvgen.views``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..cameras import Camera
from ..device import resolve_device
from ..utils import trace
from .correspondence import build_correspondence_tables, make_multires_epipolar_processor, overlap_ratio
from .geometry import resize_bilinear
from .schedulers import DDIMScheduler, SchedulerConfig
from .sd_pipeline import _nchw, _nhwc, _random_module
from .unet import UNet2DCondition


@dataclasses.dataclass(frozen=True)
class MVGeneratorConfig:
    latent_size: int = 64  # latent grid (512² images / VAE 8×)
    depth_sigma: float = 0.1  # epipolar depth-consistency bandwidth
    mix: float = 0.5  # self vs cross-view attention mix
    overlap_thresh: float = 0.05  # per-tap validity threshold
    min_overlap: float = 0.2  # pair mask cutoff
    guidance_scale: float = 7.5
    num_steps: int = 50
    sched: SchedulerConfig = SchedulerConfig()


def _depth2d(depth) -> np.ndarray:
    """(H, W) or the renderer's (H, W, 1) depth map as float32 numpy."""
    d = depth.detach().float().cpu().numpy() if torch.is_tensor(depth) else np.asarray(depth, np.float32)
    return d.reshape(d.shape[0], d.shape[1]).astype(np.float32)


def inverse_depth_latent(depth, latent_hw: int) -> torch.Tensor:
    """(H, W) metric depth → (latent_hw, latent_hw, 1) inverse-normalised,
    on the CPU: 1/(d + ε) over its maximum, resized as
    ``jax.image.resize(..., "bilinear")`` (antialiased)."""
    disp = 1.0 / (_depth2d(depth) + 1e-5)
    disp = disp / max(float(disp.max()), 1e-8)
    return resize_bilinear(torch.as_tensor(disp), latent_hw, latent_hw)[..., None]


class DepthGenerator:
    """Multi-view, depth-conditioned latent generator around a UNet with
    ``in_channels = 4 + 1`` (``init_depth_generator`` builds one)."""

    def __init__(self, unet: UNet2DCondition, cfg: MVGeneratorConfig = MVGeneratorConfig()):
        self.unet = unet
        self.cfg = cfg
        self.scheduler = DDIMScheduler(cfg.sched)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # --- geometry preparation (host-side, once per view set) --------------
    def attention_resolutions(self) -> list[int]:
        """Feature grid sizes at which the UNet has self-attention layers."""
        L = self.cfg.latent_size
        sizes = []
        for i in range(len(self.unet.block_out)):
            s = L // (1 << i)
            if s >= 2 and s not in sizes:
                sizes.append(s)
        return sizes

    def prepare(self, depths: Sequence, cameras: Sequence[Camera]):
        """→ (processor, depth_latents (V, L, L, 1) on the model's device,
        pair_mask (V, V) float32 numpy). Builds the per-resolution epipolar
        tables (the finest decides the overlap) and the pair mask the
        processor consults."""
        cfg, dev = self.cfg, self.device
        with trace.span("mvgen.prepare", unit=len(depths)):
            with trace.span("mvgen.depth_to_host", sync=True):
                d2 = [_depth2d(d) for d in depths]
            with trace.span("mvgen.tables", device=dev, sync=True):
                dt = [torch.as_tensor(d, device=dev) for d in d2]
                tables, base_w = {}, None
                for s in self.attention_resolutions():
                    idx, w = build_correspondence_tables(dt, list(cameras), s, cfg.depth_sigma)
                    tables[s * s] = (idx, w)
                    if base_w is None:
                        base_w = w
                pair_mask = (overlap_ratio(base_w, cfg.overlap_thresh) >= cfg.min_overlap).float().cpu().numpy()
                processor = make_multires_epipolar_processor(tables, mix=cfg.mix, pair_mask=pair_mask,
                                                             unet_chunk_size=2)
                depth_lat = torch.stack([inverse_depth_latent(d, cfg.latent_size) for d in d2]).to(dev)
        return processor, depth_lat, pair_mask

    # --- model evaluation --------------------------------------------------
    def _eps(self, latents, depth_lat, t, ctx, processor) -> torch.Tensor:
        """ε of the UNet on [latents, depth] (B, L, L, 5), NHWC in and out."""
        x = torch.cat([latents, depth_lat.to(latents.dtype)], dim=-1)
        return _nhwc(self.unet(_nchw(x), t, ctx, processor=processor))

    # --- sampling ------------------------------------------------------------
    @torch.no_grad()
    def sample(
        self,
        ctx_cond: torch.Tensor,  # (V, 77, cross_dim)
        ctx_uncond: torch.Tensor,  # (V, 77, cross_dim)
        depths: Sequence,
        cameras: Sequence[Camera],
        init_latents: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Generate V mutually consistent latents (V, L, L, 4) conditioned on
        depth, from ``init_latents`` or from noise drawn with ``generator``.
        Each denoising step runs the doubled [uncond group; cond group] batch
        so that the cross-view processor sees both groups with the same view
        layout; the carry is float32."""
        cfg, dev = self.cfg, self.device
        V, L = len(depths), cfg.latent_size
        with trace.span("mvgen.sample", unit=V, device=dev):
            processor, depth_lat, _ = self.prepare(depths, cameras)
            ts = self.scheduler.set_timesteps(cfg.num_steps)
            if init_latents is not None:
                lat = init_latents.to(dev, torch.float32)
            else:
                lat = torch.randn((V, L, L, 4), generator=generator, device=dev)
            ctx2 = torch.cat([ctx_uncond, ctx_cond], dim=0)
            dl2 = torch.cat([depth_lat, depth_lat], dim=0)
            for t in ts:
                tt = torch.full((2 * V,), int(t), dtype=torch.long, device=dev)
                with trace.span("mvgen.eps", unit=int(t), device=dev):
                    eps_u, eps_c = self._eps(torch.cat([lat, lat], dim=0), dl2, tt, ctx2, processor).chunk(2, dim=0)
                with trace.span("mvgen.step", unit=int(t)):
                    lat = self.scheduler.step(eps_u + cfg.guidance_scale * (eps_c - eps_u), int(t), lat)
                trace.count("mvgen.steps")
        trace.count("mvgen.views", V)
        return lat

    # --- training ------------------------------------------------------------
    def loss(self, x0, depth_lat, ctx, t, noise, processor=None) -> torch.Tensor:
        """ε-MSE at timesteps ``t`` (B,) with ``noise`` like ``x0`` (B, L, L,
        4): noise the clean latents, predict ε with the depth channel and
        the cross-view processor, mean squared error, with autograd."""
        a = torch.as_tensor(self.scheduler.alphas_cumprod, device=x0.device)[t][:, None, None, None]
        noisy = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise
        pred = self._eps(noisy, depth_lat, t, ctx, processor)
        return torch.mean((pred.float() - noise) ** 2)

    def train_step_at(self, optimizer: torch.optim.Optimizer, x0, depth_lat, ctx, t, noise,
                      processor=None) -> torch.Tensor:
        """One optimizer step on the loss at the given timesteps and noise;
        returns the loss (detached)."""
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss(x0, depth_lat, ctx, t, noise, processor)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def make_train_step(self, optimizer: torch.optim.Optimizer, processor=None):
        """→ ``train_step(x0, depth_lat, ctx, generator) → loss``: draws the
        timesteps (uniform in [0, T)) and the noise from ``generator``, then
        ``train_step_at``. ``torch.optim.Adam`` has ``optax.adam``'s step
        (ε outside the square root, bias correction from step 1)."""
        T = self.cfg.sched.num_train_timesteps

        def train_step(x0, depth_lat, ctx, generator: torch.Generator) -> torch.Tensor:
            B = x0.shape[0]
            t = torch.randint(0, T, (B,), generator=generator, device=generator.device).to(x0.device)
            noise = torch.randn(x0.shape, generator=generator, device=generator.device).to(x0)
            return self.train_step_at(optimizer, x0, depth_lat, ctx, t, noise, processor)

        return train_step


def init_depth_generator(
    seed: int = 0,
    latent: int = 64,
    block_out=None,
    heads: int = None,
    cross_dim: int = None,
    layers_per_block: int = None,
    cfg: Optional[MVGeneratorConfig] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> DepthGenerator:
    """Random-weight DepthGenerator (5-channel ``conv_in``) with Flax's
    initialisers, drawn from a generator seeded with ``seed``; SD1.x widths
    by default, tiny ones for tests. Its parameters are float32 and require
    grad; the UNet computes in ``dtype``, as the JAX package's
    ``init_depth_generator(dtype=...)`` builds it with Flax's ``dtype``
    (``param_dtype`` float32): with bf16 every weight is cast at its use,
    its gradient reaches the float32 parameter through the cast, and an
    optimizer over ``unet.parameters()`` keeps float32 state."""
    from .unet import BLOCK_OUT, CROSS_DIM, HEADS, LAYERS_PER_BLOCK

    device = resolve_device(device)
    block_out = tuple(block_out or BLOCK_OUT)
    kw = dict(in_channels=5, block_out=block_out, layers_per_block=layers_per_block or LAYERS_PER_BLOCK,
              heads=heads or HEADS, cross_dim=cross_dim or CROSS_DIM, temb_dim=block_out[-1], compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    unet = _random_module(lambda: UNet2DCondition(**kw), device, gen).requires_grad_(True)
    return DepthGenerator(unet, cfg or MVGeneratorConfig(latent_size=latent))
