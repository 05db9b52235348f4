"""Text-driven inpainting by latent blending.

Port of ``gaussctrl_exp_tpu/diffusion/inpaint.py``. Masked regeneration
needs no 9-channel inpaint UNet: at every DDIM step the region outside the
mask is re-anchored to the original latent noised to the next step's level,

    x_t ← m ⊙ x_t + (1 − m) ⊙ add_noise(x_orig, t),

so any SD1.x stack (the ControlNet-conditioned one of ``sd_pipeline.py``)
inpaints; with a depth hint it is the reference's ControlNet-inpaint
experiment, without one its plain SD-inpaint one. Masks follow the edit
pipeline's convention (1 = regenerate). ``jax.random`` keys become an
explicit ``torch.Generator``; the noise and the starting latents may also
be given, so that a test can feed both packages the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .geometry import resize_bilinear
from .sd_pipeline import SDControlNetPipeline


@dataclasses.dataclass(frozen=True)
class InpaintConfig:
    guidance_scale: float = 7.5
    num_steps: int = 20
    cond_scale: float = 1.0  # ControlNet strength (0 disables the hint path)
    mask_blur: int = 0  # latent-grid blur taps for soft seams


def mask_to_latent(mask, latent_hw: int, blur: int = 0) -> torch.Tensor:
    """(H, W) {0, 1} edit mask → (latent_hw, latent_hw, 1) float latent mask
    on the CPU (antialiased bilinear resize, then ``blur`` 5-tap passes)."""
    m = np.asarray(mask, np.float32)
    m = resize_bilinear(torch.as_tensor(m.reshape(m.shape[0], m.shape[1])), latent_hw, latent_hw)
    for _ in range(blur):
        m = (m + torch.roll(m, 1, 0) + torch.roll(m, -1, 0) + torch.roll(m, 1, 1) + torch.roll(m, -1, 1)) / 5.0
    return torch.clamp(m, 0.0, 1.0)[..., None]


class SDInpaintPipeline:
    """Masked regeneration on top of the SD (+ ControlNet) stack."""

    def __init__(self, pipe: SDControlNetPipeline, cfg: InpaintConfig = InpaintConfig()):
        self.pipe = pipe
        self.cfg = cfg

    @torch.no_grad()
    def inpaint_latents(
        self,
        generator: Optional[torch.Generator],
        orig_latents: torch.Tensor,  # (B, h, w, 4) VAE-encoded originals
        mask_lat: torch.Tensor,  # (h, w, 1) or (B, h, w, 1); 1 = regenerate
        ctx_cond: torch.Tensor,
        ctx_uncond: torch.Tensor,
        hint: Optional[torch.Tensor] = None,  # (B, H, W, 3) ControlNet hint
        init_latents: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """DDIM sampling with per-step out-of-mask re-anchoring; float32
        carry. ``noise`` (the re-anchoring noise) and ``init_latents`` are
        drawn from ``generator`` where not given."""
        cfg, p = self.cfg, self.pipe
        orig = orig_latents.float()
        B, dev = orig.shape[0], orig.device
        mask = mask_lat.to(dev, torch.float32)
        if mask.dim() == 3:
            mask = mask[None].expand(B, -1, -1, -1)
        ts = p.scheduler.set_timesteps(cfg.num_steps)

        def draw():
            return torch.randn(orig.shape, generator=generator, device=generator.device).to(dev)

        noise = draw() if noise is None else noise.to(dev, torch.float32)
        lat = p.scheduler.add_noise(orig, draw(), int(ts[0])) if init_latents is None else init_latents.to(dev).float()
        if hint is None:
            h, w = orig.shape[1] * 8, orig.shape[2] * 8
            hint, cond_scale = torch.zeros((B, h, w, 3), device=dev), 0.0
        else:
            cond_scale = cfg.cond_scale
        ctx2 = torch.cat([ctx_uncond, ctx_cond], dim=0)
        hint2 = torch.cat([hint, hint], dim=0)
        step = p.scheduler.cfg.num_train_timesteps // cfg.num_steps
        for t in ts:
            tt = torch.full((2 * B,), int(t), dtype=torch.long, device=dev)
            eps_u, eps_c = p._eps(torch.cat([lat, lat], dim=0), tt, ctx2, hint2, cond_scale).chunk(2, dim=0)
            lat = p.scheduler.step(eps_u + cfg.guidance_scale * (eps_c - eps_u), int(t), lat)
            # re-anchor the keep region at the next step's noise level
            t_prev = int(t) - step
            anchored = p.scheduler.add_noise(orig, noise, t_prev) if t_prev >= 0 else orig
            lat = mask * lat + (1.0 - mask) * anchored
        return lat

    @torch.no_grad()
    def inpaint_images(
        self,
        generator: torch.Generator,
        images: torch.Tensor,  # (B, H, W, 3) in [0, 1]
        mask,  # (H, W) 1 = regenerate
        ctx_cond: torch.Tensor,
        ctx_uncond: torch.Tensor,
        hint: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Image → image: encode (a VAE sample drawn with ``generator``),
        masked regeneration, decode, and the untouched region composited back
        exactly, as the edit pipeline's mask write-back."""
        lat0 = self.pipe.image_to_latent(images, generator)
        mlat = mask_to_latent(mask, lat0.shape[1], self.cfg.mask_blur)
        lat = self.inpaint_latents(generator, lat0, mlat, ctx_cond, ctx_uncond, hint)
        out = self.pipe.latent_to_image(lat).float()
        mpix = torch.as_tensor(np.asarray(mask, np.float32), device=images.device)[None, :, :, None]
        return mpix * out + (1.0 - mpix) * images.float()
