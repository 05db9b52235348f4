"""PyTorch port vs the JAX package: latent-blending inpainting
(``diffusion/inpaint.py``), mirroring tests/test_inpaint.py.

The JAX package's tiny SD stack (``tests/torch_sd_tiny.py``) in both
packages; the JAX run draws its noise and starting latents from its key,
and the port is handed the same draws. Stated tolerances, float32: the
latent mask ≤ 1e-6 absolute (the same resize weights, summed in another
order); inpainted latents ≤ 1e-5 relative L2 (a 2- or 3-step CFG loop
through the UNet and the ControlNet); the keep region exact to 1e-5 and
the pixel composite to 1e-6, as in the JAX test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.diffusion import inpaint as jip
from gaussctrl_exp_tpu.diffusion.sd_pipeline import SDControlNetPipeline as JPipeline
from gaussctrl_exp_tpu_torch.diffusion import inpaint as ip
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import jax_tiny, port_tiny, rel_l2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5


@pytest.fixture(scope="module")
def pipes():
    jm = jax_tiny(0)
    return JPipeline(jm), SDControlNetPipeline(port_tiny(jm))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_draws(jpipe, key, orig, num_steps):
    """The noise and starting latents ``inpaint_latents`` draws from ``key``."""
    noise_key, lat_key = jax.random.split(key)
    noise = jax.random.normal(noise_key, orig.shape, orig.dtype)
    ts = jpipe.scheduler.set_timesteps(num_steps)
    init = jpipe.scheduler.add_noise(orig, jax.random.normal(lat_key, orig.shape), int(ts[0]))
    return np.asarray(noise), np.asarray(init)


@pytest.mark.parametrize("blur", [0, 2])
def test_mask_to_latent_matches_jax(blur):
    m = np.zeros((64, 64), np.float32)
    m[16:48, 16:48] = 1.0
    got = ip.mask_to_latent(m, 8, blur)
    assert got.shape == (8, 8, 1) and float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(jip.mask_to_latent(m, 8, blur)), atol=1e-6, rtol=0)
    if blur == 0:
        assert float(got[4, 4, 0]) > 0.9 and float(got[0, 0, 0]) < 0.1
    else:  # the blur spreads mass across the edge
        assert float((got - ip.mask_to_latent(m, 8)).abs().max()) > 0.01


def test_keep_region_preserved_and_matches_jax(pipes):
    jpipe, tpipe = pipes
    cfg = dict(num_steps=3, guidance_scale=2.0)
    rng = np.random.default_rng(0)
    orig = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    mask = np.zeros((8, 8, 1), np.float32)
    mask[2:6, 2:6] = 1.0
    ctx = rng.normal(size=(1, 77, 32)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = jip.SDInpaintPipeline(jpipe, jip.InpaintConfig(**cfg)).inpaint_latents(
        key, jnp.asarray(orig), jnp.asarray(mask), jnp.asarray(ctx), jnp.zeros_like(ctx))
    noise, init = _jax_draws(jpipe, key, jnp.asarray(orig), 3)
    got = ip.SDInpaintPipeline(tpipe, ip.InpaintConfig(**cfg)).inpaint_latents(
        None, _t(orig), _t(mask), _t(ctx), torch.zeros(1, 77, 32), init_latents=_t(init), noise=_t(noise))
    assert got.shape == orig.shape and bool(torch.isfinite(got).all())
    assert rel_l2(got, want) <= REL
    keep = np.broadcast_to(mask < 0.5, orig.shape)
    np.testing.assert_allclose(got.numpy()[keep], orig[keep], atol=1e-5)
    assert np.abs(got.numpy() - orig)[~keep].mean() > 1e-3  # the edit region was regenerated


def test_controlnet_hint_path_matches_jax(pipes):
    jpipe, tpipe = pipes
    cfg = dict(num_steps=2, guidance_scale=1.5)
    rng = np.random.default_rng(1)
    orig = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, 32)).astype(np.float32)
    hint = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = np.ones((8, 8, 1), np.float32)
    key = jax.random.PRNGKey(2)
    want = jip.SDInpaintPipeline(jpipe, jip.InpaintConfig(**cfg)).inpaint_latents(
        key, jnp.asarray(orig), jnp.asarray(mask), jnp.asarray(ctx), jnp.zeros_like(ctx), hint=jnp.asarray(hint))
    noise, init = _jax_draws(jpipe, key, jnp.asarray(orig), 2)
    got = ip.SDInpaintPipeline(tpipe, ip.InpaintConfig(**cfg)).inpaint_latents(
        None, _t(orig), _t(mask), _t(ctx), torch.zeros(1, 77, 32), hint=_t(hint), init_latents=_t(init),
        noise=_t(noise))
    assert got.shape == orig.shape and rel_l2(got, want) <= REL


def test_pixel_composite_outside_mask(pipes):
    _, tpipe = pipes
    rng = np.random.default_rng(2)
    img = _t(rng.uniform(0, 1, (1, 64, 64, 3)))
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    ctx = _t(rng.normal(size=(1, 77, 32)))
    out = ip.SDInpaintPipeline(tpipe, ip.InpaintConfig(num_steps=2, guidance_scale=1.5)).inpaint_images(
        torch.Generator().manual_seed(3), img, mask, ctx, torch.zeros_like(ctx))
    assert out.shape == img.shape and bool(torch.isfinite(out).all())
    outside = torch.as_tensor(mask < 0.5)
    torch.testing.assert_close(out[0][outside], img[0][outside], atol=1e-6, rtol=0)
    assert float((out[0][~outside] - img[0][~outside]).abs().mean()) > 1e-3
