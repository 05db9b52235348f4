"""PyTorch port vs the JAX package: schedulers, UNet, ControlNet, VAE, the
denoise loops, and checkpoint loading.

The JAX package's tiny stack (``TINY`` of tests/test_diffusion.py) runs on
the CPU, where its attention takes the math path; the port's modules carry
its weights through ``diffusion/params.py``. Inputs come from numpy seeds;
everything is float32, with torch on one thread. Tolerances, relative L2:
1e-6 for the scheduler arithmetic (the same float32 operations; measured
0), 1e-5 for each module (the same math, sums in another order; measured
1.3e-7 to 2.5e-6, the largest the timestep embedding's sines of large
arguments), 1e-4 for the 2-step loops (measured 6.4e-7 inversion, 2.5e-6
generation). Flax's GroupNorm takes the variance as
E[x²] − E[x]², torch's as E[(x − E[x])²]; that moves the last digits only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gaussctrl_exp_tpu.diffusion import convert as jconvert
from gaussctrl_exp_tpu.diffusion import schedulers as jsch
from gaussctrl_exp_tpu.diffusion import unet as junet
from gaussctrl_exp_tpu.diffusion.attention import make_cross_view_processor as jcross_view
from gaussctrl_exp_tpu.diffusion.sd_pipeline import SDControlNetPipeline as JPipeline
from gaussctrl_exp_tpu.diffusion.vae import AutoencoderKL as JAutoencoderKL
from gaussctrl_exp_tpu_torch.diffusion import convert, keysets
from gaussctrl_exp_tpu_torch.diffusion import params as P
from gaussctrl_exp_tpu_torch.diffusion import schedulers as tsch
from gaussctrl_exp_tpu_torch.diffusion import unet as tunet
from gaussctrl_exp_tpu_torch.diffusion.attention import make_cross_view_processor
from gaussctrl_exp_tpu_torch.diffusion.controlnet import ControlNet
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, init_random_models
from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
from gaussctrl_exp_tpu_torch.diffusion.vae import AutoencoderKL
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY, jax_tiny, load, port_tiny, rel_l2, to_t, toy_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_SCHED = 1e-6
REL = 1e-5
REL_LOOP = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny(0)
    return jm, port_tiny(jm)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _nchw(a):
    return to_t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- schedulers


@pytest.mark.parametrize("steps", [20, 10, 2])
def test_scheduler_timesteps_match_jax(steps):
    np.testing.assert_array_equal(tsch.DDIMScheduler().set_timesteps(steps),
                                  jsch.DDIMScheduler().set_timesteps(steps))
    np.testing.assert_array_equal(tsch.DDIMInverseScheduler().set_timesteps(steps),
                                  jsch.DDIMInverseScheduler().set_timesteps(steps))
    np.testing.assert_array_equal(tsch.DDIMScheduler().alphas_cumprod,
                                  np.asarray(jsch.DDIMScheduler().alphas_cumprod))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("i", [0, 7, 19])
def test_scheduler_step_matches_jax(inverse, i):
    """A bf16 ε (as a bf16 model gives it) against a float32 sample; t = 1
    is the boundary (the final alpha, or 1 for the inverse)."""
    jcls, tcls = (jsch.DDIMInverseScheduler, tsch.DDIMInverseScheduler) if inverse else \
        (jsch.DDIMScheduler, tsch.DDIMScheduler)
    js, ts = jcls(), tcls()
    t = int(js.set_timesteps(20)[i])
    ts.set_timesteps(20)
    sample, eps = _normal((2, 8, 8, 4), i), _normal((2, 8, 8, 4), 100 + i)
    want = np.asarray(js.step(jnp.asarray(eps, jnp.bfloat16), t, jnp.asarray(sample)))
    got = ts.step(to_t(eps).to(torch.bfloat16), t, to_t(sample))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel_l2(got, want) <= REL_SCHED
    if not inverse:
        noisy = np.asarray(js.add_noise(jnp.asarray(sample), jnp.asarray(eps), t))
        assert rel_l2(ts.add_noise(to_t(sample), to_t(eps), t), noisy) <= REL_SCHED


# ---------------------------------------------------------------- UNet parts


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 51, 500, 951], np.int32)
    want = np.asarray(junet.timestep_embedding(jnp.asarray(t), 320))
    assert rel_l2(tunet.timestep_embedding(torch.as_tensor(t), 320), want) <= REL


def _flax(module, *args, seed=0, **kw):
    params = module.init(jax.random.PRNGKey(seed), *args, **kw)["params"]
    return params, np.asarray(module.apply({"params": params}, *args, **kw))


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 64)])
def test_resnet_block_matches_jax(cin, cout):
    x, temb = _normal((2, 6, 6, cin), 1, 2.0), _normal((2, 64), 2)
    params, want = _flax(junet.ResnetBlock(cout), jnp.asarray(x), jnp.asarray(temb))
    tmod = load(tunet.ResnetBlock(cin, cout, 64), P.state_dict_from_flax(params))
    assert rel_l2(_nhwc(tmod(_nchw(x), to_t(temb))), want) <= REL


def test_down_and_upsample_match_jax():
    x = _normal((2, 7, 6, 32), 3)
    params, want = _flax(junet.Downsample(32), jnp.asarray(x))
    tmod = load(tunet.Downsample(32), P.state_dict_from_flax(params))
    assert rel_l2(_nhwc(tmod(_nchw(x))), want) <= REL
    params, want = _flax(junet.Upsample(32), jnp.asarray(x))
    tmod = load(tunet.Upsample(32), P.state_dict_from_flax(params))
    assert rel_l2(_nhwc(tmod(_nchw(x))), want) <= REL
    # nearest 2×: jax.image.resize repeats every pixel, as F.interpolate does
    near = np.asarray(jax.image.resize(jnp.asarray(x), (2, 14, 12, 32), "nearest"))
    np.testing.assert_array_equal(_nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest")).numpy(), near)


def _cn_params_nonzero(jm, seed=7):
    """The tiny ControlNet's parameters with its zero-initialised convs set
    to random values, so that the residual path carries signal."""
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.controlnet_params))
    rng = np.random.default_rng(seed)
    for name, sub in tree.items():
        if name.startswith("controlnet_down_blocks_") or name == "controlnet_mid_block":
            sub["kernel"] = (rng.normal(size=sub["kernel"].shape) * 0.3).astype(np.float32)
            sub["bias"] = (rng.normal(size=sub["bias"].shape) * 0.1).astype(np.float32)
    conv_out = tree["controlnet_cond_embedding"]["conv_out"]
    conv_out["kernel"] = (rng.normal(size=conv_out["kernel"].shape) * 0.05).astype(np.float32)
    return tree


def _cn_inputs(seed=8):
    return (_normal((2, 8, 8, 4), seed), np.array([1, 501], np.int32), _normal((2, 77, 32), seed + 1),
            np.random.default_rng(seed + 2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))


def test_controlnet_matches_jax(tiny):
    jm, _ = tiny
    tree = _cn_params_nonzero(jm)
    x, t, ctx, hint = _cn_inputs()
    down_j, mid_j = jm.controlnet.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                        jnp.asarray(hint), 0.8)
    kw = dict(block_out=TINY["block_out"], layers_per_block=1, heads=2, cross_dim=32, temb_dim=64)
    cn = load(ControlNet(**kw), P.controlnet_params_from_flax(tree))
    down_t, mid_t = cn(_nchw(x), torch.as_tensor(t), to_t(ctx), _nchw(hint), 0.8)
    assert len(down_t) == len(down_j) == 4  # conv_in, down_0 resnet + downsample, down_1 resnet
    assert float(np.abs(np.asarray(mid_j)).max()) > 0
    for a, b in zip(down_t + [mid_t], list(down_j) + [mid_j]):
        assert rel_l2(_nhwc(a), np.asarray(b)) <= REL


def test_unet_with_residuals_matches_jax(tiny):
    jm, tm = tiny
    x, t, ctx, hint = _cn_inputs(seed=9)
    down_j, mid_j = jm.controlnet.apply({"params": _cn_params_nonzero(jm)}, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx), jnp.asarray(hint))
    want = np.asarray(jm.unet.apply({"params": jm.unet_params}, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), controlnet_residuals=(down_j, mid_j)))
    res = ([_nchw(np.asarray(d)) for d in down_j], _nchw(np.asarray(mid_j)))
    got = _nhwc(tm.unet(_nchw(x), torch.as_tensor(t), to_t(ctx), controlnet_residuals=res))
    assert rel_l2(got, want) <= REL
    plain = np.asarray(jm.unet.apply({"params": jm.unet_params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    assert rel_l2(plain, want) > 1e-3  # the residuals moved the output


# ---------------------------------------------------------------- VAE


@pytest.mark.parametrize("H,W", [(64, 64), (48, 40)])
def test_vae_encode_matches_jax(tiny, H, W):
    """The mode of the posterior; the stride-2 downsamples pad (0, 1)."""
    jm, tm = tiny
    img = np.random.default_rng(H).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    want = np.asarray(JPipeline(jm).image_to_latent(jnp.asarray(img)))
    got = SDControlNetPipeline(tm).image_to_latent(to_t(img))
    assert got.shape == want.shape == (2, H // 8, W // 8, 4)
    assert rel_l2(got, want) <= REL
    sampled = SDControlNetPipeline(tm).image_to_latent(to_t(img), torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(sampled).all()) and rel_l2(sampled, want) > 1e-4


def test_vae_decode_matches_jax(tiny):
    jm, tm = tiny
    lat = _normal((2, 8, 8, 4), 11, 0.5)
    raw = np.asarray(jm.vae.apply({"params": jm.vae_params}, jnp.asarray(lat), method=JAutoencoderKL.decode))
    want = np.asarray(JPipeline(jm).latent_to_image(jnp.asarray(lat)))
    assert rel_l2(_nhwc(tm.vae.decode(_nchw(lat))), raw) <= REL
    got = SDControlNetPipeline(tm).latent_to_image(to_t(lat))
    assert got.shape == (2, 64, 64, 3) and rel_l2(got, want) <= REL


# ---------------------------------------------------------------- the loops


def test_invert_matches_jax(tiny):
    jm, tm = tiny
    lat, ctx = _normal((2, 8, 8, 4), 12), _normal((2, 77, 32), 13)
    hint = np.random.default_rng(14).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JPipeline(jm).invert(jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(hint), num_steps=2))
    got = SDControlNetPipeline(tm).invert(to_t(lat), to_t(ctx), to_t(hint), num_steps=2)
    assert rel_l2(got, want) <= REL_LOOP


def test_generate_with_cross_view_processor_matches_jax(tiny):
    """4 reference views + 2 chunk views, CFG batch [uncond; cond]."""
    jm, tm = tiny
    B = 6
    lat, c_pos, c_neg = _normal((B, 8, 8, 4), 15), _normal((B, 77, 32), 16), _normal((B, 77, 32), 17)
    hint = np.random.default_rng(18).uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JPipeline(jm).generate(jnp.asarray(lat), jnp.asarray(c_pos), jnp.asarray(c_neg),
                                             jnp.asarray(hint), 5.0, num_steps=2,
                                             processor=jcross_view(0.6, 4)))
    got = SDControlNetPipeline(tm).generate(to_t(lat), to_t(c_pos), to_t(c_neg), to_t(hint), 5.0,
                                            num_steps=2, processor=make_cross_view_processor(0.6, 4))
    assert rel_l2(got, want) <= REL_LOOP


def test_init_random_models_follows_flax():
    m = init_random_models(3, "cpu", torch.bfloat16, **TINY)
    assert m.dtype == torch.bfloat16 and m.text_encoder.text_model.final_layer_norm.weight.dtype == torch.float32
    for conv in m.controlnet.zero_convs():
        assert not conv.weight.any() and not conv.bias.any()
    w = m.unet.conv_in.weight.float()
    std = (1 / (4 * 9)) ** 0.5  # lecun-normal: 1/fan_in
    assert abs(float(w.std()) / std - 1) < 0.2 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-2
    pipe = SDControlNetPipeline(m)
    img = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    z = pipe.invert(pipe.image_to_latent(img), torch.zeros(1, 77, 32), img, num_steps=2)
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae"])
def test_full_keysets_translate_onto_port_modules(which):
    """Every key of the SD-1.x checkpoints lands on a parameter of the port's
    module at full width, with its shape; nothing is missing or left over."""
    keys, translate, make = {
        "unet": (keysets.sd15_unet_keys(), convert.translate_unet_key, UNet2DCondition),
        "controlnet": (keysets.sd15_controlnet_keys(), convert.translate_unet_key, ControlNet),
        "vae": (keysets.sd15_vae_keys(), convert.translate_vae_key, AutoencoderKL),
    }[which]
    sd = convert.convert_state_dict({k: torch.empty(s, device="meta") for k, s in keys.items()}, translate)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_load_sd_models_matches_jax_conversion(tmp_path):
    """``load_sd_models`` on a toy diffusers directory gives what the JAX
    package's converter gives, carried across by ``params.py``: the same
    names and the same values, with nothing transposed twice."""
    parts = toy_checkpoint(tmp_path)
    m = convert.load_sd_models(tmp_path, device="cpu", dtype=torch.float32)
    assert m.tokenizer is None and m.text_encoder is not None
    for name, module, translate in (("unet", m.unet, jconvert.translate_unet_key),
                                    ("controlnet", m.controlnet, jconvert.translate_unet_key),
                                    ("vae", m.vae, jconvert.translate_vae_key)):
        tree = jconvert.convert_state_dict(jconvert._read_weights(tmp_path / name), translate, strict=True)
        want = P.state_dict_from_flax(tree)
        got = module.state_dict()
        assert set(got) == set(want) and len(got) == len(parts[name])
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    z = SDControlNetPipeline(m).image_to_latent(torch.rand(1, 32, 32, 3))
    assert z.shape == (1, 4, 4, 4) and bool(torch.isfinite(z).all())


def test_read_safetensors_matches_the_library(tmp_path):
    import safetensors.torch

    tensors = {"a": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(2, 2).to(torch.bfloat16), "d": torch.randn(4).half(), "e": torch.empty(0, 3)}
    safetensors.torch.save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = convert.read_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v)
    with pytest.raises(FileNotFoundError):
        convert.read_weights(tmp_path / "missing")


def test_convert_state_dict_strict():
    with pytest.raises(ValueError, match="skipped"):
        convert.convert_state_dict({"some.bogus.module.weight": torch.zeros(3, 3)}, convert.translate_unet_key)
    sd = convert.convert_state_dict({"mid_block.attentions.0.proj_in.weight": torch.arange(16.0).reshape(4, 4, 1, 1)},
                                    convert.translate_unet_key)
    torch.testing.assert_close(sd["mid_attn_0.proj_in.weight"], torch.arange(16.0).reshape(4, 4))
