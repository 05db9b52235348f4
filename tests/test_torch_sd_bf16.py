"""PyTorch port vs the JAX package: the bf16 edit stack's norms.

The JAX package builds the UNet, the ControlNet and the VAE with Flax's
``dtype=jnp.bfloat16``, the compute type: every parameter stays float32,
Dense and Conv cast their kernel to bf16 at each use, and GroupNorm and
LayerNorm take their statistics in float32, apply their float32 scale and
bias, and round once to bf16. The port's bf16 constructors
(``init_random_models`` and ``load_sd_models``) keep the norms' scale and
bias float32 and the Linear and Conv weights bf16, which is what a
round-to-nearest cast at use gives.

Random init leaves every norm at scale 1 and bias 0, which bf16 holds
exactly; so here every parameter is drawn from a numpy seed, norms at scale
1 + 0.3·N(0, 1) and bias 0.2·N(0, 1), and carried to the port with
``diffusion/params.state_dict_from_flax``. The parameter trees come from
``jax.eval_shape`` of the Flax modules' init, so nothing is initialised
eagerly. Stated tolerances:

- one forward of the UNet, the ControlNet, the VAE decoder and encoder in
  bf16 against the JAX modules at ``TINY`` widths: relative L2 ≤ 3e-2
  (measured 4.0e-3 to 2.3e-2). The two frameworks round bf16 convolutions
  and activations at different places, so most outputs differ by an ulp or
  more whatever the norms hold, and this bound alone cannot tell float32
  norm parameters from bf16 ones (measured 1.9e-2 with either);
- so every GroupNorm and LayerNorm of the three modules, fed the bf16 input
  it received in the port's forward, is held against Flax's norm with
  ``dtype=jnp.bfloat16`` on the same float32 parameters: at most 1% of the
  bf16 outputs differ (by an ulp: Flax takes the variance as E[x²] − E[x]²)
  and the relative L2 is ≤ 5e-4 (measured at most 0.12% and 1.6e-4 over the
  101 norms). With the norms' parameters rounded to bf16, 24-36% of each
  norm's outputs differ, at 2.2e-3 or more. A norm that the UNet or the
  ControlNet calls with ``silu=True`` is held, under the same limits,
  against SiLU of Flax's rounded norm;
- both again with the UNet and the ControlNet channels-last, as the card's
  pipeline keeps them (``layers.to_channels_last``): their norms then take
  the NHWC path, whose plain version runs here.

The tests take about 30 s, most of it JAX compiling the three modules.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_exp_tpu.diffusion import controlnet as jcontrolnet
from gaussctrl_exp_tpu.diffusion import unet as junet
from gaussctrl_exp_tpu.diffusion import vae as jvae
from gaussctrl_exp_tpu_torch.diffusion import convert
from gaussctrl_exp_tpu_torch.diffusion import params as P
from gaussctrl_exp_tpu_torch.diffusion.layers import to_channels_last
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import init_random_models
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY, rel_l2, toy_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FORWARD_REL = 3e-2
NORM_DIFFER_MAX, NORM_REL = 1e-2, 5e-4
BF16 = jnp.bfloat16
MODULES = ("unet", "controlnet", "vae")
_KW = dict(block_out=TINY["block_out"], layers_per_block=TINY["layers_per_block"], heads=TINY["heads"],
           cross_dim=TINY["cross_dim"], temb_dim=TINY["block_out"][-1])


def _flax_modules():
    return dict(unet=junet.UNet2DCondition(**_KW, dtype=BF16), controlnet=jcontrolnet.ControlNet(**_KW, dtype=BF16),
                vae=jvae.AutoencoderKL(block_out=TINY["vae_block_out"], dtype=BF16))


def _draw(shapes, rng):
    """A Flax parameter tree of ``shapes`` drawn from ``rng``: kernels
    N(0, 1/fan-in), biases N(0, 0.1²), norms' scale 1 + 0.3·N(0, 1) and
    bias 0.2·N(0, 1), all float32."""
    out = {}
    for k, v in shapes.items():
        if not hasattr(v, "shape"):
            out[k] = _draw(v, rng)
            continue
        assert v.dtype == jnp.float32, k  # Flax keeps every parameter float32
        norm = "scale" in shapes
        if k == "kernel":
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k == "scale":
            a = 1.0 + 0.3 * rng.normal(size=v.shape)
        else:
            a = (0.2 if norm else 0.1) * rng.normal(size=v.shape)
        out[k] = a.astype(np.float32)
    return out


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(lat=f(2, 8, 8, 4), t=np.array([1, 501], np.int32), ctx=f(2, 77, TINY["cross_dim"]),
                hint=rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
                img=rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))


def _nchw(a):
    return torch.tensor(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float()


@pytest.fixture(scope="module")
def flax_side():
    """The inputs; the JAX bf16 modules' seeded parameters as the port's
    state dicts, and their outputs."""
    flax_mods, x = _flax_modules(), _inputs()
    key = jax.random.PRNGKey(0)
    lat, t, ctx, hint, img = (jnp.asarray(x[k]) for k in ("lat", "t", "ctx", "hint", "img"))
    shapes = dict(unet=jax.eval_shape(flax_mods["unet"].init, key, lat, t, ctx),
                  controlnet=jax.eval_shape(flax_mods["controlnet"].init, key, lat, t, ctx, hint),
                  vae=jax.eval_shape(flax_mods["vae"].init, key, img))
    rng = np.random.default_rng(1)
    trees = {n: _draw(shapes[n]["params"], rng) for n in MODULES}
    ju, jc, jv = (flax_mods[n] for n in MODULES)
    want = dict(
        unet=jax.jit(lambda p: ju.apply({"params": p}, lat, t, ctx))(trees["unet"]),
        controlnet=jax.jit(lambda p: jc.apply({"params": p}, lat, t, ctx, hint))(trees["controlnet"]),
        decode=jax.jit(lambda p: jv.apply({"params": p}, lat, method=jvae.AutoencoderKL.decode))(trees["vae"]),
        encode=jax.jit(lambda p: jv.apply({"params": p}, img, method=jvae.AutoencoderKL.encode))(trees["vae"]))
    return x, {n: P.state_dict_from_flax(trees[n]) for n in MODULES}, want


def _port_side(flax_side, channels_last: bool):
    """The port's bf16 stack from ``init_random_models`` carrying the JAX
    side's parameters, with the UNet and ControlNet channels-last as the
    card's pipeline keeps them where ``channels_last``; its outputs, and
    every norm's input, whether it applied SiLU, and its output."""
    x, sds, want = flax_side
    models = init_random_models(0, "cpu", torch.bfloat16, **TINY)
    for n in MODULES:
        getattr(models, n).load_state_dict(sds[n], strict=True)
    if channels_last:
        to_channels_last(models.unet)
        to_channels_last(models.controlnet)
    seen = []  # (the norm, its float32 scale and bias, its input, whether SiLU followed, its output)

    def hook(params):
        return lambda m, args, kwargs, out: seen.append((m, params, args[0], kwargs.get("silu", False), out))

    handles = [m.register_forward_hook(hook((sds[n][f"{name}.weight"], sds[n][f"{name}.bias"])), with_kwargs=True)
               for n in MODULES for name, m in getattr(models, n).named_modules()
               if isinstance(m, (nn.GroupNorm, nn.LayerNorm))]
    with torch.no_grad():
        got = dict(unet=models.unet(_nchw(x["lat"]), torch.as_tensor(x["t"]), torch.tensor(x["ctx"])),
                   controlnet=models.controlnet(_nchw(x["lat"]), torch.as_tensor(x["t"]), torch.tensor(x["ctx"]),
                                                _nchw(x["hint"])),
                   decode=models.vae.decode(_nchw(x["lat"])), encode=models.vae.encode(_nchw(x["img"])))
    for h in handles:
        h.remove()
    return models, want, got, seen


@pytest.fixture(scope="module")
def stacks(flax_side):
    return _port_side(flax_side, channels_last=False)


@pytest.fixture(scope="module")
def stacks_channels_last(flax_side):
    return _port_side(flax_side, channels_last=True)


def _norm_params(models):
    return [(n, name, p) for n in MODULES for m in getattr(models, n).modules()
            if isinstance(m, (nn.GroupNorm, nn.LayerNorm)) for name, p in m.named_parameters()]


def test_bf16_constructors_keep_norm_parameters_float32(tmp_path):
    """Both constructors: every GroupNorm and LayerNorm parameter float32,
    every other parameter of the UNet, ControlNet and VAE bf16; the loaded
    norms hold the checkpoint's float32 values exactly."""
    toy_checkpoint(tmp_path)
    loaded = convert.load_sd_models(tmp_path, device="cpu", dtype=torch.bfloat16)
    for models in (init_random_models(0, "cpu", torch.bfloat16, **TINY), loaded):
        norms = _norm_params(models)
        assert len(norms) == 66 + 32 + 104  # scales and biases of the tiny UNet's, ControlNet's and VAE's norms
        assert all(p.dtype == torch.float32 for _, _, p in norms)
        ids = {id(p) for _, _, p in norms}
        rest = [p for n in MODULES for p in getattr(models, n).parameters() if id(p) not in ids]
        assert rest and all(p.dtype == torch.bfloat16 for p in rest)
        assert models.dtype == torch.bfloat16
    for n in MODULES:
        translate = convert.translate_vae_key if n == "vae" else convert.translate_unet_key
        want = convert.convert_state_dict(convert.read_weights(tmp_path / n), translate)
        for k, v in getattr(loaded, n).state_dict().items():
            if v.dtype == torch.float32:
                assert torch.equal(v, want[k]), k
                assert not torch.equal(v, v.to(torch.bfloat16).float()), k  # bf16 would have rounded it


def _check_forward(stacks, which):
    _, want, got, _ = stacks
    if which == "controlnet":
        pairs = list(zip(got[which][0] + [got[which][1]], list(want[which][0]) + [want[which][1]]))
        assert len(pairs) == 5  # conv_in, down_0 resnet + downsample, down_1 resnet; the mid block
    else:
        pairs = [(got[which], want[which])]
    for g, w in pairs:
        assert g.dtype == torch.bfloat16 and w.dtype == BF16
        assert rel_l2(_nhwc(g), np.asarray(w, np.float32)) <= FORWARD_REL


@pytest.mark.parametrize("which", ["unet", "controlnet", "decode", "encode"])
def test_bf16_forward_matches_jax(stacks, which):
    _check_forward(stacks, which)


@pytest.mark.parametrize("which", ["unet", "controlnet", "decode", "encode"])
def test_bf16_forward_matches_jax_channels_last(stacks_channels_last, which):
    _check_forward(stacks_channels_last, which)


def _flax_norm(m, scale, bias, x):
    """Flax's norm of ``m``'s kind with ``dtype=bf16`` and the float32
    ``scale`` and ``bias`` on the port's bf16 input ``x`` (NCHW for a
    GroupNorm), in the port's layout."""
    params = {"params": {"scale": scale.numpy(), "bias": bias.numpy()}}
    xj = jnp.asarray(x.float().numpy()).astype(BF16)
    if isinstance(m, nn.GroupNorm):
        out = fnn.GroupNorm(num_groups=m.num_groups, epsilon=m.eps, dtype=BF16).apply(
            params, jnp.moveaxis(xj, 1, -1))
        return np.moveaxis(np.asarray(out, np.float32), -1, 1)
    return np.asarray(fnn.LayerNorm(epsilon=m.eps, dtype=BF16).apply(params, xj), np.float32)


def _check_norms(stacks):
    models, _, _, seen = stacks
    assert len(seen) == len(_norm_params(models)) // 2  # each norm ran once
    for m, (scale, bias), x, silu, out in seen:
        assert x.dtype == out.dtype == torch.bfloat16
        want = _flax_norm(m, scale, bias, x)
        if silu:  # the UNet's and ControlNet's resnets and conv_norm_out: SiLU of the rounded norm
            want = F.silu(torch.tensor(want).bfloat16()).float().numpy()
        got = out.float().numpy()
        assert float((got != want).mean()) <= NORM_DIFFER_MAX, m
        assert rel_l2(got, want) <= NORM_REL, m
        assert m.weight.dtype == m.bias.dtype == torch.float32


def test_every_norm_applies_float32_parameters_as_flax(stacks):
    _check_norms(stacks)


def test_every_norm_applies_float32_parameters_as_flax_channels_last(stacks_channels_last):
    """The same with the UNet and the ControlNet channels-last: every one of
    their GroupNorms receives a channels-last input, and so takes N1's path."""
    _check_norms(stacks_channels_last)
    models, _, _, seen = stacks_channels_last
    stack = {id(m) for n in ("unet", "controlnet") for m in getattr(models, n).modules()}
    norms = [x.is_contiguous(memory_format=torch.channels_last)
             for m, _, x, _, _ in seen if isinstance(m, nn.GroupNorm) and id(m) in stack]
    assert len(norms) == 31 and all(norms)  # the tiny UNet's 21 GroupNorms and the ControlNet's 10
