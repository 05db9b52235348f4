"""PyTorch port vs the JAX package: the depth-conditioned multi-view
generator (``diffusion/mv_generator.py``), sampling and training.

The JAX test's tiny generator (tests/test_mv_generator.py: latent 8,
block_out (32, 64), 2 heads, cross dim 16, one layer per block) carries its
Flax weights into the port through ``diffusion/params.py`` (the 5-channel
``conv_in`` is mechanical). The timesteps, the noise and the initial
latents come from JAX's own draws or from numpy and are fed to both. Stated
tolerances, float32: the depth latent ≤ 1e-6 absolute (the same resize
weights, summed in another order); tables and pair mask equal; ε and
``sample`` ≤ 1e-5 relative L2; the train step's loss ≤ 1e-6 relative, and
the updated parameters ≤ 1e-5 relative L2 per tensor over the entries whose
gradient stands above float32 noise (|g| > 1e-5 of the largest gradient).
Adam's first step moves a weight by lr·g/(|g| + ε) ≈ ±lr whatever |g| is, so
where the gradient is zero in exact arithmetic (a conv bias just before a
GroupNorm) both packages hold 1e-9 to 5e-7 of rounding noise and move it by
±lr at random; there the test asserts only that the step is at most lr.
(Measured: 6.5e-6 where the weight starts at 0, from optax's float32 bias
correction 1 − 0.999.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.diffusion import mv_generator as jmv
from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.diffusion import mv_generator as mv
from gaussctrl_exp_tpu_torch.diffusion import params as P
from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import rel_l2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
TINY = dict(block_out=(32, 64), heads=2, cross_dim=16, layers_per_block=1)
EYES = [[0.0, -4.0, 0.0], [0.5, -3.9, 0.2]]


def _cams():
    j = [jmake_camera(jlook_at(np.array(e), np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32) for e in EYES]
    t = [make_camera(look_at(np.array(e), np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32, device="cpu") for e in EYES]
    return j, t


def _depths():
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    return [(4.0 + 0.2 * xs - 0.1 * ys).astype(np.float32), (4.1 - 0.15 * xs + 0.1 * ys).astype(np.float32)]


@pytest.fixture(scope="module")
def gens():
    """(JAX generator, port generator) with the same weights."""
    jcfg = jmv.MVGeneratorConfig(latent_size=8, num_steps=2, guidance_scale=3.0)
    jgen = jmv.init_depth_generator(jax.random.PRNGKey(0), latent=8, cfg=jcfg, **TINY)
    unet = UNet2DCondition(in_channels=5, temb_dim=TINY["block_out"][-1], **TINY)
    unet.load_state_dict(P.unet_params_from_flax(jax.device_get(jgen.unet_params)), strict=True)
    assert unet.conv_in.weight.shape == (32, 5, 3, 3)
    tgen = mv.DepthGenerator(unet, mv.MVGeneratorConfig(latent_size=8, num_steps=2, guidance_scale=3.0))
    return jgen, tgen


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_inverse_depth_latent_matches_jax():
    d = np.linspace(1.0, 10.0, 32 * 32, dtype=np.float32).reshape(32, 32)
    d[3, 5] = 1000.0  # an empty pixel
    for size in (8, 32):
        got = mv.inverse_depth_latent(d, size)
        assert got.shape == (size, size, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(jmv.inverse_depth_latent(d, size)), atol=1e-6, rtol=0)
    got = mv.inverse_depth_latent(d[..., None], 8).numpy()  # the renderer's (H, W, 1)
    assert got.max() <= 1.0 + 1e-6 and got.min() >= 0.0 and got[0, 0, 0] > got[-1, -1, 0]


def test_attention_resolutions(gens):
    jgen, tgen = gens
    assert tgen.attention_resolutions() == jgen.attention_resolutions() == [8, 4]


def test_prepare_matches_jax(gens):
    jgen, tgen = gens
    jc, tc = _cams()
    depths = _depths()
    _, jdl, jpm = jgen.prepare(depths, jc)
    proc, tdl, tpm = tgen.prepare(depths, tc)
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tpm, np.asarray(jpm))
    assert tpm.dtype == np.float32 and tpm.sum() == 4  # the two views overlap
    # the tables the processor holds are those of build_correspondence_tables
    jtab = {s * s: jmv.build_correspondence_tables([jnp.asarray(d) for d in depths], jc, s, 0.1) for s in (8, 4)}
    ttab = {s * s: mv.build_correspondence_tables([_t(d) for d in depths], tc, s, 0.1) for s in (8, 4)}
    for S in (64, 16):
        np.testing.assert_array_equal(ttab[S][0].numpy(), np.asarray(jtab[S][0]))
    # inconsistent depths mask the pair out
    _, _, pm = tgen.prepare([depths[0], np.full((32, 32), 1.0, np.float32)], tc)
    np.testing.assert_array_equal(pm, np.asarray(jgen.prepare([depths[0], np.full((32, 32), 1.0)], jc)[2]))
    assert pm[0, 1] == 0.0


def test_eps_with_the_processor_matches_jax(gens):
    jgen, tgen = gens
    jc, tc = _cams()
    jproc, jdl, _ = jgen.prepare(_depths(), jc)
    tproc, tdl, _ = tgen.prepare(_depths(), tc)
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)  # 2 CFG groups × 2 views
    ctx = rng.normal(size=(4, 77, 16)).astype(np.float32)
    t = np.array([901, 901, 401, 401])
    dl2 = np.concatenate([np.asarray(jdl)] * 2)
    want = jgen._eps(jnp.asarray(lat), jnp.asarray(dl2), jnp.asarray(t), jnp.asarray(ctx), jproc)
    with torch.no_grad():
        got = tgen._eps(_t(lat), torch.cat([tdl, tdl]), torch.as_tensor(t), _t(ctx), tproc)
    assert got.shape == (4, 8, 8, 4) and rel_l2(got, want) <= REL


def test_sample_matches_jax(gens):
    jgen, tgen = gens
    jc, tc = _cams()
    rng = np.random.default_rng(1)
    ctx_c = rng.normal(size=(2, 77, 16)).astype(np.float32)
    ctx_u = np.zeros_like(ctx_c)
    init = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    want = jgen.sample(jax.random.PRNGKey(1), jnp.asarray(ctx_c), jnp.asarray(ctx_u), _depths(), jc,
                       init_latents=jnp.asarray(init))
    got = tgen.sample(_t(ctx_c), _t(ctx_u), _depths(), tc, init_latents=_t(init))
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    assert rel_l2(got, want) <= REL
    drawn = tgen.sample(_t(ctx_c), _t(ctx_u), _depths(), tc, generator=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(drawn).all())


def test_train_step_matches_jax(gens):
    """One Adam(1e-3) step through the epipolar processor: JAX's jitted step
    against the port's, fed the timesteps and noise JAX draws from its key."""
    jgen, tgen = gens
    jc, tc = _cams()
    jproc, jdl, _ = jgen.prepare(_depths(), jc)
    tproc, tdl, _ = tgen.prepare(_depths(), tc)
    rng = np.random.default_rng(2)
    x0 = (rng.normal(size=(2, 8, 8, 4)) * 0.5).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    opt = optax.adam(1e-3)
    step = jgen.make_train_step(opt, processor=jproc)
    jparams, _, jloss = step(jgen.unet_params, opt.init(jgen.unet_params), key, jnp.asarray(x0), jdl, jnp.asarray(ctx))
    kt, kn = jax.random.split(key)  # the draws inside JAX's loss
    t = np.asarray(jax.random.randint(kt, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(kn, x0.shape, jnp.float32))

    unet = UNet2DCondition(in_channels=5, temb_dim=64, **TINY)
    unet.load_state_dict(tgen.unet.state_dict())
    gen = mv.DepthGenerator(unet, tgen.cfg)
    topt = torch.optim.Adam(unet.parameters(), lr=1e-3)
    loss = gen.train_step_at(topt, _t(x0), tdl, _t(ctx), torch.as_tensor(t), _t(noise), tproc)
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = P.unet_params_from_flax(jax.device_get(jparams))
    before = tgen.unet.state_dict()
    grads = dict(unet.named_parameters())
    floor = 1e-5 * max(float(g.grad.abs().max()) for g in grads.values())
    worst, n_noise, n_all = 0.0, 0, 0
    for n, w in want.items():
        got, start, signal = grads[n].detach(), before[n], grads[n].grad.abs() > floor
        n_noise += int((~signal).sum())
        n_all += signal.numel()
        if bool(signal.any()):
            worst = max(worst, rel_l2(got[signal], w[signal].numpy()))
        for moved in (got - start, w - start):
            assert float((moved * ~signal).abs().max()) <= 1e-3 * (1 + 1e-4)
        assert not torch.equal(got, start)  # every parameter took a step
    assert worst <= REL, worst
    assert n_noise <= 0.02 * n_all, (n_noise, n_all)  # 1.1% measured: the test is not vacuous


def test_train_step_reduces_loss(gens):
    """The same draw every step (a generator seeded anew), as the JAX test:
    the loss falls."""
    _, tgen = gens
    unet = UNet2DCondition(in_channels=5, temb_dim=64, **TINY)
    unet.load_state_dict(tgen.unet.state_dict())
    gen = mv.DepthGenerator(unet, tgen.cfg)
    step = gen.make_train_step(torch.optim.Adam(unet.parameters(), lr=1e-3))
    rng = np.random.default_rng(2)
    x0 = _t(rng.normal(size=(2, 8, 8, 4)) * 0.1)
    dl = _t(rng.uniform(0, 1, (2, 8, 8, 1)))
    ctx = _t(rng.normal(size=(2, 77, 16)))
    losses = [float(step(x0, dl, ctx, torch.Generator().manual_seed(3))) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_init_depth_generator_cpu():
    gen = mv.init_depth_generator(0, latent=8, device="cpu", **TINY)
    assert gen.unet.conv_in.weight.shape == (32, 5, 3, 3)
    assert all(p.requires_grad for p in gen.unet.parameters())
    assert gen.device.type == "cpu" and gen.cfg.latent_size == 8
    n_tiny = sum(p.numel() for p in gen.unet.parameters())
    ref = UNet2DCondition(in_channels=4, temb_dim=64, **TINY)
    assert n_tiny - sum(p.numel() for p in ref.parameters()) == 32 * 9  # one more input channel
