"""PyTorch port vs the JAX package: the depth generator trained in bf16.

The JAX package's ``init_depth_generator(dtype=jnp.bfloat16)`` builds the
UNet with Flax's ``dtype``, the compute type: its parameters stay float32
(``param_dtype``), every Dense and Conv casts its kernel to bf16 at its use,
the norms apply their float32 scale and bias before rounding to bf16, and
``optax.adam`` updates float32 parameters with float32 state. The port's
``init_depth_generator(dtype=torch.bfloat16)`` does the same
(``UNet2DCondition(compute_dtype=...)``, ``diffusion/layers.py``). A port
that stored its weights in bf16 rounds most of a step of lr = 1e-4 away: on
this tiny generator only 331,067 of its 747,044 entries moved.

The tests' tiny generator is that of ``tests/test_torch_mv_generator.py``
(latent 8, block_out (32, 64), 2 heads, cross dim 16, one layer per block),
its Flax weights carried across by ``diffusion/params.py``; the timesteps
and the noise are JAX's own draws, fed to the port. Stated tolerances, bf16
(8 mantissa bits, each rounding up to 2^-9 relative, compounded through the
UNet's layers): ε through the epipolar processor ≤ 3e-2 relative L2
(measured 1.7e-2); the step's loss ≤ 5e-3 relative (measured 4.6e-4). Adam's
first step moves an entry by lr·g/(|g| + ε) ≈ ±lr, so the updated parameters
agree where the two gradients have the same sign: over the entries whose
gradient stands above 1e-2 of the largest, in bf16 noise's place of the
float32 test's 1e-5, they agree to 1e-5 relative L2 per tensor (21% of the
entries; no sign differed there), and everywhere a step is at most lr and
the float32 rounding of the sum. The share of entries that move is JAX's
within 1e-3 (JAX: 747,027 of 747,044, the rest with a gradient of exactly 0
in bf16). The test takes about a minute, most of it JAX compiling.
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
from gaussctrl_exp_tpu_torch.diffusion import layers
from gaussctrl_exp_tpu_torch.diffusion import mv_generator as mv
from gaussctrl_exp_tpu_torch.diffusion import params as P
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import rel_l2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(block_out=(32, 64), heads=2, cross_dim=16, layers_per_block=1)
EYES = [[0.0, -4.0, 0.0], [0.5, -3.9, 0.2]]
EPS_REL, LOSS_REL, STEP_REL = 3e-2, 5e-3, 1e-5
LR = 1e-4
SIGNAL = 1e-2  # of the largest gradient: above it the two gradients' signs agree


def _cams():
    j = [jmake_camera(jlook_at(np.array(e), np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32) for e in EYES]
    t = [make_camera(look_at(np.array(e), np.zeros(3)), 40.0, 40.0, 16, 16, 32, 32, device="cpu") for e in EYES]
    return j, t


def _depths():
    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    return [(4.0 + 0.2 * xs - 0.1 * ys).astype(np.float32), (4.1 - 0.15 * xs + 0.1 * ys).astype(np.float32)]


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _port(weights=None) -> mv.DepthGenerator:
    gen = mv.init_depth_generator(0, latent=8, dtype=torch.bfloat16, device="cpu", **TINY)
    if weights is not None:
        gen.unet.load_state_dict(weights, strict=True)
    return gen


@pytest.fixture(scope="module")
def gens():
    """(JAX bf16 generator, its processor and depth latents; the port's
    weights, processor and depth latents)."""
    jgen = jmv.init_depth_generator(jax.random.PRNGKey(0), latent=8, dtype=jnp.bfloat16, **TINY)
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jgen.unet_params)} == {"float32"}
    jc, tc = _cams()
    jproc, jdl, _ = jgen.prepare(_depths(), jc)
    weights = P.unet_params_from_flax(jax.device_get(jgen.unet_params))
    tproc, tdl, _ = _port().prepare(_depths(), tc)
    return jgen, jproc, jdl, weights, tproc, tdl


def test_bf16_generator_keeps_fp32_parameters_and_computes_in_bf16():
    gen = _port()
    assert gen.unet.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.requires_grad for p in gen.unet.parameters())
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(2, 8, 8, 5)))
    eps = gen._eps(x[..., :4], x[..., 4:], torch.tensor([10, 900]), _t(rng.normal(size=(2, 77, 16))), None)
    assert eps.dtype == torch.bfloat16 and eps.shape == (2, 8, 8, 4)
    eps.float().square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in gen.unet.parameters())
    opt = torch.optim.Adam(gen.unet.parameters(), lr=LR)
    opt.step()
    state = [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v) and v.dim() > 0]
    assert state and all(v.dtype == torch.float32 for v in state)
    fp32 = mv.init_depth_generator(0, latent=8, device="cpu", **TINY)  # the float32 generator: the same draws
    assert fp32.unet.compute_dtype == torch.float32
    for (n, a), b in zip(fp32.unet.named_parameters(), _port().unet.parameters()):
        assert torch.equal(a, b), n


def test_bf16_eps_with_the_processor_matches_jax(gens):
    jgen, jproc, jdl, weights, tproc, tdl = gens
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)  # 2 CFG groups × 2 views
    ctx = rng.normal(size=(4, 77, 16)).astype(np.float32)
    t = np.array([901, 901, 401, 401])
    dl2 = np.concatenate([np.asarray(jdl)] * 2)
    eps = jax.jit(lambda p, x, tt, c: jgen.unet.apply({"params": p}, x, tt, c, processor=jproc))
    want = eps(jgen.unet_params, jnp.concatenate([lat, dl2], -1), jnp.asarray(t), jnp.asarray(ctx))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = _port(weights)._eps(_t(lat), torch.cat([tdl, tdl]), torch.as_tensor(t), _t(ctx), tproc)
    assert got.shape == (4, 8, 8, 4) and got.dtype == torch.bfloat16
    assert rel_l2(got, np.asarray(want, np.float32)) <= EPS_REL


def test_bf16_train_step_matches_jax(gens):
    """One Adam(1e-4) step through the epipolar processor: JAX's jitted step
    against the port's, fed the timesteps and noise JAX draws from its key."""
    jgen, jproc, jdl, weights, tproc, tdl = gens
    rng = np.random.default_rng(2)
    x0 = (rng.normal(size=(2, 8, 8, 4)) * 0.5).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    opt = optax.adam(LR)
    step = jgen.make_train_step(opt, processor=jproc)
    jparams, jstate, jloss = step(jgen.unet_params, opt.init(jgen.unet_params), key, jnp.asarray(x0), jdl,
                                  jnp.asarray(ctx))
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves((jparams, jstate)) if a.ndim} == {"float32"}
    kt, kn = jax.random.split(key)  # the draws inside JAX's loss
    t = np.asarray(jax.random.randint(kt, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(kn, x0.shape, jnp.float32))

    gen = _port(weights)
    topt = torch.optim.Adam(gen.unet.parameters(), lr=LR)
    loss = gen.train_step_at(topt, _t(x0), tdl, _t(ctx), torch.as_tensor(t), _t(noise), tproc)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    state = [v for s in topt.state.values() for v in s.values() if torch.is_tensor(v) and v.dim() > 0]
    assert len(state) == 2 * len(weights) and all(v.dtype == torch.float32 for v in state)

    want = P.unet_params_from_flax(jax.device_get(jparams))
    named = dict(gen.unet.named_parameters())
    floor = SIGNAL * max(float(p.grad.abs().max()) for p in named.values())
    worst, n_signal, moved_port, moved_jax, n_all = 0.0, 0, 0, 0, 0
    for n, w in want.items():
        got, start = named[n].detach(), weights[n]
        assert got.dtype == torch.float32
        signal = named[n].grad.abs() > floor
        n_signal += int(signal.sum())
        if bool(signal.any()):
            worst = max(worst, rel_l2(got[signal], w[signal].numpy()))
        for step_ in (got - start, w - start):  # lr, and the float32 rounding of start + step
            assert bool((step_.abs() <= LR * (1 + 1e-4) + 1.2e-7 * start.abs()).all()), n
        assert not torch.equal(got, start), n  # every parameter tensor took a step
        moved_port += int((got != start).sum())
        moved_jax += int((w != start).sum())
        n_all += w.numel()
    assert worst <= STEP_REL, worst
    assert n_signal >= 0.1 * n_all, (n_signal, n_all)  # 21% measured: the test is not vacuous
    assert abs(moved_port - moved_jax) <= 1e-3 * n_all, (moved_port, moved_jax, n_all)


def _pair(kind, dtype):
    """A layer of ``layers`` and its ``torch.nn`` parent with the same random
    parameters in ``dtype``, and an input."""
    gen = torch.Generator().manual_seed(0)
    make = {"Linear": lambda m: m.Linear(24, 16), "Conv2d": lambda m: m.Conv2d(8, 16, 3, padding=1),
            "GroupNorm": lambda m: m.GroupNorm(4, 8, eps=1e-5), "LayerNorm": lambda m: m.LayerNorm(24, eps=1e-6)}[kind]
    ours, parent = make(layers), make(torch.nn)
    with torch.no_grad():
        for p in ours.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + (1.0 if p.dim() == 1 and "Norm" in kind else 0.0))
    parent.load_state_dict(ours.state_dict())
    shape = (2, 5, 24) if kind in ("Linear", "LayerNorm") else (2, 8, 6, 6)
    return ours.to(dtype), parent.to(dtype), torch.randn(shape, generator=gen)


@pytest.mark.parametrize("kind", ["Linear", "Conv2d", "GroupNorm", "LayerNorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_are_their_parents_where_the_types_agree(kind, dtype):
    """Parameters in the input's type (the float32 generator, the edit path's
    bf16 weights): the layer is its ``torch.nn`` parent bit for bit."""
    ours, parent, x = _pair(kind, dtype)
    x = x.to(dtype).requires_grad_()
    got, want = ours(x), parent(x)
    assert got.dtype == dtype and torch.equal(got, want)
    g_ours = torch.autograd.grad(got.float().square().sum(), [x, *ours.parameters()])
    g_parent = torch.autograd.grad(want.float().square().sum(), [x, *parent.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(g_ours, g_parent))


@pytest.mark.parametrize("kind", ["Linear", "Conv2d", "GroupNorm", "LayerNorm"])
def test_layers_compute_in_bf16_with_fp32_parameters(kind):
    """float32 parameters, bf16 input: Linear and Conv2d are the parent with
    its parameters rounded to bf16 at the use; the norms apply the float32
    scale and bias in float32 and round once, as Flax's norms do. The
    parameters' gradients are float32, those of the bf16 copies."""
    ours, parent, x = _pair(kind, torch.float32)
    xb = x.to(torch.bfloat16)
    got = ours(xb)
    assert got.dtype == torch.bfloat16
    if kind in ("Linear", "Conv2d"):
        want = parent.to(torch.bfloat16)(xb)
        grads = torch.autograd.grad(want.float().square().sum(), list(parent.parameters()))
        mine = torch.autograd.grad(got.float().square().sum(), list(ours.parameters()))
        assert all(a.dtype == torch.float32 and torch.equal(a, b.float()) for a, b in zip(mine, grads))
    else:
        want = parent(xb.float()).to(torch.bfloat16)
        assert all(g.dtype == torch.float32 for g in torch.autograd.grad(got.float().sum(), list(ours.parameters())))
    assert torch.equal(got, want)
