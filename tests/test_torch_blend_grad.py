"""PyTorch port vs the JAX package: the blend backward.

The port's plain VJP (autograd through ``rasterize_tiles_plain`` with the
ungated ``clamp_alpha``) is held against ``jax.grad`` of the JAX oracle
``rasterize_tiles_jnp`` on scenes whose alphas stay under the 0.999 clamp
(the oracle gates the clamp, the kernels do not), including a scene with
the leading gaussians culled, and against the VJP of the Pallas kernel in
interpret mode on a scene whose alphas reach the clamp. Kernel B2 is held
against the plain VJP in tests/test_torch_kernels.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_scene
from gaussctrl_exp_tpu.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu.models.gaussians import GaussianParams as JParams
from gaussctrl_exp_tpu.models.gaussians import GaussianState as JState
from gaussctrl_exp_tpu.models.splat_model import SplatModelConfig as JModelConfig
from gaussctrl_exp_tpu.models.splat_model import render_model as jrender_model
from gaussctrl_exp_tpu.ops.binning import bin_gaussians
from gaussctrl_exp_tpu.ops.blend import rasterize_tiles_jnp
from gaussctrl_exp_tpu.ops.blend_pallas import rasterize_tiles_pallas
from gaussctrl_exp_tpu.ops.projection import BLOCK, project_gaussians
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu_torch.cameras import make_camera as tmake_camera
from gaussctrl_exp_tpu_torch.models.gaussians import GaussianState, params_from_numpy
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from gaussctrl_exp_tpu_torch.ops import blend_cuda
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians as tbin
from gaussctrl_exp_tpu_torch.ops.blend import blend_vjp_plain, clamp_alpha
from gaussctrl_exp_tpu_torch.ops.projection import ProjectedGaussians
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAX_PER_TILE = 512  # the oracle's static cap; asserted not to bind
JAX_CAPACITY = 1 << 12
FIELDS = ("xys", "conics", "colors", "opacs")
# plain VJP vs oracle autodiff: the same cumprod algebra in float32 on both
# sides, summed in another order (scatter-add there, index-add here), so
# each gradient agrees to a few ulp of its largest entry
ORACLE_ATOL_REL = 2e-5
# plain VJP vs the Pallas kernel's hand-written VJP: that kernel forms
# suffix = img·g − prefix (cancellation, scaled by 1/(1 − α) up to 1000 at
# the clamp) and an exp-of-matmul transmittance, so the opacity gradient
# differs by ~1.5e-5 of its largest entry on the clamped scene; 3e-4 leaves
# a margin and is still 10× tighter than the JAX package's own test of that
# VJP against autodiff (tests/test_blend_pallas.py)
PALLAS_ATOL_REL = 3e-4


def _scene(rng, n=200, H=64, W=64, f=80.0, n_chan=4, opacs=None, culled=0):
    means, scales, quats, colors, op = make_test_scene(rng, n=n)
    op = op if opacs is None else opacs(n)
    cam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), f, f, W / 2, H / 2, W, H)
    vm, _, fm = camera_matrices(cam)
    extra = np.arange(n) >= culled
    pj = project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
        cam.fx, cam.fy, cam.cx, cam.cy, H, W, extra_mask=jnp.asarray(extra), opacities=jnp.asarray(op),
    )
    tx, ty = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bj = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(pj, tx, ty, JAX_CAPACITY)
    assert int(bj.n_isects) <= JAX_CAPACITY
    chan = np.concatenate([colors, np.asarray(pj.depths)[:, None]], -1)[:, :n_chan].astype(np.float32)
    args = (np.asarray(pj.xys), np.asarray(pj.conics), chan, op.astype(np.float32))
    pt = ProjectedGaussians(**{k: torch.as_tensor(np.array(v)) for k, v in pj._asdict().items()})
    bt = tbin(pt, tx, ty)
    g = np.random.default_rng(5)
    g_img = g.normal(size=(H, W, n_chan)).astype(np.float32)
    g_T = g.normal(size=(H, W)).astype(np.float32)
    return args, pj, bj, bt, (g_img, g_T), H, W


def _plain_vjp(args, bt, cot, H, W):
    t = [torch.as_tensor(np.array(a)) for a in args]
    grads = blend_vjp_plain(*t, bt, torch.as_tensor(cot[0]), torch.as_tensor(cot[1]), H, W)
    return [g.numpy() for g in grads]


def _jax_vjp(blend, args, cot):
    def loss(*a):
        o = blend(*a)
        return jnp.sum(o.img * cot[0]) + jnp.sum(o.final_T * cot[1])

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in grads]


def _oracle_vjp(args, bj, cot, H, W):
    order = bj.order

    def blend(xys, conics, colors, opacs):
        return rasterize_tiles_jnp(xys[order], conics[order], colors[order], opacs[order], bj, H, W,
                                   max_per_tile=MAX_PER_TILE)

    return _jax_vjp(blend, args, cot)


def _assert_grads_close(got, want, atol_rel):
    for a, b, name in zip(got, want, FIELDS):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, atol=atol_rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("culled", [0, 12], ids=["all-visible", "leading-culled"])
def test_plain_vjp_matches_oracle_autodiff(rng, culled):
    args, pj, bj, bt, cot, H, W = _scene(rng, culled=culled)
    assert float(args[3].max()) < 0.999  # alpha ≤ opacity: the clamp never engages
    assert int(bt.tile_cnt.max()) <= MAX_PER_TILE  # the oracle's cap does not bind
    mask = np.asarray(pj.mask)
    assert not mask[:culled].any() and mask[culled:].sum() > 100
    got = _plain_vjp(args, bt, cot, H, W)
    want = _oracle_vjp(args, bj, cot, H, W)
    _assert_grads_close(got, want, ORACLE_ATOL_REL)
    # culled gaussians get exactly nothing; the first visible one gets its share
    for g in got:
        assert not np.any(g[:culled])
    first = int(np.argmax(mask))
    assert np.abs(got[3][first]) > 0 or np.abs(got[2][first]).max() > 0


def test_plain_vjp_matches_pallas_on_clamped_scene(rng):
    """Opacities near 1 put alpha on the 0.999 clamp at gaussian centres;
    neither the Pallas VJP nor the port gates the gradient there."""
    args, pj, bj, bt, cot, H, W = _scene(rng, n=150, opacs=lambda n: np.full(n, 0.9999, np.float32))
    assert bool(pj.mask[0])  # gaussian 0 visible: the lost first slot (ROADMAP C1) cannot bite
    got = _plain_vjp(args, bt, cot, H, W)

    def blend(*a):
        return rasterize_tiles_pallas(*a, bj, H, W, interpret=True)

    want = _jax_vjp(blend, args, cot)
    _assert_grads_close(got, want, PALLAS_ATOL_REL)
    # and the clamp did engage: autodiff of the gated oracle differs in opacity
    gated = _oracle_vjp(args, bj, cot, H, W)
    assert np.abs(gated[3] - want[3]).max() > 0.01 * np.abs(want[3]).max()


def test_backward_wrapper_takes_the_plain_vjp_on_cpu(rng):
    """``blend_cuda.blend_backward`` on CPU tensors is the plain VJP, and
    launches nothing."""
    args, pj, bj, bt, cot, H, W = _scene(rng, n=80)
    t = [torch.as_tensor(np.array(a)) for a in args]
    fwd = blend_cuda.rasterize_tiles(*t, bt, H, W)
    before = blend_cuda.bwd_launches
    got = blend_cuda.blend_backward(*t, bt, fwd.img, fwd.final_T, *map(torch.as_tensor, cot), H, W)
    assert blend_cuda.bwd_launches == before
    for a, b in zip(got, _plain_vjp(args, bt, cot, H, W)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_clamp_alpha_gradient_is_ungated():
    x = torch.tensor([0.5, 0.9995, 2.0], requires_grad=True)
    y = clamp_alpha(x)
    assert torch.equal(y, torch.clamp(x.detach(), max=0.999))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(3))


def test_xys_offset_gradient_through_render():
    """The densify statistic: d loss / d xys_offset through the model render."""
    rng = np.random.default_rng(2)
    n, H, W, f = 120, 48, 64, 70.0
    opac = rng.uniform(0.3, 0.95, size=(n, 1))
    arrays = dict(
        means=rng.normal(size=(n, 3)).astype(np.float32),
        scales=(rng.normal(size=(n, 3)) * 0.5 - 2.6).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        features_dc=(rng.normal(size=(n, 3)) * 0.8).astype(np.float32),
        features_rest=(rng.normal(size=(n, 15, 3)) * 0.2).astype(np.float32),
        opacities=np.log(opac / (1 - opac)).astype(np.float32),
    )
    alive = np.arange(n) != 3
    c2w = look_at([0.5, -4.0, 0.8], np.zeros(3))
    cot = rng.normal(size=(H, W, 3)).astype(np.float32)
    bg = np.array([0.1, 0.5, 0.9], np.float32)

    cfg = JModelConfig(render=JRenderConfig(impl="jnp", isect_capacity=JAX_CAPACITY, max_per_tile=MAX_PER_TILE))
    jstate = JState(JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(alive))
    jcam = make_camera(c2w, f, f, W / 2, H / 2, W, H)

    def jloss(off):
        out = jrender_model(jstate, jcam, 30_000, cfg, training=True,
                            background_override=jnp.asarray(bg), xys_offset=off)
        return jnp.sum(out.rgb * cot), out.render.bins

    (_, jbins), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.zeros((n, 2)))
    assert int(jbins.n_isects) <= JAX_CAPACITY and int(jbins.tile_cnt.max()) <= MAX_PER_TILE

    state = GaussianState(params_from_numpy(arrays, "cpu"), torch.as_tensor(alive))
    cam = tmake_camera(c2w, f, f, W / 2, H / 2, W, H, device="cpu")
    off = torch.zeros((n, 2), requires_grad=True)
    before = blend_cuda.bwd_launches
    out = render_model(state, cam, 30_000, SplatModelConfig(), training=True,
                       background_override=torch.as_tensor(bg), xys_offset=off)
    (out.rgb * torch.as_tensor(cot)).sum().backward()
    assert blend_cuda.bwd_launches == before  # CPU tensors take the plain VJP
    want = np.asarray(want)
    assert np.abs(want).max() > 0 and not want[3].any()
    np.testing.assert_allclose(off.grad.numpy(), want, atol=ORACLE_ATOL_REL * np.abs(want).max())
