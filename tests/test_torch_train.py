"""PyTorch port vs the JAX package: the training step.

Optimizer (per-group Adam with optax's step semantics, the camera
MultiSteps), densify/prune/opacity reset with the optimizer's moments,
``init_from_points``, the camera pose delta, several ``make_train_step``
steps, the ``Trainer`` cadence and ``evaluate``. All inputs are made with
numpy from seeds; random draws (split offsets) are taken from JAX and fed to
the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at, make_camera as jmake_camera
from gaussctrl_exp_tpu.engine import optimizers as jopt
from gaussctrl_exp_tpu.engine import trainer as jtr
from gaussctrl_exp_tpu.models import camera_opt as jcam
from gaussctrl_exp_tpu.models import densify as jden
from gaussctrl_exp_tpu.models.gaussians import GaussianParams as JParams
from gaussctrl_exp_tpu.models.gaussians import GaussianState as JState
from gaussctrl_exp_tpu.models.gaussians import init_from_points as jinit_from_points
from gaussctrl_exp_tpu.models.gaussians import init_random as jinit_random
from gaussctrl_exp_tpu.models.splat_model import SplatModelConfig as JModelConfig
from gaussctrl_exp_tpu.models.splat_model import render_model as jrender_model
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu.ops.ssim import splatfacto_loss as jsplatfacto_loss
from gaussctrl_exp_tpu_torch.cameras import make_camera
from gaussctrl_exp_tpu_torch.engine import optimizers as topt
from gaussctrl_exp_tpu_torch.engine import trainer as ttr
from gaussctrl_exp_tpu_torch.models import camera_opt as tcam
from gaussctrl_exp_tpu_torch.models import densify as tden
from gaussctrl_exp_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianParams,
    GaussianState,
    init_from_points,
    params_from_numpy,
)
from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model
from gaussctrl_exp_tpu_torch.ops import blend_cuda
from gaussctrl_exp_tpu_torch.ops.lpips import lpips_random
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX_RENDER = JRenderConfig(impl="jnp", isect_capacity=1 << 12, max_per_tile=512)


def _np(tree) -> dict:
    return {k: np.array(v) for k, v in tree._asdict().items()}


def _leaves(arrays) -> GaussianParams:
    return GaussianParams(**{k: torch.tensor(arrays[k], requires_grad=True) for k in PARAM_NAMES})


def _adam(state, name):
    return state.inner_states[name].inner_state[0]


# ---------------------------------------------------------------- optimizer


def test_gaussian_optimizer_matches_optax():
    """Learning rates of updates 0..2 equal optax's (update k uses lr(k));
    after 5 updates from the same gradients params and moments agree (the
    same float32 Adam arithmetic in another order, torch's exp_avg being a
    lerp: a few ulp of each group's largest entry)."""
    gs = jinit_random(20, capacity=24, sh_degree=1, seed=2)
    jo = jopt.make_gaussian_optimizer(max_steps=4)  # the means schedule decays, then clamps
    js = jo.init(gs.params)
    jp = gs.params
    tp = _leaves(_np(gs.params))
    to = topt.make_gaussian_optimizer(tp, max_steps=4)
    sched = jopt.exp_decay(1.6e-4, 1.6e-6, 4)
    rng = np.random.default_rng(0)
    for k in range(5):
        grads = {n: (rng.normal(size=np.shape(getattr(jp, n))) * 1e-2).astype(np.float32) for n in PARAM_NAMES}
        upd, js = jo.update(JParams(**{n: jnp.asarray(g) for n, g in grads.items()}), js, jp)
        jp = optax.apply_updates(jp, upd)
        for n in PARAM_NAMES:
            getattr(tp, n).grad = torch.tensor(grads[n])
        to.step()
        lrs = {g["name"]: g["lr"] for g in to.param_groups}
        if k < 3:
            assert lrs["means"] == pytest.approx(float(sched(k)), rel=1e-6)
            assert lrs["means"] < 1.6e-4 or k == 0
        assert lrs["opacities"] == 5e-2 and lrs["features_rest"] == 2.5e-3 / 20
    for n in PARAM_NAMES:
        np.testing.assert_allclose(getattr(tp, n).detach().numpy(), np.asarray(getattr(jp, n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        st = topt.group_state(to, n)
        assert int(st["step"]) == int(_adam(js, n).count) == 5
        for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = np.asarray(getattr(getattr(_adam(js, n), jkey), n))
            np.testing.assert_allclose(st[key].numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{n} {key}")


def test_camera_multisteps_matches_optax():
    """The camera Adam applies only every k-th step, with the mean gradient."""
    cfg = jtr.TrainConfig(camera_opt=True, camera_opt_accum=3, max_steps=10)
    jo = jtr.make_camera_optimizer(cfg)
    jx = jnp.zeros((2, 6))
    js = jo.init(jx)
    delta = torch.zeros((2, 6), requires_grad=True)
    to = topt.MultiStepAdam(delta, topt.exp_decay(1e-3, 5e-5, 10), 3)
    rng = np.random.default_rng(1)
    for i in range(7):
        g = rng.normal(size=(2, 6)).astype(np.float32)
        upd, js = jo.update(jnp.asarray(g), js, jx)
        jx = optax.apply_updates(jx, upd)
        delta.grad = torch.tensor(g)
        assert to.step() == ((i + 1) % 3 == 0)
        np.testing.assert_allclose(delta.detach().numpy(), np.asarray(jx), rtol=1e-5, atol=1e-9)
        assert bool((delta != 0).any()) == (i >= 2)


# ---------------------------------------------------------------- densify


def test_accumulate_stats_matches():
    rng = np.random.default_rng(3)
    C = 32
    xg, rad = rng.normal(size=(C, 2)).astype(np.float32), rng.integers(0, 9, C).astype(np.int32)
    s0 = (rng.uniform(0, 1, C).astype(np.float32), rng.integers(0, 4, C).astype(np.int32),
          rng.uniform(0, 0.1, C).astype(np.float32))
    want = jden.accumulate_stats(jden.DensifyStats(*map(jnp.asarray, s0)), jnp.asarray(xg), jnp.asarray(rad), 64.0)
    got = tden.accumulate_stats(tden.stats_from_numpy(*s0), torch.tensor(xg), torch.tensor(rad), 64.0)
    np.testing.assert_allclose(got.xys_grad_sum.numpy(), np.asarray(want.xys_grad_sum), rtol=1e-6)
    np.testing.assert_array_equal(got.vis_count.numpy(), np.asarray(want.vis_count))
    np.testing.assert_array_equal(got.max_radii2d.numpy(), np.asarray(want.max_radii2d))


DENSIFY_CFG = jden.DensifyConfig(refine_every=10, reset_alpha_every=3)


def _densify_setup():
    """56 gaussians at capacity 64 (8 dead slots, so some candidates drop),
    sizes either side of the split/dup threshold and some too big, some low
    opacities, random statistics, and an Adam state after two updates."""
    C, n = 64, 56
    rng = np.random.default_rng(7)
    p = _np(jinit_random(n, capacity=C, sh_degree=1, seed=3).params)
    p["scales"][:n] = np.log(rng.uniform(0.002, 0.05, (n, 3))).astype(np.float32)
    p["scales"][:20] -= np.log(6.0)  # every axis ≤ 0.05/6 < densify_size_thresh: duplicated, not split
    p["scales"][[3, 9]] = np.log(0.8)
    p["opacities"][:n] = rng.normal(0, 2, (n, 1)).astype(np.float32)
    alive = np.arange(C) < n
    alive[[5, 20]] = False
    stats = (rng.uniform(0, 3e-5, C).astype(np.float32) * alive, (rng.integers(0, 4, C) * alive).astype(np.int32),
             rng.uniform(0, 0.2, C).astype(np.float32) * alive)
    jo = jopt.make_gaussian_optimizer()
    jp = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    js = jo.init(jp)
    for _ in range(2):
        g = JParams(**{k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in p.items()})
        upd, js = jo.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    return jp, alive, js, stats


def _port_from_jax(jp, alive, js):
    tp = _leaves(_np(jp))
    to = topt.make_gaussian_optimizer(tp)
    to.state.update(topt.adam_state_from_optax(jax.device_get(js), tp))
    return GaussianState(tp, torch.tensor(alive)), to


def _assert_moments_equal(to, js):
    for n in PARAM_NAMES:
        st = topt.group_state(to, n)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(getattr(_adam(js, n).mu, n)), err_msg=n)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(getattr(_adam(js, n).nu, n)), err_msg=n)


def test_refine_matches_with_injected_draws():
    jp, alive, js, stats = _densify_setup()
    key = jax.random.PRNGKey(9)
    k1, k2, _ = jax.random.split(key, 3)  # as densify.refine splits its key
    C = jp.means.shape[0]
    noise = (np.asarray(jax.random.normal(k1, (C, 3))), np.asarray(jax.random.normal(k2, (C, 3))))
    jgs, js2, jstats, jinfo = jden.refine(JState(jp, jnp.asarray(alive)), js, jden.DensifyStats(*map(jnp.asarray, stats)),
                                          jnp.int32(1000), key, DENSIFY_CFG, 64.0)

    gs, to = _port_from_jax(jp, alive, js)
    tstats = tden.stats_from_numpy(*stats)
    info = tden.refine(gs, to, tstats, 1000, tden.DensifyConfig(**dataclasses.asdict(DENSIFY_CFG)), 64.0,
                       noise=tuple(torch.tensor(x) for x in noise))
    got_info = {k: int(v) for k, v in info.items()}
    assert got_info == {k: int(v) for k, v in jinfo.items()}
    assert got_info["n_split"] > 0 and got_info["n_dup"] > 0 and got_info["n_cull"] > 0
    assert got_info["n_dropped"] > 0
    np.testing.assert_array_equal(gs.alive.numpy(), np.asarray(jgs.alive))
    _assert_moments_equal(to, js2)  # zeroed rows and untouched rows alike
    for n in PARAM_NAMES:
        np.testing.assert_allclose(getattr(gs.params, n).detach().numpy(), np.asarray(getattr(jgs.params, n)),
                                   rtol=0, atol=1e-6, err_msg=n)
    for f in ("xys_grad_sum", "vis_count", "max_radii2d"):
        assert not getattr(tstats, f).any()


def test_reset_opacity_matches():
    jp, alive, js, _ = _densify_setup()
    jgs, js2 = jden.reset_opacity(JState(jp, jnp.asarray(alive)), js, DENSIFY_CFG)
    gs, to = _port_from_jax(jp, alive, js)
    tden.reset_opacity(gs, to, tden.DensifyConfig(**dataclasses.asdict(DENSIFY_CFG)))
    np.testing.assert_array_equal(gs.params.opacities.detach().numpy(), np.asarray(jgs.params.opacities))
    assert float(torch.sigmoid(gs.params.opacities).max()) <= 0.2 + 1e-6
    _assert_moments_equal(to, js2)
    assert not topt.group_state(to, "opacities")["exp_avg"].any()


# ---------------------------------------------------------------- init, camera


@pytest.mark.parametrize("with_rgb", [True, False])
def test_init_from_points_matches(with_rgb):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (30, 3)).astype(np.uint8) if with_rgb else None
    want = jinit_from_points(pts, rgb, capacity=40, sh_degree=2, seed=6)
    got = init_from_points(pts, rgb, capacity=40, sh_degree=2, seed=6, device="cpu")
    for n in PARAM_NAMES:  # the knn distances: a KD-tree there, brute force here
        np.testing.assert_allclose(getattr(got.params, n).numpy(), np.asarray(getattr(want.params, n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


def test_pose_delta_matches_and_is_finite_at_zero():
    rng = np.random.default_rng(5)
    c2w = look_at([0.3, -3.0, 1.0], np.zeros(3))
    for d in (np.zeros(6, np.float32), (rng.normal(size=6) * 0.1).astype(np.float32)):
        want = jcam.apply_pose_delta(jmake_camera(c2w, 50.0, 50.0, 16, 16, 32, 32), jnp.asarray(d))
        got = tcam.apply_pose_delta(make_camera(c2w, 50.0, 50.0, 16, 16, 32, 32, device="cpu"), torch.tensor(d))
        np.testing.assert_allclose(got.c2w.numpy(), np.asarray(want.c2w), rtol=1e-6, atol=1e-6)
    w = torch.zeros(3, requires_grad=True)
    tcam.exp_so3(w).sum().backward()
    assert torch.isfinite(w.grad).all()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jax.grad(lambda x: jnp.sum(jcam.exp_so3(x)))(jnp.zeros(3))))


# ---------------------------------------------------------------- train step


class FakeDataManager:
    """Serves a fixed set of (camera, image) pairs, as tests/test_train.py's."""

    def __init__(self, cameras, images, seed=0):
        self.cameras, self.images = cameras, images
        self.width, self.height = cameras[0].width, cameras[0].height
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.cameras)

    def next_train(self):
        i = int(self._rng.integers(len(self.cameras)))
        return i, self.images[i]

    def camera(self, i):
        return self.cameras[i]

    def image(self, i):
        return self.images[i]

    def eval_indices(self, max_views: int = 8):
        return list(range(min(len(self.cameras), max_views)))


EYES = [np.array([3.5 * np.sin(a), -3.5 * np.cos(a), 0.8]) for a in (0.0, 0.5, -0.5, 1.0)]


@pytest.fixture(scope="module")
def target_scene():
    """tests/test_train.py's scene: 40 'true' gaussians seen by 4 cameras at
    48×48, rendered with the JAX package; returns (c2ws, images)."""
    rng = np.random.default_rng(11)
    means = np.zeros((64, 3), np.float32)
    means[:40] = rng.normal(size=(40, 3)).astype(np.float32) * 0.6
    true = jinit_random(40, capacity=64, sh_degree=0, seed=1)
    params = true.params._replace(
        means=jnp.asarray(means),
        scales=jnp.full((64, 3), np.log(0.12)),
        features_dc=jnp.asarray(rng.uniform(-2, 2, (64, 3)).astype(np.float32)),
        opacities=jnp.full((64, 1), 2.0),
    )
    c2ws = [look_at(e, np.zeros(3)) for e in EYES]
    cfg = JModelConfig(sh_degree=0, background_color="white", render=JAX_RENDER)
    images = [np.asarray(jrender_model(JState(params, true.alive), jmake_camera(c, 60.0, 60.0, 24.0, 24.0, 48, 48),
                                       0, cfg).rgb) for c in c2ws]
    return c2ws, images


def _tcams(c2ws):
    return [make_camera(c, 60.0, 60.0, 24.0, 24.0, 48, 48, device="cpu") for c in c2ws]


def _port_cfg(jcfg: jtr.TrainConfig, **over) -> ttr.TrainConfig:
    m = jcfg.model
    model = SplatModelConfig(sh_degree=m.sh_degree, sh_degree_interval=m.sh_degree_interval,
                             background_color=m.background_color)
    dens = tden.DensifyConfig(**dataclasses.asdict(jcfg.densify))
    return ttr.TrainConfig(model=model, densify=dens, use_lpips=jcfg.use_lpips, **over)


# gradients: float32 renders that differ in summation order (the blend's
# cumprod/scatter, the SSIM filter), so each group agrees to ~1e-5 of its
# largest entry; metrics to 1e-5 relative
GRAD_ATOL_REL = 1e-4
METRIC_RTOL = 1e-4


def test_train_steps_match_jax(target_scene):
    """Four steps of ``make_train_step`` with the SH degree going 0 → 3.

    Parameters are compared only where the gradient exceeded 1e-4 of its
    group's largest entry at every step so far at which the group had a
    gradient: Adam with eps = 1e-15 makes
    update 1 ±lr for any non-zero gradient, so a gradient near zero whose
    sign differs between the frameworks moves a parameter by 2·lr there."""
    c2ws, images = target_scene
    jcfg = jtr.TrainConfig(
        model=JModelConfig(sh_degree=3, sh_degree_interval=1, background_color="white", render=JAX_RENDER),
        densify=jden.DensifyConfig(warmup_length=10_000), use_lpips=False,
    )
    gs = jinit_random(50, capacity=64, sh_degree=3, seed=5)
    # anisotropic scales, so that the rotations have a gradient (the knn
    # init gives every gaussian three equal axes)
    aniso = np.random.default_rng(8).normal(0.0, 0.4, (64, 3)).astype(np.float32)
    gs = JState(gs.params._replace(scales=gs.params.scales + aniso), gs.alive)
    jstate = jtr.init_train_state(gs, jcfg)
    jstep = jtr.make_train_step(jcfg)

    @jax.jit
    def jgrads(params, alive, step, cam, gt):
        def loss(p):
            out = jrender_model(JState(p, alive), cam, step, jcfg.model, training=True,
                                xys_offset=jnp.zeros((p.capacity, 2)))
            return jsplatfacto_loss(out.rgb, gt, jcfg.ssim_lambda)[0]

        return jax.grad(loss)(params)

    tcfg = _port_cfg(jcfg)
    tstate = ttr.init_train_state(GaussianState(params_from_numpy(_np(gs.params), "cpu"), torch.tensor(np.asarray(gs.alive))), tcfg)
    tstep = ttr.make_train_step(tcfg)
    tcams = _tcams(c2ws)
    keep = {n: np.ones(np.shape(getattr(gs.params, n)), bool) for n in PARAM_NAMES}
    for i in range(4):
        jcam_i = jmake_camera(c2ws[i], 60.0, 60.0, 24.0, 24.0, 48, 48)
        gt = jnp.asarray(images[i])
        jg = jgrads(jstate.params, jstate.alive, jstate.step, jcam_i, gt)
        jstate, jm = jstep(jstate, jcam_i, gt, jnp.int32(i))
        tm = tstep(tstate, tcams[i], torch.tensor(images[i]), i)
        assert tm["n_isects"] == int(jm["n_isects"])
        for k in ("l1", "ssim", "main_loss", "psnr", "Gradients/Total", *(f"Gradients/{n}" for n in PARAM_NAMES)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-9, err_msg=f"step {i} {k}")
        for n in PARAM_NAMES:
            g = np.asarray(getattr(jg, n))
            scale = np.abs(g).max()
            np.testing.assert_allclose(getattr(tstate.params, n).grad.numpy(), g, rtol=0,
                                       atol=max(GRAD_ATOL_REL * scale, 1e-12), err_msg=f"step {i} grad {n}")
            if scale > 0:  # a group outside the graph (rest bands above the degree) does not move
                keep[n] &= np.abs(g) > 1e-4 * scale
            np.testing.assert_allclose(getattr(tstate.params, n).detach().numpy()[keep[n]],
                                       np.asarray(getattr(jstate.params, n))[keep[n]],
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {i} param {n}")
        np.testing.assert_allclose(tstate.stats.xys_grad_sum.numpy(), np.asarray(jstate.stats.xys_grad_sum),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(tstate.stats.vis_count.numpy(), np.asarray(jstate.stats.vis_count))
    assert tstate.step == int(jstate.step) == 4
    assert keep["features_rest"].any()  # degree ≥ 1 trained the rest bands


def test_trainer_cadence_refine_and_reset(target_scene):
    """splatfacto's refinement_after schedule, as tests/test_train.py pins it
    for the JAX trainer; the refine draws noise, so counts, not values."""
    c2ws, images = target_scene
    dm = FakeDataManager(_tcams(c2ws), images)
    cfg = ttr.TrainConfig(
        model=SplatModelConfig(sh_degree=0, background_color="white"),
        densify=tden.DensifyConfig(warmup_length=3, refine_every=2, reset_alpha_every=8, stop_split_at=25),
        use_lpips=False,
    )
    from gaussctrl_exp_tpu_torch.models.gaussians import init_random

    trainer = ttr.Trainer(init_random(40, capacity=64, sh_degree=0, seed=5, device="cpu"), dm, cfg)
    refines, resets, infos = [], [], []
    real_refine, real_reset = trainer.refine_step, trainer.reset_opacity_step

    def refine_step(s):
        refines.append(trainer.step)
        infos.append({k: int(v) for k, v in real_refine(s).items()})

    trainer.refine_step = refine_step
    trainer.reset_opacity_step = lambda s: (resets.append(trainer.step), real_reset(s))
    launches = blend_cuda.launches, blend_cuda.bwd_launches
    trainer.train(32, log_every=8)
    assert (blend_cuda.launches, blend_cuda.bwd_launches) == launches  # CPU: the plain versions

    assert resets == [18]
    assert refines == [8, 10, 12, 14, 24, 26, 28, 30, 32]
    assert [h["step"] for h in trainer.history] == [1, 8, 16, 24, 32]
    assert trainer.history[-1]["n_alive"] == int(trainer.state.alive.sum()) == infos[-1]["n_alive"]
    assert all(i["n_split"] + i["n_dup"] == 0 for i in infos[-4:])  # cull-only past stop_split_at
    assert sum(i["n_split"] + i["n_dup"] for i in infos) > 0
    for n in PARAM_NAMES:
        assert torch.isfinite(getattr(trainer.state.params, n)).all(), n
    assert all(np.isfinite(h["main_loss"]) for h in trainer.history)


def test_evaluate_matches_jax(target_scene):
    c2ws, images = target_scene
    gs = jinit_random(40, capacity=64, sh_degree=0, seed=5)
    jcfg = jtr.TrainConfig(model=JModelConfig(sh_degree=0, background_color="white", render=JAX_RENDER),
                           densify=jden.DensifyConfig(warmup_length=10_000))
    jdm = FakeDataManager([jmake_camera(c, 60.0, 60.0, 24.0, 24.0, 48, 48) for c in c2ws], images)
    with pytest.warns(UserWarning, match="no VGG/LPIPS weights"):
        want = jtr.Trainer(gs, jdm, jcfg).evaluate()
    tgs = GaussianState(params_from_numpy(_np(gs.params), "cpu"), torch.tensor(np.asarray(gs.alive)))
    with pytest.warns(UserWarning, match="no VGG/LPIPS weights"):
        got = ttr.Trainer(tgs, FakeDataManager(_tcams(c2ws), images), _port_cfg(jcfg)).evaluate()
    assert set(got) == set(want) == {"eval_psnr", "eval_ssim"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_train_with_lpips_and_camera_opt(target_scene):
    """The patch-LPIPS term joins the loss; camera deltas stay zero until
    the accumulation boundary, then move."""
    c2ws, images = target_scene
    dm = FakeDataManager(_tcams(c2ws), images)
    cfg = ttr.TrainConfig(model=SplatModelConfig(sh_degree=0, background_color="white"),
                          densify=tden.DensifyConfig(warmup_length=10_000), patch_size=16, lpips_patches=2,
                          camera_opt=True, camera_opt_accum=3)
    from gaussctrl_exp_tpu_torch.models.gaussians import init_random

    trainer = ttr.Trainer(init_random(40, capacity=64, sh_degree=0, seed=5, device="cpu"), dm, cfg,
                          lpips=lpips_random(0, device="cpu"))
    assert trainer.state.cam_deltas.shape == (4, 6)
    trainer.train(2, log_every=1)
    assert not trainer.state.cam_deltas.any()
    m = trainer.history[-1]
    assert "lpips" in m and np.isfinite(m["lpips"])
    np.testing.assert_allclose(m["main_loss"], 0.8 * m["l1"] + 0.2 * (1 - m["ssim"]) + m["lpips"], rtol=1e-5)
    trainer.train(1, log_every=1)
    assert trainer.state.cam_deltas.any()
    assert "eval_lpips" in trainer.evaluate([0])
    with torch.no_grad():
        out = render_model(GaussianState(trainer.state.params, trainer.state.alive), dm.camera(0),
                           trainer.state.step, cfg.model)
    assert torch.isfinite(out.rgb).all()
