"""PyTorch port vs the JAX package: the experimental 3D noise mask
(``experimental/noise_mask.py``), mirroring tests/test_noise_mask.py.

The Perlin field and the point cloud are the same numpy code in both
packages, so they must be equal bit for bit. ``render_noise_mask`` runs on
the CPU through the port's plain blend and is held against the JAX package's
``impl="jnp"`` oracle at ≤ 1e-5 absolute (the same float32 splats, composited
in another order). The JAX render caps intersections (ROADMAP §C4) and
gaussians per tile (§C5); each scene keeps every point's intersections
within both caps: a 32² image has 4 tiles, so n_isects ≤ 4·n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.cameras import look_at as jlook_at
from gaussctrl_exp_tpu.cameras import make_camera as jmake_camera
from gaussctrl_exp_tpu.experimental import noise_mask as jnm
from gaussctrl_exp_tpu.ops.renderer import RenderConfig as JRenderConfig
from gaussctrl_exp_tpu_torch.cameras import look_at, make_camera
from gaussctrl_exp_tpu_torch.experimental import noise_mask as nm
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H = W = 32
CAPACITY, MAX_PER_TILE = 1 << 12, 512


def _cams(eye, f=W * 1.2):
    args = (f, f, W / 2, H / 2, W, H)
    return (jmake_camera(jlook_at(np.array(eye), np.zeros(3)), *args),
            make_camera(look_at(np.array(eye), np.zeros(3)), *args, device="cpu"))


def _jax_mask(pts, depth, cam, cfg):
    assert 4 * len(pts) <= CAPACITY and len(pts) <= MAX_PER_TILE
    rc = JRenderConfig(impl="jnp", isect_capacity=CAPACITY, render_depth=False, max_per_tile=MAX_PER_TILE)
    return np.asarray(jnm.render_noise_mask(pts, jnp.asarray(depth), cam, cfg, rc))


@pytest.mark.parametrize("kw", [dict(shape=(12, 12, 12), scale=0.3, seed=7),
                                dict(shape=(16, 16, 16), scale=0.2, octaves=3, persistence=0.5, seed=3,
                                     normalize=False),
                                dict(shape=(9, 11, 13), scale=0.45, octaves=2, seed=99)])
def test_perlin_equals_jax(kw):
    shape = kw.pop("shape")
    got = nm.perlin_noise_3d(shape, **kw)
    np.testing.assert_array_equal(got, jnm.perlin_noise_3d(shape, **kw))
    if kw.get("normalize", True):
        assert got.min() == 0.0 and got.max() == 1.0 and got.std() > 0.05


def test_noise_points_equal_jax():
    for cfg in (nm.NoiseMaskConfig(resolution=20, noise_threshold=0.7), nm.NoiseMaskConfig(resolution=30)):
        pts = nm.noise_points(cfg)
        want = jnm.noise_points(jnm.NoiseMaskConfig(**vars(cfg)))
        assert pts.dtype == np.float32 and pts.shape[1] == 3 and len(pts) > 0
        np.testing.assert_array_equal(pts, want)
        assert np.all(np.abs(pts) <= cfg.cube_size / 2 + 1e-6)


def test_render_noise_mask_depth_visibility_matches_jax():
    """A point on the surface paints the mask, one behind it does not."""
    jcam, cam = _cams([0.0, -4.0, 0.0])
    pts = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    cfg = nm.NoiseMaskConfig(noise_unit_size=0.05, frag_depth_threshold=0.05)
    jcfg = jnm.NoiseMaskConfig(**vars(cfg))
    for depth in (4.0, 2.0):
        scene = np.full((H, W), depth, np.float32)
        got = nm.render_noise_mask(pts, torch.as_tensor(scene), cam, cfg)
        assert got.shape == (H, W)
        np.testing.assert_allclose(got.numpy(), _jax_mask(pts, scene, jcam, jcfg), atol=1e-5, rtol=0)
        if depth == 4.0:
            assert float(got[H // 2, W // 2]) > 0.5
        else:
            assert float(got.max()) == 0.0


def test_render_noise_mask_multiview_matches_jax():
    cfg = nm.NoiseMaskConfig(resolution=16, noise_threshold=0.75, noise_unit_size=0.08, frag_depth_threshold=10.0)
    pts = nm.noise_points(cfg)
    for ang in (0.0, 0.3):
        jcam, cam = _cams([4.0 * np.sin(ang), -4.0 * np.cos(ang), 0.5])
        scene = np.full((H, W, 1), 4.0, np.float32)  # the renderer's (H, W, 1) depth
        got = nm.render_noise_mask(pts, scene, cam, cfg)
        np.testing.assert_allclose(got.numpy(), _jax_mask(pts, scene, jcam, jnm.NoiseMaskConfig(**vars(cfg))),
                                   atol=1e-5, rtol=0)
        assert float((got > 0.5).float().mean()) > 0.01
