"""PyTorch port vs the JAX package: cameras, quaternions, SH and projection.

Inputs are made with numpy from a seed and handed to both sides; JAX runs on
the CPU (tests/conftest.py pins it there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_scene
from gaussctrl_exp_tpu import cameras as jcam
from gaussctrl_exp_tpu.ops import projection as jproj
from gaussctrl_exp_tpu.ops import quat as jquat
from gaussctrl_exp_tpu.ops import sh as jsh
from gaussctrl_exp_tpu_torch import cameras as tcam
from gaussctrl_exp_tpu_torch.ops import projection as tproj
from gaussctrl_exp_tpu_torch.ops import quat as tquat
from gaussctrl_exp_tpu_torch.ops import sh as tsh

# float32 on both sides; the two frameworks order a few sums differently, so
# matrices and continuous outputs agree to a few ulp, never bit for bit
RTOL, ATOL = 1e-5, 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


POSES = [
    (np.array([0.0, -4.0, 0.0]), np.zeros(3)),
    (np.array([2.5, -3.0, 1.5]), np.array([0.2, 0.1, -0.3])),
]


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_camera_matrices(pose):
    eye, target = POSES[pose]
    c2w_t = tcam.look_at(eye, target)
    c2w_j = jcam.look_at(eye, target)
    np.testing.assert_array_equal(c2w_t, c2w_j)
    W, H, fx, fy = 96, 64, 70.0, 75.0
    cj = jcam.make_camera(c2w_j, fx, fy, W / 2, H / 2, W, H)
    ct = tcam.make_camera(c2w_t, fx, fy, W / 2, H / 2, W, H, device="cpu")
    np.testing.assert_allclose(_np(ct.fovx), np.asarray(cj.fovx), rtol=1e-6)
    np.testing.assert_allclose(_np(ct.fovy), np.asarray(cj.fovy), rtol=1e-6)
    for a, b in zip(tcam.camera_matrices(ct), jcam.camera_matrices(cj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _np(tcam.view_matrix(ct.c2w, gsplat_flip=False)),
        np.asarray(jcam.view_matrix(cj.c2w, gsplat_flip=False)), rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        _np(tcam.projection_matrix_ogl(0.001, 1000.0, ct.fovx, ct.fovy)),
        np.asarray(jcam.projection_matrix_ogl(0.001, 1000.0, cj.fovx, cj.fovy)),
        rtol=RTOL, atol=ATOL,
    )
    # a 4×4 pose is cut to its top 3×4
    c44 = np.concatenate([c2w_t, [[0, 0, 0, 1]]]).astype(np.float32)
    np.testing.assert_array_equal(_np(tcam.make_camera(c44, fx, fy, 1, 1, W, H, device="cpu").c2w), c2w_t)


def test_quat(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = np.exp(rng.normal(size=(50, 3)).astype(np.float32) * 0.5 - 2)
    np.testing.assert_allclose(
        _np(tquat.quat_to_rotmat(torch.as_tensor(q))), np.asarray(jquat.quat_to_rotmat(jnp.asarray(q))),
        rtol=RTOL, atol=1e-6,
    )
    np.testing.assert_allclose(
        _np(tquat.scale_rot_to_cov3d(torch.as_tensor(s), torch.as_tensor(q), 1.5)),
        np.asarray(jquat.scale_rot_to_cov3d(jnp.asarray(s), jnp.asarray(q), 1.5)),
        rtol=RTOL, atol=1e-8,
    )


# (coefficient degree, active degree): every degree at full activity, and
# runtime degrees below the coefficients' maximum (the SH schedule)
@pytest.mark.parametrize("max_deg,active", [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (3, 1), (3, 0), (4, 2)])
def test_eval_sh(rng, max_deg, active):
    n, K = 64, tsh.num_sh_bases(max_deg)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(n, K, 3)).astype(np.float32)
    got = tsh.eval_sh(active, torch.as_tensor(dirs), torch.as_tensor(coeffs))
    want = jsh.eval_sh(active, jnp.asarray(dirs), jnp.asarray(coeffs))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=1e-5)
    # a 0-d tensor degree gives the same colours as the int
    np.testing.assert_array_equal(
        _np(tsh.eval_sh(torch.tensor(active), torch.as_tensor(dirs), torch.as_tensor(coeffs))), _np(got)
    )


def _projection_scene(rng, n=200):
    means, scales, quats, _, opacs = make_test_scene(rng, n=n)
    means[0] = [0.0, -6.0, 0.0]  # behind the camera at y = -4
    means[1] = [0.0, -3.995, 0.0]  # in front, inside the near clip
    opacs[2] = 1.0 / 300.0  # below 1/255 everywhere: culled by opacity
    means[3] = [40.0, 0.0, 0.0]  # far outside the frustum
    scales[4] = [0.9, 0.9, 0.9]  # large: a wide, clamped bbox
    alive = np.ones(n, bool)
    alive[5] = False  # culled by the extra mask
    return means, scales, quats, opacs, alive


@pytest.mark.parametrize("with_opacity", [True, False])
def test_project_gaussians(rng, with_opacity):
    means, scales, quats, opacs, alive = _projection_scene(rng)
    H, W, f = 60, 76, 70.0
    cam = jcam.make_camera(jcam.look_at([0.0, -4.0, 0.0], np.zeros(3)), f, f, W / 2, H / 2, W, H)
    vm, _, fm = jcam.camera_matrices(cam)
    opa_j = jnp.asarray(opacs) if with_opacity else None
    pj = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
        cam.fx, cam.fy, cam.cx, cam.cy, H, W, extra_mask=jnp.asarray(alive), opacities=opa_j,
    )
    # both sides get the same matrices, so the test isolates the projection
    pt = tproj.project_gaussians(
        torch.as_tensor(means), torch.as_tensor(scales), 1.0, torch.as_tensor(quats),
        torch.as_tensor(np.array(vm)), torch.as_tensor(np.array(fm)),
        torch.tensor(float(cam.fx)), torch.tensor(float(cam.fy)),
        torch.tensor(float(cam.cx)), torch.tensor(float(cam.cy)), H, W,
        extra_mask=torch.as_tensor(alive), opacities=torch.as_tensor(opacs) if with_opacity else None,
    )
    mask = np.asarray(pj.mask)
    assert not mask[[0, 1, 3, 5]].any()
    assert mask[2] != with_opacity
    # discrete outputs: exactly equal
    for name in ("mask", "radii", "num_tiles_hit", "tile_bbox"):
        np.testing.assert_array_equal(_np(getattr(pt, name)), np.asarray(getattr(pj, name)), err_msg=name)
    # continuous outputs, compared where they are finite on the JAX side
    for name in ("xys", "depths", "conics", "cov3d"):
        np.testing.assert_allclose(
            _np(getattr(pt, name))[mask], np.asarray(getattr(pj, name))[mask],
            rtol=RTOL, atol=1e-4, err_msg=name,
        )
    assert pt.tile_bbox.dtype == torch.int32 and pt.radii.dtype == torch.int32
    # dtype-following: float64 inputs stay float64 and agree with float32
    p64 = tproj.project_gaussians(
        torch.as_tensor(means, dtype=torch.float64), torch.as_tensor(scales, dtype=torch.float64), 1.0,
        torch.as_tensor(quats), torch.as_tensor(np.array(vm)), torch.as_tensor(np.array(fm)),
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), H, W,
    )
    assert p64.xys.dtype == torch.float64 and p64.conics.dtype == torch.float64
    np.testing.assert_allclose(_np(p64.xys)[mask], _np(pt.xys)[mask], rtol=1e-4, atol=1e-3)
