"""PyTorch port vs the JAX package: tile binning.

Both binners get the same projected arrays (the JAX projection's, converted),
so every discrete output must agree exactly: the depth order, the per-tile
counts, each tile's gaussian list and the intersection total.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_scene
from gaussctrl_exp_tpu.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu.ops.binning import bin_gaussians
from gaussctrl_exp_tpu.ops.projection import BLOCK, project_gaussians
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians as tbin
from gaussctrl_exp_tpu_torch.ops.projection import ProjectedGaussians

JAX_CAPACITY = 1 << 12  # above every scene's n_isects here (asserted)
jbin = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))


def _project(rng, n, H, W, cull="none"):
    means, scales, quats, _, opacs = make_test_scene(rng, n=n)
    alive = np.ones(n, bool)
    if cull == "first":
        alive[0] = False
    elif cull == "all":
        alive[:] = False
    cam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), 80.0, 80.0, W / 2, H / 2, W, H)
    vm, _, fm = camera_matrices(cam)
    return project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
        cam.fx, cam.fy, cam.cx, cam.cy, H, W,
        extra_mask=jnp.asarray(alive), opacities=jnp.asarray(opacs),
    )


def to_torch_proj(pj) -> ProjectedGaussians:
    return ProjectedGaussians(**{k: torch.as_tensor(np.array(v)) for k, v in pj._asdict().items()})


@pytest.mark.parametrize(
    "n,H,W,cull",
    [(300, 64, 64, "none"), (300, 64, 64, "first"), (150, 44, 60, "none"), (40, 32, 32, "all")],
)
def test_binning_matches_jax(rng, n, H, W, cull):
    pj = _project(rng, n, H, W, cull)
    tx, ty = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bj = jbin(pj, tx, ty, JAX_CAPACITY)
    bt = tbin(to_torch_proj(pj), tx, ty)

    n_isects = int(bj.n_isects)
    assert n_isects <= JAX_CAPACITY
    assert bt.n_isects == n_isects == bt.gid.shape[0]
    np.testing.assert_array_equal(bt.order.numpy(), np.asarray(bj.order))
    np.testing.assert_array_equal(bt.tile_cnt.numpy(), np.asarray(bj.tile_cnt))
    order = np.asarray(bj.order)
    rank = np.asarray(bj.sorted_rank)
    for t, (s, c) in enumerate(zip(np.asarray(bj.tile_start), np.asarray(bj.tile_cnt))):
        want = order[rank[s : s + c]]
        got = bt.gid[bt.tile_start[t] : bt.tile_start[t] + bt.tile_cnt[t]].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"tile {t}")
    if cull == "first":
        assert not bool(pj.mask[0]) and 0 not in bt.gid.tolist()
    if cull == "all":
        assert n_isects == 0 and int(bt.tile_cnt.sum()) == 0
    assert bt.gid.dtype == bt.tile_start.dtype == bt.tile_cnt.dtype == torch.int32


def test_binning_depth_ties(rng):
    """Equal depths keep index order (a stable sort), as JAX's lax.sort does."""
    pj = _project(rng, 64, 32, 32)
    depths = np.array(pj.depths)
    depths[10:30] = depths[10]  # a run of ties
    pj = pj._replace(depths=jnp.asarray(depths))
    bj = jbin(pj, 2, 2, JAX_CAPACITY)
    bt = tbin(to_torch_proj(pj), 2, 2)
    np.testing.assert_array_equal(bt.order.numpy(), np.asarray(bj.order))
    np.testing.assert_array_equal(bt.tile_cnt.numpy(), np.asarray(bj.tile_cnt))
