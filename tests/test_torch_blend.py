"""PyTorch port vs the JAX package: the tile blend.

The plain PyTorch blend is held against the JAX oracle
(``rasterize_tiles_jnp``) and the Pallas kernel in interpret mode, on the same
projected inputs. The CUDA kernel is held against the plain version in
tests/test_torch_kernels.py, which needs a card and no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_scene
from gaussctrl_exp_tpu.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu.ops.binning import bin_gaussians
from gaussctrl_exp_tpu.ops.blend import rasterize_tiles_jnp
from gaussctrl_exp_tpu.ops.blend_pallas import rasterize_tiles_pallas
from gaussctrl_exp_tpu.ops.projection import BLOCK, project_gaussians
from gaussctrl_exp_tpu_torch.ops import blend_cuda
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians as tbin
from gaussctrl_exp_tpu_torch.ops.blend import rasterize_naive, rasterize_tiles_plain, tile_pairs
from gaussctrl_exp_tpu_torch.ops.projection import ProjectedGaussians
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# All three compute the transmittance in float32 in different ways (a
# cumprod here and in the oracle, exp of a matmul of log1p in Pallas): they
# agree to ~1e-6, and these scenes have no pixel whose transmittance lands
# within rounding of the 1e-4 stop threshold, so 1e-5 holds everywhere.
ATOL = 1e-5
MAX_PER_TILE = 512  # the oracle's static cap; asserted not to bind
JAX_CAPACITY = 1 << 12


def _scene(rng, n=300, H=64, W=64, f=80.0, n_chan=4, spread=1.0, opac_scale=1.0):
    means, scales, quats, colors, opacs = make_test_scene(rng, n=n, spread=spread)
    opacs = (opacs * opac_scale).astype(np.float32)
    cam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), f, f, W / 2, H / 2, W, H)
    vm, _, fm = camera_matrices(cam)
    pj = project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
        cam.fx, cam.fy, cam.cx, cam.cy, H, W, opacities=jnp.asarray(opacs),
    )
    tx, ty = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bj = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(pj, tx, ty, JAX_CAPACITY)
    assert int(bj.n_isects) <= JAX_CAPACITY
    chan = np.concatenate([colors, np.asarray(pj.depths)[:, None]], -1)[:, :n_chan]
    args = (np.asarray(pj.xys), np.asarray(pj.conics), chan, opacs)
    pt = ProjectedGaussians(**{k: torch.as_tensor(np.array(v)) for k, v in pj._asdict().items()})
    bt = tbin(pt, tx, ty)
    return args, pj, bj, pt, bt, H, W


def _plain(args, bt, H, W):
    return rasterize_tiles_plain(*(torch.as_tensor(np.array(a)) for a in args), bt, H, W)


def _oracle(args, bj, H, W):
    order = np.asarray(bj.order)
    return rasterize_tiles_jnp(*(jnp.asarray(a)[order] for a in args), bj, H, W, max_per_tile=MAX_PER_TILE)


@pytest.mark.parametrize("H,W", [(64, 64), (44, 60)])
def test_plain_matches_jnp_oracle(rng, H, W):
    args, _, bj, _, bt, H, W = _scene(rng, H=H, W=W)
    assert int(bt.tile_cnt.max()) <= MAX_PER_TILE  # the oracle's cap does not bind
    got, want = _plain(args, bt, H, W), _oracle(args, bj, H, W)
    assert got.img.shape == (H, W, 4) and got.final_T.shape == (H, W)
    np.testing.assert_allclose(got.img.numpy(), np.asarray(want.img), atol=ATOL)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(want.final_T), atol=ATOL)
    assert float(got.final_T.min()) < 0.5  # the scene covers real area


def test_plain_matches_jnp_oracle_over_several_kernel_batches(rng):
    """Every tile holds 273-351 gaussians at opacities 0.02-0.095, and every
    pixel walks its whole list, past the 256 gaussians the CUDA kernels stage
    at a time: the plain version, which the card tests hold the kernels to
    there, still agrees with the oracle."""
    args, _, bj, _, bt, H, W = _scene(rng, n=700, H=32, W=32, f=60.0, spread=0.5, opac_scale=0.1)
    cnt = bt.tile_cnt.long()
    assert int(cnt.min()) > 256 and int(cnt.max()) <= MAX_PER_TILE
    t = [torch.as_tensor(np.array(a)) for a in args]
    walked, _, _ = tile_pairs(t[0], t[1], t[3], bt, H, W)
    assert torch.equal(walked, 256 * cnt)  # no pixel stops
    got, want = _plain(args, bt, H, W), _oracle(args, bj, H, W)
    np.testing.assert_allclose(got.img.numpy(), np.asarray(want.img), atol=ATOL)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(want.final_T), atol=ATOL)
    assert float(got.final_T.min()) < 0.5  # the lists do composite


def test_plain_matches_pallas_interpret(rng):
    args, _, bj, _, bt, H, W = _scene(rng)
    got = _plain(args, bt, H, W)
    want = rasterize_tiles_pallas(*(jnp.asarray(a) for a in args), bj, H, W, interpret=True)
    np.testing.assert_allclose(got.img.numpy(), np.asarray(want.img), atol=ATOL)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(want.final_T), atol=ATOL)


def test_plain_matches_naive(rng):
    args, _, _, pt, bt, H, W = _scene(rng)
    got = _plain(args, bt, H, W)
    t = [torch.as_tensor(np.array(a)) for a in args]
    want = rasterize_naive(t[0], pt.depths, t[1], t[2], t[3], pt.mask, pt.tile_bbox, H, W)
    np.testing.assert_allclose(got.img.numpy(), want.img.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.final_T.numpy(), want.final_T.numpy(), atol=ATOL)


def test_plain_empty_scene(rng):
    """Zero opacity: every alpha is below 1/255, so img 0 and T 1 everywhere."""
    args, _, bj, _, bt, H, W = _scene(rng)
    args = args[:3] + (np.zeros_like(args[3]),)
    got = _plain(args, bt, H, W)
    want = _oracle(args, bj, H, W)
    assert bt.n_isects > 0
    np.testing.assert_array_equal(got.img.numpy(), 0.0)
    np.testing.assert_array_equal(got.final_T.numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(want.final_T), 1.0)


def test_plain_small_batches_match(rng, monkeypatch):
    """Tiles split across many batches give the same image as one batch."""
    args, _, _, _, bt, H, W = _scene(rng)
    whole = _plain(args, bt, H, W)
    monkeypatch.setattr("gaussctrl_exp_tpu_torch.ops.blend._BATCH_ELEMS", 256 * 8)
    split = _plain(args, bt, H, W)
    np.testing.assert_array_equal(split.img.numpy(), whole.img.numpy())
    np.testing.assert_array_equal(split.final_T.numpy(), whole.final_T.numpy())


def test_wrapper_cpu_takes_plain_version(rng):
    """CPU tensors go to the plain version and launch nothing."""
    args, _, _, _, bt, H, W = _scene(rng)
    t = [torch.as_tensor(np.array(a)) for a in args]
    before = blend_cuda.launches
    out = blend_cuda.rasterize_tiles(*t, bt, H, W)
    assert blend_cuda.launches == before
    ref = rasterize_tiles_plain(*t, bt, H, W)
    np.testing.assert_array_equal(out.img.numpy(), ref.img.numpy())
