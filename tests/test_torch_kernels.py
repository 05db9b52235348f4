"""Kernels B1 and B2 (the CUDA tile blend and its backward) against their
plain PyTorch versions.

Needs an NVIDIA card and nvcc; without a card every test here skips. The
file imports neither JAX nor the JAX package and uses no fixture of
tests/conftest.py, so on a machine without JAX it runs with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu_torch.ops import blend_cuda
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
from gaussctrl_exp_tpu_torch.ops.blend import T_EPS, blend_vjp_plain, rasterize_tiles_plain
from gaussctrl_exp_tpu_torch.ops.projection import BLOCK, project_gaussians


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the blend kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, n=400, H=60, W=76, n_chan=4, seed=0, cull=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 2.5)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    opacs = rng.uniform(0.2, 0.95, size=n).astype(np.float32)
    t = {k: torch.as_tensor(v, device=device) for k, v in
         dict(means=means, scales=scales, quats=quats, colors=colors, opacs=opacs).items()}
    cam = make_camera(look_at([0.0, -4.0, 0.0], np.zeros(3)), 80.0, 80.0, W / 2, H / 2, W, H, device=device)
    vm, _, fm = camera_matrices(cam)
    keep = torch.arange(n, device=device) >= cull
    proj = project_gaussians(t["means"], t["scales"], 1.0, t["quats"], vm, fm,
                             cam.fx, cam.fy, cam.cx, cam.cy, H, W, extra_mask=keep, opacities=t["opacs"])
    bins = bin_gaussians(proj, (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK)
    chan = torch.cat([t["colors"], proj.depths[:, None]], -1)[:, :n_chan].contiguous()
    return (proj.xys, proj.conics, chan, t["opacs"]), bins, H, W


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan,H,W", [(3, 64, 64), (4, 64, 64), (4, 60, 76), (8, 44, 60)])
def test_kernel_matches_plain(cuda_device, n_chan, H, W):
    args, bins, H, W = _inputs(cuda_device, H=H, W=W, n_chan=n_chan)
    before = blend_cuda.launches
    got = blend_cuda.rasterize_tiles(*args, bins, H, W)
    torch.cuda.synchronize()
    assert blend_cuda.launches == before + 1
    want = rasterize_tiles_plain(*args, bins, H, W)
    # sigma and alpha round as in the plain version (nvcc -fmad=false); only
    # the transmittance differs, a serial product against a cumprod, ~1e-6
    torch.testing.assert_close(got.img, want.img, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.final_T, want.final_T, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_empty_scene(cuda_device):
    (xys, conics, chan, opacs), bins, H, W = _inputs(cuda_device)
    got = blend_cuda.rasterize_tiles(xys, conics, chan, torch.zeros_like(opacs), bins, H, W)
    assert bins.n_isects > 0
    assert torch.equal(got.img, torch.zeros_like(got.img))
    assert torch.equal(got.final_T, torch.ones_like(got.final_T))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    (xys, conics, chan, opacs), bins, H, W = _inputs(cuda_device)
    with pytest.raises(ValueError):
        blend_cuda.rasterize_tiles(xys, conics, chan.repeat(1, 3), opacs, bins, H, W)  # C = 12
    with pytest.raises(TypeError):
        blend_cuda.rasterize_tiles(xys.double(), conics, chan, opacs, bins, H, W)
    with pytest.raises(ValueError):
        blend_cuda.rasterize_tiles(xys, conics.t().contiguous().t(), chan, opacs, bins, H, W)


def _cotangents(fwd, ref, seed=0):
    """Random cotangents, zero at pixels whose final T lies within 0.1% of
    the 1e-4 stop in either forward: there the two versions may stop one
    gaussian apart, and a zero cotangent removes the pixel from every
    gradient in both."""
    gen = torch.Generator(device=fwd.img.device).manual_seed(seed)
    g_img = torch.randn(fwd.img.shape, generator=gen, device=fwd.img.device)
    g_T = torch.randn(fwd.final_T.shape, generator=gen, device=fwd.img.device)
    band = 1e-3 * T_EPS
    flip = ((fwd.final_T - T_EPS).abs() <= band) | ((ref.final_T - T_EPS).abs() <= band)
    return g_img * ~flip[..., None], g_T * ~flip


def _check_backward(args, bins, H, W):
    fwd = blend_cuda.blend_forward(*args, bins, H, W)
    ref = rasterize_tiles_plain(*args, bins, H, W)
    g_img, g_T = _cotangents(fwd, ref)
    before = blend_cuda.bwd_launches
    got = blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T, H, W)
    torch.cuda.synchronize()
    assert blend_cuda.bwd_launches == before + 1
    want = blend_vjp_plain(*args, bins, g_img, g_T, H, W)
    # the same pairs on both sides (-fmad=false); the kernel forms
    # suffix = img·g − prefix where the plain VJP takes a reverse cumulative
    # sum, and its atomics add in a changing order: ~1e-6 of each field's
    # largest entry, held to 1e-4
    for name, a, b in zip(("xys", "conics", "colors", "opacs"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(float(b.abs().max()), 1e-6), msg=name)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan", [3, 4, 8])
@pytest.mark.parametrize("H,W", [(64, 64), (60, 76), (44, 60)])
def test_backward_kernel_matches_plain_vjp(cuda_device, n_chan, H, W):
    args, bins, H, W = _inputs(cuda_device, H=H, W=W, n_chan=n_chan)
    got = _check_backward(args, bins, H, W)
    assert float(got[3].abs().max()) > 0


@pytest.mark.cuda
def test_backward_kernel_zero_opacity(cuda_device):
    (xys, conics, chan, opacs), bins, H, W = _inputs(cuda_device)
    got = _check_backward((xys, conics, chan, torch.zeros_like(opacs)), bins, H, W)
    assert all(not g.any() for g in got)


@pytest.mark.cuda
def test_backward_kernel_leading_gaussians_culled(cuda_device):
    """Gaussians 0..9 behind the camera: the first visible one keeps its
    whole gradient (the lost first slot of the TPU reduction does not come
    across), and the culled ones get none."""
    args, bins, H, W = _inputs(cuda_device, cull=10)
    assert not bool((bins.gid < 10).any())
    got = _check_backward(args, bins, H, W)
    assert all(not g[:10].any() for g in got)
    first = int(bins.gid.min())
    assert float(got[2][first].abs().max()) > 0


@pytest.mark.cuda
def test_backward_through_render_model_counts_one_launch_each(cuda_device):
    from gaussctrl_exp_tpu_torch.models.gaussians import init_random
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model

    gs = init_random(300, sh_degree=1, seed=3, extent=1.0, device=cuda_device)
    params = gs.params
    for name in ("means", "features_dc", "opacities"):
        getattr(params, name).requires_grad_()
    cam = make_camera(look_at([0.0, -3.0, 0.5], np.zeros(3)), 60.0, 60.0, 32.0, 24.0, 64, 48, device=cuda_device)
    off = torch.zeros((params.capacity, 2), device=cuda_device, requires_grad=True)
    fwd, bwd = blend_cuda.launches, blend_cuda.bwd_launches
    out = render_model(gs, cam, 0, SplatModelConfig(sh_degree=1), training=True, xys_offset=off)
    out.rgb.square().mean().backward()
    torch.cuda.synchronize()
    assert (blend_cuda.launches - fwd, blend_cuda.bwd_launches - bwd) == (1, 1)
    for t in (params.means.grad, params.features_dc.grad, params.opacities.grad, off.grad):
        assert t is not None and bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0


@pytest.mark.cuda
def test_backward_kernel_refuses_what_it_does_not_take(cuda_device):
    args, bins, H, W = _inputs(cuda_device)
    fwd = blend_cuda.blend_forward(*args, bins, H, W)
    g_img, g_T = torch.ones_like(fwd.img), torch.ones_like(fwd.final_T)
    res = (fwd.img, fwd.final_T, g_img, g_T)
    with pytest.raises(TypeError):  # dtype
        blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img.double(), g_T, H, W)
    with pytest.raises(ValueError):  # shape
        blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T[:-1], H, W)
    with pytest.raises(ValueError):  # contiguity
        blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img.transpose(0, 1).contiguous().transpose(0, 1), g_T, H, W)
    xys, conics, chan, opacs = args
    with pytest.raises(TypeError):
        blend_cuda.blend_backward(xys.double(), conics, chan, opacs, bins, *res, H, W)
