"""Kernel B1 (the CUDA tile blend) against its plain PyTorch version.

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
from gaussctrl_exp_tpu_torch.ops.blend import rasterize_tiles_plain
from gaussctrl_exp_tpu_torch.ops.projection import BLOCK, project_gaussians


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the blend kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, n=400, H=60, W=76, n_chan=4, seed=0):
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
    proj = project_gaussians(t["means"], t["scales"], 1.0, t["quats"], vm, fm,
                             cam.fx, cam.fy, cam.cx, cam.cy, H, W, opacities=t["opacs"])
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
    with pytest.raises(NotImplementedError):
        blend_cuda.rasterize_tiles(xys.clone().requires_grad_(), conics, chan, opacs, bins, H, W)
    with pytest.raises(ValueError):
        blend_cuda.rasterize_tiles(xys, conics, chan.repeat(1, 3), opacs, bins, H, W)  # C = 12
    with pytest.raises(TypeError):
        blend_cuda.rasterize_tiles(xys.double(), conics, chan, opacs, bins, H, W)
    with pytest.raises(ValueError):
        blend_cuda.rasterize_tiles(xys, conics.t().contiguous().t(), chan, opacs, bins, H, W)
