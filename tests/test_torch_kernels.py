"""Kernels B1 and B2 (the CUDA tile blend and its backward), B3 (the
flash-attention forward), B3a (AttnAlign's self-attention), E1 (the depth
generator's epipolar term), B4, B5 (B3's backward), B1v (the blend-forward
ablations) and N1 (the NHWC GroupNorm + SiLU) against their plain PyTorch
versions; and the CUDA graph of the edit path's channels-last ControlNet +
UNet evaluation against its eager calls.

Needs an NVIDIA card and nvcc; without a card every test here skips, but
for two host tests of the card machine's toolchain: the data loader's native
libraries build with its g++, and the eval writer's PNG (Pillow) round-trips
at 512². The file imports neither JAX nor the JAX package and uses no
fixture of tests/conftest.py, so on a machine without JAX it runs with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu_torch.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu_torch.ops import blend_cuda
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians
from gaussctrl_exp_tpu_torch.ops.blend import T_EPS, blend_vjp_plain, rasterize_tiles_plain, tile_pairs
from gaussctrl_exp_tpu_torch.ops.projection import BLOCK, project_gaussians
from torch_blend_scenes import screen_scene


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


# --------------------------------------- B1 and B2 at the edges of their design


def _check_forward(args, bins, H, W):
    """B1 against the plain version, as chip_smoke.py's phase 3 holds it: off
    the stop band (final T within 0.1% of 1e-4 in either) elementwise within
    1e-5 + 1e-4 of the plain value (1e-6 + 1e-4 for T); on it within one
    gaussian's weight at the stop."""
    got = blend_cuda.blend_forward(*args, bins, H, W)
    torch.cuda.synchronize()
    want = rasterize_tiles_plain(*args, bins, H, W)
    band = 1e-3 * T_EPS
    flip = ((got.final_T - T_EPS).abs() <= band) | ((want.final_T - T_EPS).abs() <= band)
    a_max = min(0.999, float(args[3].max()))
    w_max = T_EPS * (1 + 1e-3) * a_max / (1 - a_max) * max(float(args[2].abs().max()), 1.0)
    d_img, d_T = (got.img - want.img).abs(), (got.final_T - want.final_T).abs()
    assert bool(torch.where(flip[..., None], d_img <= w_max, d_img <= 1e-5 + 1e-4 * want.img.abs()).all())
    assert bool(torch.where(flip, d_T <= w_max, d_T <= 1e-6 + 1e-4 * want.final_T.abs()).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan", range(1, 9))
def test_blend_kernels_over_several_batches_to_the_list_end(cuda_device, n_chan):
    """Tiles of 929-1983 gaussians at opacities 0.005-0.03: every pixel walks
    its whole list, over 4 to 8 batches of 256, in both kernels."""
    args, bins, H, W = screen_scene(cuda_device, n=2500, H=48, W=48, n_chan=n_chan, opacity=(0.005, 0.03))
    assert int(bins.tile_cnt.min()) > 3 * 256
    out = _check_forward(args, bins, H, W)
    assert float(out.final_T.min()) > 1e-2  # no pixel stops
    got = _check_backward(args, bins, H, W)
    assert all(bool(g.abs().max() > 0) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan", [3, 4])
def test_blend_kernels_with_one_tile_far_heavier_than_the_rest(cuda_device, n_chan):
    """2,000 small gaussians within 2 px of one point: one tile's list is
    over 2,000 long, the median under 100."""
    args, bins, H, W = screen_scene(cuda_device, n=2400, H=64, W=96, n_chan=n_chan, cluster=(2000, 40.0, 24.0),
                                    sd=(1.0, 3.0))
    cnt = bins.tile_cnt.float()
    assert float(cnt.max()) > 2000 and float(cnt.median()) < 100
    _check_forward(args, bins, H, W)
    _check_backward(args, bins, H, W)


@pytest.mark.cuda
def test_blend_kernels_when_every_pixel_stops_in_the_first_batch(cuda_device):
    """Six 200-px-wide gaussians at opacity 0.995 in front of lists of
    420-916: every pixel stops within them (alpha > 0.9 each, so T < 1e-4
    after four), the CTAs leave after the first of several batches, and no
    gaussian behind them gets a gradient."""
    args, bins, H, W = screen_scene(cuda_device, n=1500, H=48, W=64, front=(6, 0.995), opacity=(0.5, 0.9))
    assert int(bins.tile_cnt.min()) > 256
    walked, _, _ = tile_pairs(args[0], args[1], args[3], bins, H, W)
    assert int(walked.max()) <= 6 * BLOCK * BLOCK
    _check_forward(args, bins, H, W)
    got = _check_backward(args, bins, H, W)
    assert all(not g[6:].any() for g in got) and bool(got[3][:6].abs().max() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan", [3, 4])
def test_blend_kernels_with_thin_gaussians(cuda_device, n_chan):
    """Correlations up to |rho| = 0.99975 (1 - rho² down to 5e-4): the
    footprint boxes of thin gaussians, where sigma's rounding is widest, and
    past the box's cutoff (1 - rho² < 1e-3, the box is everything)."""
    args, bins, H, W = screen_scene(cuda_device, n=1500, H=64, W=64, n_chan=n_chan, sd=(0.6, 5.0),
                                    rho=(-0.99975, 0.99975), seed=5)
    _check_forward(args, bins, H, W)
    _check_backward(args, bins, H, W)


def _repeat_scene(device):
    return screen_scene(device, n=2500, H=64, W=64, opacity=(0.05, 0.6), seed=3)


@pytest.mark.cuda
def test_blend_forward_repeats_bit_for_bit(cuda_device):
    args, bins, H, W = _repeat_scene(cuda_device)
    a = blend_cuda.blend_forward(*args, bins, H, W)
    b = blend_cuda.blend_forward(*args, bins, H, W)
    assert torch.equal(a.img, b.img) and torch.equal(a.final_T, b.final_T)


@pytest.mark.cuda
def test_blend_backward_repeats_within_its_atomics_tolerance(cuda_device):
    """Only the order of B2's atomic sums changes between two runs: each
    field within 1e-4 of its largest entry, as against the plain VJP."""
    args, bins, H, W = _repeat_scene(cuda_device)
    fwd = blend_cuda.blend_forward(*args, bins, H, W)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g_img = torch.randn(fwd.img.shape, generator=gen, device=cuda_device)
    g_T = torch.randn(fwd.final_T.shape, generator=gen, device=cuda_device)
    first = blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T, H, W)
    second = blend_cuda.blend_backward(*args, bins, fwd.img, fwd.final_T, g_img, g_T, H, W)
    for name, a, b in zip(("xys", "conics", "colors", "opacs"), first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(float(a.abs().max()), 1e-6), msg=name)


# ---------------------------------------------------------------- kernel B3

def _qkv(device, dtype, B, H, S, T, D, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda L: torch.randn((B, H, L, D), generator=gen).to(device=device, dtype=dtype)
    return mk(S), mk(T), mk(T)


def _check_flash(q, k, v):
    """B3 against sdpa_plain in fp32 on the upcast inputs. bf16: the output is
    rounded to bf16 (2^-8 relative) and so are the probabilities before P·V,
    so max |d| ≤ 1e-2·max|plain| and relative L2 ≤ 5e-3; fp32: the same sums
    in another order, relative L2 ≤ 1e-5."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    before = attention_cuda.launches
    got = attention_cuda.flash_attn(q, k, v)
    torch.cuda.synchronize()
    assert attention_cuda.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    want = attention_cuda.sdpa_plain(q.float(), k.float(), v.float())
    d = got.float() - want
    rel = float(d.norm() / want.norm())
    if q.dtype == torch.bfloat16:
        assert float(d.abs().max()) <= 1e-2 * float(want.abs().max()), float(d.abs().max())
        assert rel <= 5e-3, rel
    else:
        assert rel <= 1e-5, rel
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 40, 80, 160])
@pytest.mark.parametrize("S,T", [(256, 256), (200, 77), (100, 130)])
def test_flash_attn_matches_plain(cuda_device, dtype, D, S, T):
    _check_flash(*_qkv(cuda_device, dtype, 2, 3, S, T, D, seed=D + S))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_strided_heads(cuda_device, dtype):
    """The head split's transposed view (B, S, H, D) → (B, H, S, D) goes in
    without a copy and gives what the contiguous tensors give."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    B, H, S, T, D = 2, 4, 96, 77, 24
    gen = torch.Generator(device="cpu").manual_seed(5)
    mk = lambda L: torch.randn((B, L, H * D), generator=gen).to(cuda_device, dtype).view(B, L, H, D).transpose(1, 2)
    q, k, v = mk(S), mk(T), mk(T)
    assert not q.is_contiguous()
    copies = attention_cuda.copies
    got = _check_flash(q, k, v)
    assert attention_cuda.copies == copies
    torch.testing.assert_close(got, attention_cuda.flash_attn(q.contiguous(), k.contiguous(), v.contiguous()),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attn_broadcast_reference(cuda_device):
    """The cross-view processor's reference call: every view of a CFG group
    attends to reference view r's keys and values."""
    B, H, S, D = 10, 2, 64, 40
    q, k, v = _qkv(cuda_device, torch.bfloat16, B, H, S, S, D, seed=9)
    kg, vg = k.reshape(2, 5, H, S, D), v.reshape(2, 5, H, S, D)
    k_r = kg[:, 1:2].expand(kg.shape).reshape(B, H, S, D)
    v_r = vg[:, 1:2].expand(vg.shape).reshape(B, H, S, D)
    _check_flash(q, k_r, v_r)


@pytest.mark.cuda
def test_flash_attn_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 32, 32, 40)
    with pytest.raises(ValueError):  # D not a multiple of 8
        attention_cuda.flash_attn(q[..., :36], k[..., :36], v[..., :36])
    big = _qkv(cuda_device, torch.bfloat16, 1, 1, 8, 8, 168)
    with pytest.raises(ValueError):  # D over 160
        attention_cuda.flash_attn(*big)
    with pytest.raises(ValueError):  # a CPU tensor
        attention_cuda.flash_attn(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(TypeError):  # mixed types
        attention_cuda.flash_attn(q, k.float(), v)
    with pytest.raises(TypeError):  # fp16
        attention_cuda.flash_attn(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # k and v disagree
        attention_cuda.flash_attn(q, k, v[:, :, :16])


# B3's bf16 tiling: 128 query rows a CTA at D ≤ 80 (64 above), key tiles of 64
# at D ≤ 40 (32 above), head widths rounded up to 16, 32, 40, 48, 64, 80, 96,
# 128 or 160 with the columns past D zero-filled
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 127, 128, 129, 255])
@pytest.mark.parametrize("T", [1, 77, 129])
def test_flash_attn_tile_edges(cuda_device, S, T):
    _check_flash(*_qkv(cuda_device, torch.bfloat16, 2, 3, S, T, 40, seed=S * 1000 + T))
    _check_flash(*_qkv(cuda_device, torch.bfloat16, 1, 2, S, T, 80, seed=S * 1000 + T + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 24, 40, 48, 80, 128, 160])
def test_flash_attn_head_widths(cuda_device, D):
    """Every width template, against sdpa_plain; the output bits do not
    depend on the log-sum-exp, and two runs give the same bits."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 200, 130, D, seed=D)
    got = _check_flash(q, k, v)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    assert torch.equal(out, got)
    assert torch.equal(attention_cuda.flash_attn(q, k, v), got)
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5, dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_flash_attn_large_batch_heads(cuda_device):
    """B·H = 65,520 (the grid's y dimension holds at most 65,535)."""
    _check_flash(*_qkv(cuda_device, torch.bfloat16, 4095, 16, 9, 11, 40, seed=3))


@pytest.mark.cuda
def test_flash_attn_misaligned_input_is_copied(cuda_device):
    """A contiguous bf16 view 8 bytes past a 16-byte boundary is copied to an
    aligned tensor and counted, not read in place (cp.async takes 16-byte
    aligned rows)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 100, 77, 40, seed=4)
    flat = torch.zeros(k.numel() + 4, dtype=k.dtype, device=cuda_device)
    k_off = flat[4:].view(k.shape)
    k_off.copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 8
    copies = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        got = _check_flash(q, k_off, v)
    assert attention_cuda.copies == copies + 1
    torch.testing.assert_close(got, attention_cuda.flash_attn(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attn_repeats_bit_for_bit(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 3, 8, 1024, 1024, 40, seed=12)
    first = attention_cuda.flash_attn(q, k, v, return_lse=True)
    second = attention_cuda.flash_attn(q, k, v, return_lse=True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# B3's fp32 tiling (3×TF32 on the tensor cores): 128 query rows a CTA (32 a
# warp) at D ≤ 48, 64 above; ring tiles of 32 keys (D ≤ 48), 16 (D ≤ 96) or
# 8; widths rounded up to 8…48, 64, 80, 96, 128 or 160 with the columns past
# D zero-filled
F32_WIDTHS = [8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 160]


@pytest.mark.cuda
@pytest.mark.parametrize("D", F32_WIDTHS)
def test_flash_attn_f32_head_widths(cuda_device, D):
    """Every fp32 width template against sdpa_plain (relative L2 ≤ 1e-5); the
    log-sum-exp within 1e-5 of that of the fp32 scores; the output bits do
    not depend on the log-sum-exp, and two runs give the same bits."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.float32, 2, 3, 200, 130, D, seed=D)
    got = _check_flash(q, k, v)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    again, lse_again = attention_cuda.flash_attn(q, k, v, return_lse=True)
    assert torch.equal(out, got) and torch.equal(again, got) and torch.equal(lse_again, lse)
    want = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5, dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 15, 16, 17, 33, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 31, 32, 33, 77])
def test_flash_attn_f32_tile_edges(cuda_device, S, T):
    """Query counts on each side of an mma block's 16 rows, a warp's 32 and
    a CTA's 64 or 128, key counts on each side of the ring tiles (32 keys at
    D = 40, 16 at 80, 8 at 160)."""
    for B, H, D, seed in ((2, 3, 40, S * 1000 + T), (1, 2, 80, S * 1000 + T + 1), (1, 2, 160, S * 1000 + T + 2)):
        _check_flash(*_qkv(cuda_device, torch.float32, B, H, S, T, D, seed=seed))


@pytest.mark.cuda
def test_flash_attn_f32_misaligned_input_is_copied(cuda_device):
    """A contiguous fp32 view 4 bytes past a 16-byte boundary is copied to an
    aligned tensor and counted (B3 copies fp32 rows 16 bytes at a time)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.float32, 2, 3, 100, 77, 40, seed=4)
    flat = torch.zeros(v.numel() + 1, dtype=v.dtype, device=cuda_device)
    v_off = flat[1:].view(v.shape)
    v_off.copy_(v)
    assert v_off.is_contiguous() and v_off.data_ptr() % 16 == 4
    copies = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        got = _check_flash(q, k, v_off)
    assert attention_cuda.copies == copies + 1
    torch.testing.assert_close(got, attention_cuda.flash_attn(q, k, v), rtol=0, atol=0)


# ---------------------------------------------------------------- kernel B3a

def _check_align(q, k, v, coeff, n_ref, groups):
    """B3a against align_attn_plain in fp32 on the upcast inputs, at B3's
    limits (bf16: max |d| ≤ 1e-2·max|plain|, relative L2 ≤ 5e-3; fp32:
    relative L2 ≤ 1e-5), one launch counted, K and V read in place."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    before, copies = attention_cuda.align_launches, attention_cuda.copies
    got = attention_cuda.flash_attn_align(q, k, v, coeff, n_ref, groups)
    torch.cuda.synchronize()
    assert attention_cuda.align_launches == before + 1 and attention_cuda.copies == copies
    assert got.shape == q.shape and got.dtype == q.dtype
    want = attention_cuda.align_attn_plain(q.float(), k.float(), v.float(), coeff, n_ref, groups)
    d = got.float() - want
    rel = float(d.norm() / want.norm())
    if q.dtype == torch.bfloat16:
        assert float(d.abs().max()) <= 1e-2 * float(want.abs().max()), float(d.abs().max())
        assert rel <= 5e-3, rel
    else:
        assert rel <= 1e-5, rel
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 40, 80, 160])
@pytest.mark.parametrize("views,n_ref,groups,S", [(9, 4, 2, 256), (5, 4, 2, 200), (7, 1, 1, 130), (3, 3, 2, 65)])
def test_flash_attn_align_matches_plain(cuda_device, dtype, D, views, n_ref, groups, S):
    _check_align(*_qkv(cuda_device, dtype, groups * views, 2, S, S, D, seed=D + S + views), 0.6, n_ref, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 40, 80, 160])
def test_flash_attn_align_coefficient_one_is_b3(cuda_device, dtype, D):
    """Coefficient 1 weighs the reference passes 0: B3's output, bit for bit
    where B3a's tiles are B3's (all but bf16 D = 80, whose ring stages hold 16
    keys, not 32), else within B3's limits of it."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, dtype, 10, 2, 200, 200, D, seed=D)
    got = _check_align(q, k, v, 1.0, 4, 2)
    b3 = attention_cuda.flash_attn(q, k, v)
    if dtype == torch.bfloat16 and D == 80:
        assert float((got.float() - b3.float()).abs().max()) <= 1e-2 * float(b3.float().abs().max())
    else:
        assert torch.equal(got, b3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_align_strided_heads_and_repeats(cuda_device, dtype):
    """The head split's transposed views go in without a copy and give what
    the contiguous tensors give; two runs give the same bits."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    B, H, S, D = 18, 4, 96, 40
    gen = torch.Generator(device="cpu").manual_seed(6)
    mk = lambda: torch.randn((B, S, H * D), generator=gen).to(cuda_device, dtype).view(B, S, H, D).transpose(1, 2)
    q, k, v = mk(), mk(), mk()
    assert not q.is_contiguous()
    got = _check_align(q, k, v, 0.6, 4, 2)
    assert torch.equal(got, attention_cuda.flash_attn_align(q.contiguous(), k.contiguous(), v.contiguous(),
                                                            0.6, 4, 2))
    assert torch.equal(got, attention_cuda.flash_attn_align(q, k, v, 0.6, 4, 2))


@pytest.mark.cuda
def test_flash_attn_align_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 10, 2, 32, 32, 40)
    with pytest.raises(ValueError):  # no backward
        with torch.enable_grad():
            attention_cuda.flash_attn_align(q.requires_grad_(), k, v, 0.6, 4, 2)
    q.requires_grad_(False)
    with pytest.raises(ValueError):  # 10 is not 3 CFG groups
        attention_cuda.flash_attn_align(q, k, v, 0.6, 4, 3)
    with pytest.raises(ValueError):  # 6 references in groups of 5 views
        attention_cuda.flash_attn_align(q, k, v, 0.6, 6, 2)
    with pytest.raises(ValueError):  # a cross-attention
        attention_cuda.flash_attn_align(q, k[:, :, :16], v[:, :, :16], 0.6, 4, 2)
    with pytest.raises(TypeError):  # mixed types
        attention_cuda.flash_attn_align(q, k.float(), v, 0.6, 4, 2)


@pytest.mark.cuda
def test_cross_view_processor_launches_b3a_on_the_card(cuda_device, tracing):
    """AttnAlign's self-attention on CUDA tensors is one B3a launch, counted
    ``attn.align.fused``; its cross-attention one B3 launch."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import make_cross_view_processor
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 18, 2, 64, 64, 40, seed=2)
    ctx = _qkv(cuda_device, torch.bfloat16, 18, 2, 77, 77, 40, seed=3)[0]
    proc = make_cross_view_processor(0.6, 4)
    b3, b3a = attention_cuda.launches, attention_cuda.align_launches
    with torch.no_grad():
        got = proc(q, k, v, False)
        proc(q, ctx, ctx, True)
    assert (attention_cuda.launches - b3, attention_cuda.align_launches - b3a) == (1, 1)
    assert tracing.counters() == {"attn.align.fused": 1}
    assert torch.equal(got, attention_cuda.flash_attn_align(q, k, v, 0.6, 4, 2))


# ---------------------------------------------------------------- kernel E1

E1_V = 4  # views a CFG group
# the depth generator's four mixing self-attentions (S, D) at 8 heads, CFG batch 8
E1_SHAPES = [(4096, 40), (1024, 80), (256, 160), (64, 160)]
# non-unit weights, view 3 isolated, view 2 with one partner
E1_PARTIAL = np.array([[1, 0.5, 0, 2], [1, 1, 0.25, 0], [0, 3, 1, 0], [0, 0, 0, 1]], np.float32)


def _e1_inputs(device, dtype, S, D, B=2 * E1_V, H=8, seed=0):
    """q, k, v as the UNet hands them (its (B, S, H·D) projections split into
    heads: strided views), and random (V, V, S, 9) tables with dead taps."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda: torch.randn((B, S, H * D), generator=gen).to(device, dtype).view(B, S, H, D).transpose(1, 2)
    q, k, v = mk(), mk(), mk()
    idx = torch.randint(0, S, (E1_V, E1_V, S, 9), generator=gen)
    w = torch.rand((E1_V, E1_V, S, 9), generator=gen)
    w[w < 0.2] = 0.0
    return q, k, v, idx.to(device), w.to(device)


def _e1(q, k, v, out_self, idx, w, pm, mix):
    from gaussctrl_exp_tpu_torch.ops import epipolar_cuda

    return epipolar_cuda.epipolar_attn(q, k, v, out_self, *epipolar_cuda.convert_tables(idx, w),
                                       *epipolar_cuda.partner_plan(pm, q.device), mix)


def _check_e1(q, k, v, idx, w, pair_mask=None, mix=0.5):
    """E1 on B3's self-attention against the plain composition in fp32 on the
    upcast inputs and the same self-attention, at B3's limits (bf16: max |d|
    ≤ 1e-2·max|plain|, relative L2 ≤ 5e-3; fp32: relative L2 ≤ 1e-5), one
    launch counted, nothing copied. Returns E1's output, the plain one and the
    pair mask."""
    from gaussctrl_exp_tpu_torch.diffusion.correspondence import epipolar_mix_plain
    from gaussctrl_exp_tpu_torch.ops import attention_cuda, epipolar_cuda

    pm = (np.ones((E1_V, E1_V)) if pair_mask is None else pair_mask) * (1.0 - np.eye(E1_V))
    out_self = attention_cuda.flash_attn(q, k, v)
    before, copies = epipolar_cuda.launches, attention_cuda.copies
    got = _e1(q, k, v, out_self, idx, w, pm, mix)
    torch.cuda.synchronize()
    assert epipolar_cuda.launches == before + 1 and attention_cuda.copies == copies
    assert got.shape == q.shape and got.dtype == q.dtype
    want = epipolar_mix_plain(q.float(), k.float(), v.float(), out_self.float(), idx, w, pm, mix)
    d = got.float() - want
    rel = float(d.norm() / want.norm())
    if q.dtype == torch.bfloat16:
        assert float(d.abs().max()) <= 1e-2 * float(want.abs().max()), float(d.abs().max())
        assert rel <= 5e-3, rel
    else:
        assert rel <= 1e-5, rel
    return got, want, pm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D", E1_SHAPES)
def test_epipolar_attn_matches_plain(cuda_device, dtype, S, D):
    _check_e1(*_e1_inputs(cuda_device, dtype, S, D, seed=S + D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mix", [0.5, 0.3])
def test_epipolar_attn_partial_pair_mask_and_isolated_view(cuda_device, dtype, mix):
    """Non-unit pair weights over one and two partners; the isolated view's
    rows are the plain version's bits (its three roundings of the mix of the
    self-attention with itself)."""
    got, want, pm = _check_e1(*_e1_inputs(cuda_device, dtype, 1024, 80, seed=11), E1_PARTIAL, mix)
    alone = [bi for bi in range(2 * E1_V) if not pm[bi % E1_V].any()]
    assert alone == [3, 7]
    assert torch.equal(got[alone], want[alone].to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epipolar_attn_strided_heads_and_repeats(cuda_device, dtype):
    """The UNet's head-split views go in without a copy and give what
    contiguous tensors give; two runs give the same bits."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v, idx, w = _e1_inputs(cuda_device, dtype, 256, 160, seed=5)
    assert not q.is_contiguous()
    got, _, pm = _check_e1(q, k, v, idx, w, E1_PARTIAL)
    out_self = attention_cuda.flash_attn(q, k, v)
    assert torch.equal(got, _e1(q.contiguous(), k.contiguous(), v.contiguous(), out_self.contiguous(), idx, w, pm,
                                0.5))
    assert torch.equal(got, _e1(q, k, v, out_self, idx, w, pm, 0.5))


@pytest.mark.cuda
def test_epipolar_attn_misaligned_input_is_copied(cuda_device):
    """A value tensor 4 bytes past a 16-byte boundary is copied to an aligned
    tensor and counted, not read in place (E1 loads 16 bytes at a time)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v, idx, w = _e1_inputs(cuda_device, torch.float32, 256, 40, seed=9)
    flat = torch.zeros(v.numel() + 1, dtype=v.dtype, device=cuda_device)
    v_off = flat[1:].view(v.shape)
    v_off.copy_(v)
    assert v_off.data_ptr() % 16 == 4
    pm = np.ones((E1_V, E1_V)) - np.eye(E1_V)
    out_self = attention_cuda.flash_attn(q, k, v)
    copies = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        got = _e1(q, k, v_off, out_self, idx, w, pm, 0.5)
    assert attention_cuda.copies == copies + 1
    assert torch.equal(got, _e1(q, k, v, out_self, idx, w, pm, 0.5))


@pytest.mark.cuda
def test_epipolar_attn_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda, epipolar_cuda

    q, k, v, idx, w = _e1_inputs(cuda_device, torch.float32, 64, 40)
    pm = np.ones((E1_V, E1_V)) - np.eye(E1_V)
    out_self = attention_cuda.flash_attn(q, k, v)
    with pytest.raises(ValueError):  # no backward
        with torch.enable_grad():
            _e1(q.detach().requires_grad_(), k, v, out_self, idx, w, pm, 0.5)
    with pytest.raises(ValueError):  # 8 rows are not CFG groups of 3 views
        _e1(q, k, v, out_self, idx[:3, :3], w[:3, :3], pm[:3, :3], 0.5)
    with pytest.raises(ValueError):  # int64 indices: the tables were not converted
        epipolar_cuda.epipolar_attn(q, k, v, out_self, idx, torch.log(w.clamp(min=1e-12)),
                                    *epipolar_cuda.partner_plan(pm, q.device), 0.5)
    with pytest.raises(ValueError):  # mixed types
        _e1(q, k.to(torch.bfloat16), v, out_self, idx, w, pm, 0.5)
    with pytest.raises(ValueError):  # a head width that is not a multiple of 8
        q12, k12, v12, idx12, w12 = _e1_inputs(cuda_device, torch.float32, 64, 12)
        _e1(q12, k12, v12, q12, idx12, w12, pm, 0.5)


@pytest.mark.cuda
def test_epipolar_processor_takes_e1_on_the_card(cuda_device, tracing):
    """The generator's processor on CUDA tensors takes E1, one launch counted
    ``attn.epipolar.fused``; a call that autograd records takes the plain
    composition, counted ``attn.epipolar.split``, and agrees with E1."""
    from gaussctrl_exp_tpu_torch.diffusion.correspondence import make_multires_epipolar_processor
    from gaussctrl_exp_tpu_torch.ops import epipolar_cuda

    S, D = 1024, 80
    q, k, v, idx, w = _e1_inputs(cuda_device, torch.float32, S, D, seed=3)
    proc = make_multires_epipolar_processor({S: (idx, w)}, mix=0.5, pair_mask=E1_PARTIAL)
    before = epipolar_cuda.launches
    with torch.no_grad():
        fused = proc(q, k, v, False)
    assert epipolar_cuda.launches == before + 1
    assert tracing.counters()["attn.epipolar.fused"] == 1 and "attn.epipolar.split" not in tracing.counters()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        split = proc(*leaves, False)
    assert epipolar_cuda.launches == before + 1 and split.requires_grad
    assert tracing.counters()["attn.epipolar.split"] == 1
    assert float((split.detach() - fused).norm() / split.detach().norm()) <= 1e-5


# ------------------------------------------------------- kernels B4 and B5

# B4/B5 against autograd through sdpa_plain in fp32 on the upcast inputs and
# cotangent, relative L2 per gradient. fp32: the same sums in another order
# (expected ~1e-6); bf16: the inputs' gradients are rounded to bf16, and so
# are P and dS before their products, as the forward rounds P (expected
# 3-6e-3)
BWD_F32_REL_L2, BWD_BF16_REL_L2 = 1e-5, 1.5e-2


def _check_grads(q, k, v, seed=0):
    """FlashAttnFunction's gradients against autograd through sdpa_plain in
    fp32; returns them."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    gen = torch.Generator(device="cpu").manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen).to(q.device, q.dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (attention_cuda.launches, attention_cuda.dkv_launches, attention_cuda.dq_launches)
    out = attention_cuda.FlashAttnFunction.apply(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    after = (attention_cuda.launches, attention_cuda.dkv_launches, attention_cuda.dq_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_cuda.sdpa_plain(*ref), ref, dout.float())
    limit = BWD_BF16_REL_L2 if q.dtype == torch.bfloat16 else BWD_F32_REL_L2
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= limit, (name, rel)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 40, 80, 160])
@pytest.mark.parametrize("S,T", [(256, 256), (200, 77), (100, 130)])
def test_flash_backward_matches_plain(cuda_device, dtype, D, S, T):
    _check_grads(*_qkv(cuda_device, dtype, 2, 3, S, T, D, seed=D + S), seed=D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80), (4, 8, 256, 256, 160),
                                   (4, 8, 64, 64, 160), (4, 8, 4096, 77, 40), (4, 8, 1024, 77, 80),
                                   (4, 8, 256, 77, 160), (2, 3, 100, 77, 24)])
def test_flash_backward_at_the_depth_generator_shapes(cuda_device, dtype, shape):
    """The self- and cross-attention shapes of the depth generator's training
    step (4 views, 64² latents), and a ragged one."""
    B, H, S, T, D = shape
    _check_grads(*_qkv(cuda_device, dtype, B, H, S, T, D, seed=S + T), seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_strided_heads(cuda_device, dtype):
    """Head-split views in, gradients laid out (B, L, H, D) out, no copy."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    B, H, S, T, D = 2, 4, 96, 77, 24
    gen = torch.Generator(device="cpu").manual_seed(6)
    mk = lambda L: torch.randn((B, L, H * D), generator=gen).to(cuda_device, dtype).view(B, L, H, D).transpose(1, 2)
    q, k, v = mk(S), mk(T), mk(T)
    copies = attention_cuda.copies
    got = _check_grads(q, k, v)
    assert attention_cuda.copies == copies
    for g in got:
        assert g.transpose(1, 2).is_contiguous()
    cont = _check_grads(q.contiguous(), k.contiguous(), v.contiguous())
    for a, b in zip(got, cont):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_repeats_bit_for_bit(cuda_device, dtype):
    first = _check_grads(*_qkv(cuda_device, dtype, 2, 3, 300, 200, 40, seed=3))
    second = _check_grads(*_qkv(cuda_device, dtype, 2, 3, 300, 200, 40, seed=3))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [40, 160])
def test_flash_lse_leaves_the_output_alone(cuda_device, dtype, D):
    """B3 writes the same output bits with and without the log-sum-exp, and
    the log-sum-exp is that of the scaled scores."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, dtype, 2, 3, 200, 77, D, seed=D)
    plain_out = attention_cuda.flash_attn(q, k, v)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    assert torch.equal(out, plain_out)
    assert lse.shape == (2, 3, 200) and lse.dtype == torch.float32 and lse.is_contiguous()
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5, dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sdpa_keeps_the_gradient_on_the_card(cuda_device, dtype):
    """diffusion.attention._sdpa on CUDA inputs that require grad records the
    kernels for autograd, and its gradients are the plain ones; without grad
    it launches B3 alone."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import _sdpa
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = (t.requires_grad_() for t in _qkv(cuda_device, dtype, 2, 2, 128, 128, 40, seed=4))
    out = _sdpa(q, k, v)
    assert out.requires_grad and out.grad_fn is not None
    dkv, dq = attention_cuda.dkv_launches, attention_cuda.dq_launches
    out.float().square().sum().backward()
    assert (attention_cuda.dkv_launches - dkv, attention_cuda.dq_launches - dq) == (1, 1)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    attention_cuda.sdpa_plain(*ref).square().sum().backward()
    limit = BWD_BF16_REL_L2 if dtype == torch.bfloat16 else BWD_F32_REL_L2
    for t, r in zip((q, k, v), ref):
        assert float((t.grad.float() - r.grad).norm() / r.grad.norm()) <= limit
    with torch.no_grad():
        assert not _sdpa(q, k, v).requires_grad
    assert not _sdpa(q.detach(), k.detach(), v.detach()).requires_grad


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.float32, 1, 2, 32, 32, 40)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    with pytest.raises(ValueError):  # lse of the wrong shape
        attention_cuda.flash_attn_bwd_dq(q, k, v, out, lse[..., :16], out)
    with pytest.raises(ValueError):  # cotangent of the wrong type
        attention_cuda.flash_attn_bwd_dkv(q, k, v, out, lse, out.double())
    with pytest.raises(ValueError):  # CPU tensors
        attention_cuda.flash_attn_bwd_dq(q.cpu(), k.cpu(), v.cpu(), out.cpu(), lse.cpu(), out.cpu())


# fp32 B4/B5 (3×TF32 on the tensor cores): 64 keys a B4 CTA and 64 queries a
# B5 CTA, ring tiles of 32 (D ≤ 80) or 16 rows, widths rounded up to 8…48,
# 64, 80, 96, 128 or 160; B4 splits its queries over several CTAs
# where its key blocks are too few for the card (attention_cuda.dkv_splits,
# whose rule is in csrc/flash_attn_bwd.cu)


def _direct_grads(q, k, v, dout, splits=None):
    """(dq, dk, dv) from B3's output through the two wrappers, B4 split
    ``splits`` ways (by the rule when not given)."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    delta = attention_cuda.delta_of(out, dout)
    dk, dv = attention_cuda.flash_attn_bwd_dkv(q, k, v, out, lse, dout, delta, _splits=splits)
    return attention_cuda.flash_attn_bwd_dq(q, k, v, out, lse, dout, delta), dk, dv


def _plain_grads(q, k, v, dout):
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(attention_cuda.sdpa_plain(*ref), ref, dout.float())


def _assert_f32_grads(got, want, names=("dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        assert bool(torch.isfinite(g).all()), name
        rel = float((g - w).norm() / w.norm())
        assert rel <= BWD_F32_REL_L2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 24, 40, 48, 80, 128, 160])
def test_flash_backward_f32_head_widths(cuda_device, D):
    """Every fp32 width template against autograd through sdpa_plain, with
    and without the query split."""
    q, k, v = _qkv(cuda_device, torch.float32, 2, 3, 200, 130, D, seed=D)
    got = _check_grads(q, k, v, seed=D)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(D)).to(cuda_device)
    want = _plain_grads(q, k, v, dout)
    for splits in (1, 3):
        _assert_f32_grads(_direct_grads(q, k, v, dout, splits), want)
    assert all(g.dtype == torch.float32 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129])
def test_flash_backward_f32_tile_edges(cuda_device, S, T):
    """Query and key counts on each side of the CTA rows (64) and the ring
    tiles (32 at D = 40, 16 at D = 160). With one key, P = 1 and dP = dO·V =
    delta, so dQ and dK vanish but for rounding on both sides: there they
    are held to 1e-5 of dV's norm instead of their own."""
    for B, H, D, seed in ((2, 3, 40, S * 1000 + T), (1, 2, 160, S * 1000 + T + 1)):
        q, k, v = _qkv(cuda_device, torch.float32, B, H, S, T, D, seed=seed)
        if T > 1:
            _check_grads(q, k, v, seed=seed)
            continue
        dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(seed)).to(cuda_device)
        got, want = _direct_grads(q, k, v, dout), _plain_grads(q, k, v, dout)
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).norm()) <= BWD_F32_REL_L2 * float(want[2].norm())
        _assert_f32_grads(got[2:], want[2:], ("dv",))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 8, 4096, 77, 40),  # cross 64²: split 5 ways by the rule
    (4, 8, 256, 256, 160),  # self 16²: 3
    (32, 8, 100, 64, 40),  # 256 CTAs: just under the rule's 264, split 2 ways
    (33, 8, 100, 64, 40),  # 264 CTAs: not split
    (2, 3, 300, 200, 80),
])
def test_flash_backward_f32_query_split_matches_unsplit(cuda_device, shape):
    """B4 with its queries split (by the rule, and 2 or 7 ways) against the
    unsplit kernel and the plain gradients; the split sums its partials in a
    fixed order, so each split count repeats bit for bit."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    B, H, S, T, D = shape
    q, k, v = _qkv(cuda_device, torch.float32, B, H, S, T, D, seed=S + T)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(T)).to(cuda_device)
    want = _plain_grads(q, k, v, dout)
    rule = attention_cuda.dkv_splits(B, H, S, T, D,
                                     torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    one = _direct_grads(q, k, v, dout, 1)
    _assert_f32_grads(one, want)
    for splits in sorted({rule, 2, 7}):
        got = _direct_grads(q, k, v, dout, splits)
        _assert_f32_grads(got, want)
        assert torch.equal(got[0], one[0])  # dQ (B5) does not split
        for g, u in zip(got[1:], one[1:]):
            assert float((g - u).norm() / u.norm()) <= BWD_F32_REL_L2
        again = _direct_grads(q, k, v, dout, splits)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    sums = attention_cuda.dkv_sum_launches()
    auto = _direct_grads(q, k, v, dout)
    assert attention_cuda.dkv_sum_launches() == sums + (rule > 1)  # the second pass ran where the rule splits
    assert all(torch.equal(x, y) for x, y in zip(auto, _direct_grads(q, k, v, dout, rule)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,splits,bf16_splits", [
    ((4, 8, 4096, 4096, 40), 1, 1),  # self 64²: 64 · 32 = 2,048 CTAs (bf16: 32 · 32 = 1,024)
    ((4, 8, 1024, 1024, 80), 1, 1),  # self 32²: 512
    ((4, 8, 256, 256, 160), 3, 1),  # self 16²: 128 CTAs → 3 splits (384); bf16 at most one per 256 queries
    ((4, 8, 64, 64, 40), 1, 1),  # self 8²: 32 CTAs, but 64 queries
    ((4, 8, 64, 64, 160), 1, 1),
    ((4, 8, 4096, 77, 40), 5, 8),  # cross 64²: 64 CTAs → 5 splits (320); bf16 32 → 9, 64 tiles go 8 a split
    ((4, 8, 1024, 77, 80), 5, 4),  # bf16: 64 CTAs want 5; 16 ring tiles of 64 go 4 a split
    ((4, 8, 256, 77, 160), 4, 1),  # at most one split per 64 queries (bf16: 256)
    ((2, 3, 100, 77, 40), 2, 1),
    ((5, 7, 288, 77, 40), 3, 2),  # 70 CTAs want 4 splits; 9 ring tiles of 32 go 3 a split (bf16: 35 CTAs, 2)
    ((33, 8, 100, 64, 40), 1, 1),  # 264 CTAs: two an SM already
    ((32, 8, 100, 64, 40), 2, 1),  # 256: one short
])
def test_dkv_query_splits(cuda_device, shape, splits, bf16_splits):
    """B4 splits each key block's queries over more CTAs where its
    ceil(T / rows) · B · H CTAs give fewer than two for each of 132 SMs, at
    most one split per 64 queries in fp32 and per 256 in bf16. rows: 64 keys
    a CTA in fp32; in bf16 128 at D ≤ 48, else 64."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    assert attention_cuda.dkv_splits(*shape, sms=132) == splits
    assert attention_cuda.dkv_splits(*shape, sms=132, bf16=True) == bf16_splits
    assert attention_cuda._bwd_lib().gctorch_flash_attn_bwd_dkv_splits(*shape, 1, 132) == bf16_splits


@pytest.mark.cuda
def test_flash_backward_f32_split_repeats_bit_for_bit(cuda_device):
    """FlashAttnFunction at the cross-attention shape, where B4 splits."""
    first = _check_grads(*_qkv(cuda_device, torch.float32, 4, 8, 1024, 77, 40, seed=8), seed=2)
    second = _check_grads(*_qkv(cuda_device, torch.float32, 4, 8, 1024, 77, 40, seed=8), seed=2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_backward_f32_misaligned_input_is_copied(cuda_device):
    """A contiguous fp32 view 4 bytes past a 16-byte boundary is copied to an
    aligned tensor and counted (B4 and B5 copy fp32 rows 16 bytes at a time)
    and gives the aligned input's gradients."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.float32, 2, 3, 100, 77, 40, seed=4)
    flat = torch.zeros(k.numel() + 4, dtype=k.dtype, device=cuda_device)
    k_off = flat[1:-3].view(k.shape)
    k_off.copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 4
    dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(4)).to(cuda_device)
    want = _direct_grads(q, k, v, dout)
    out, lse = attention_cuda.flash_attn(q, k, v, return_lse=True)
    copies = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        dk, dv = attention_cuda.flash_attn_bwd_dkv(q, k_off, v, out, lse, dout)
    assert attention_cuda.copies == copies + 1
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


# ---------------------------------------------------------------- kernel B1v

def _check_variant(mode, args, bins, H, W):
    """B1v against its plain version on the same CUDA tensors, on every tile
    (both write the init where the TPU kernel leaves a tile undefined). The
    two round the transmittance apart (a serial sum or product against a
    cumsum or cumprod, ~1e-6), so off the band around the 1e-4 stop they
    agree to 1e-5 + 1e-4·|plain| with equal done flags; pixels in the band
    are left out and must be rare."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    table = V.bins_chunk_table(bins, H, W)
    before = V.launches[mode]
    got = V.blend_variant(mode, *args, bins, H, W, table=table)
    torch.cuda.synchronize()
    assert V.launches[mode] == before + 1
    assert got.shape == (table.num_tiles, 256, 16)
    run = V.variant_plain_run(mode, *args, bins, H, W, table=table)
    keep = ~run.band
    assert int(run.band.sum()) <= run.band.numel() // 200
    want = run.out
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-4, atol=1e-5)
    assert torch.equal(got[keep][:, V.COL_DONE], want[keep][:, V.COL_DONE])
    return got, table


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["base", "empty", "notrans", "nomatmul", "scan", "pair"])
@pytest.mark.parametrize("n,n_chan,H,W", [(400, 4, 64, 64), (400, 3, 60, 76), (400, 8, 44, 60), (2500, 4, 64, 80)])
def test_variant_kernel_matches_plain(cuda_device, mode, n, n_chan, H, W):
    args, bins, H, W = _inputs(cuda_device, n=n, H=H, W=W, n_chan=n_chan)
    _check_variant(mode, args, bins, H, W)


@pytest.mark.cuda
def test_variant_base_matches_blend_kernel(cuda_device):
    """``base`` carries T from chunk to chunk as B1 does: the same image."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    args, bins, H, W = _inputs(cuda_device, n=2500, H=64, W=80)
    assert int(bins.tile_cnt.max()) > V.CHUNK
    got, _ = _check_variant("base", args, bins, H, W)
    img, T = V.tiles_to_image(got, H, W, 4)
    want = blend_cuda.blend_forward(*args, bins, H, W)
    torch.testing.assert_close(img, want.img, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(T, want.final_T, rtol=1e-4, atol=1e-6)


VARIANT_MODES = ["base", "empty", "notrans", "nomatmul", "scan", "pair"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", VARIANT_MODES)
@pytest.mark.parametrize("n_chan", range(1, 9))
def test_variant_kernel_every_channel_count(cuda_device, mode, n_chan):
    """Tiles of several 256-slot batches (so both chunks of a batch and the
    chunk boundary inside it), most pixels stopping after a few chunks, at
    C = 1 to 8."""
    args, bins, H, W = screen_scene(cuda_device, n=1500, H=48, W=64, n_chan=n_chan, opacity=(0.3, 0.9), seed=n_chan)
    assert int(bins.tile_cnt.max()) > 2 * 256
    _check_variant(mode, args, bins, H, W)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_variant_kernel_on_a_sparse_scene_with_undefined_empty_tiles(cuda_device, mode):
    """A wide frame with few gaussians: empty tiles that own a padding chunk
    and empty tiles that own none, both written with the init."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    args, bins, H, W = screen_scene(cuda_device, n=12, H=48, W=256, sd=(1.0, 3.0))
    table = V.bins_chunk_table(bins, H, W)
    empty, defined = bins.tile_cnt == 0, V.defined_tiles("base", table)
    assert bool((empty & defined).any()) and bool((empty & ~defined).any())
    got, _ = _check_variant(mode, args, bins, H, W)
    init = torch.zeros(256, 16, device=cuda_device)
    init[:, V.COL_T] = 1.0
    assert bool((got[empty] == init).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_variant_kernel_where_most_pairs_fall_outside_every_box(cuda_device, mode):
    """3,000 gaussians of 0.4-1.2 px: each meets one or two of a tile's eight
    warps, so the warps pass over most of the list."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    args, bins, H, W = screen_scene(cuda_device, n=3000, H=64, W=64, sd=(0.4, 1.2), opacity=(0.05, 0.6), seed=4)
    _check_variant(mode, args, bins, H, W)
    if mode not in ("empty", "notrans"):  # notrans's boxes reach 255·o − 1: they hold most of a tile
        run = V.variant_plain_run(mode, *args, bins, H, W)
        table = V.bins_chunk_table(bins, H, W)
        evaluated, _ = V.variant_pairs(mode, run, args[0], args[1], args[3], bins, H, W, table)
        assert evaluated < 0.3 * run.pairs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_variant_kernel_repeats_bit_for_bit(cuda_device, mode):
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    args, bins, H, W = _repeat_scene(cuda_device)
    table = V.bins_chunk_table(bins, H, W)
    a = V.blend_variant(mode, *args, bins, H, W, table=table)
    b = V.blend_variant(mode, *args, bins, H, W, table=table)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("opacity", [(0.05, 0.6), (0.5, 0.95)])
def test_variant_base_matches_blend_kernel_off_the_stop_band(cuda_device, opacity):
    """``base`` in image layout against B1 on lists of several batches, off
    the stop band of either (the two round T apart: a running sum of log1p
    against a running product), elementwise within 1e-5 + 1e-4 of B1's value
    (1e-6 + 1e-4 for T)."""
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    args, bins, H, W = screen_scene(cuda_device, n=2500, H=64, W=64, opacity=opacity, seed=6)
    assert int(bins.tile_cnt.max()) > 256
    got, _ = _check_variant("base", args, bins, H, W)
    img, T = V.tiles_to_image(got, H, W, 4)
    want = blend_cuda.blend_forward(*args, bins, H, W)
    torch.cuda.synchronize()
    band = ((T - T_EPS).abs() <= V.STOP_BAND * T_EPS) | ((want.final_T - T_EPS).abs() <= V.STOP_BAND * T_EPS)
    assert int(band.sum()) <= band.numel() // 200
    keep = ~band
    assert bool(((img - want.img).abs()[keep] <= 1e-5 + 1e-4 * want.img.abs()[keep]).all())
    assert bool(((T - want.final_T).abs()[keep] <= 1e-6 + 1e-4 * want.final_T.abs()[keep]).all())


@pytest.mark.cuda
def test_variant_kernel_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import blend_variants as V

    (xys, conics, chan, opacs), bins, H, W = _inputs(cuda_device)
    with pytest.raises(ValueError):  # C = 12
        V.blend_variant("base", xys, conics, chan.repeat(1, 3), opacs, bins, H, W)
    with pytest.raises(TypeError):
        V.blend_variant("scan", xys.double(), conics, chan, opacs, bins, H, W)
    with pytest.raises(ValueError):  # a chunk table of other bins
        other = V.chunk_table(bins.tile_cnt[:8], 2, 4, V.aligned_capacity(1 << 12, 8))
        V.blend_variant("pair", xys, conics, chan, opacs, bins, H, W, table=other)


# bf16 B4/B5 (mma.sync m16n8k16): 128 own rows a CTA (keys for B4, queries
# for B5) at D ≤ 48, 64 above; ring tiles of 64 rows (D ≤ 80) or 32, walked 16
# rows at a time; widths rounded up to 16, 32, 40, 48, 64, 80, 96, 128 or 160
# with the columns past D zero-filled; B4 splits its queries over several
# CTAs where its key blocks are too few for the card, as in fp32
BF16_WIDTHS = [8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 160]


def _assert_bf16_grads(got, want, names=("dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), name
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= BWD_BF16_REL_L2, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("D", BF16_WIDTHS)
def test_flash_backward_bf16_head_widths(cuda_device, D):
    """Every bf16 width template against autograd through sdpa_plain, with
    and without the query split; each repeats bit for bit."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 200, 130, D, seed=D)
    _check_grads(q, k, v, seed=D)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(D)).to(cuda_device, q.dtype)
    want = _plain_grads(q, k, v, dout)
    for splits in (1, 3):
        got = _direct_grads(q, k, v, dout, splits)
        _assert_bf16_grads(got, want)
        assert all(torch.equal(x, y) for x, y in zip(got, _direct_grads(q, k, v, dout, splits)))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 129])
def test_flash_backward_bf16_tile_edges(cuda_device, S, T):
    """Ragged S and T: counts on each side of a 16-row slice, a ring tile
    (64 rows at D ≤ 80, 32 above) and a CTA's own rows (128 at D = 40, 64 at
    D = 80 and 160). With one key, P = 1 and dP = dO·V = delta, so dQ and dK
    vanish but for rounding on both sides: there they are held to the limit
    of dV's norm instead of their own."""
    for B, H, D, seed in ((2, 3, 40, S * 1000 + T), (1, 2, 80, S * 1000 + T + 1), (1, 2, 160, S * 1000 + T + 2)):
        q, k, v = _qkv(cuda_device, torch.bfloat16, B, H, S, T, D, seed=seed)
        if T > 1:
            _check_grads(q, k, v, seed=seed)
            continue
        dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(seed)).to(cuda_device, q.dtype)
        got, want = _direct_grads(q, k, v, dout), _plain_grads(q, k, v, dout)
        for g, w in zip(got[:2], want[:2]):
            assert float((g.float() - w).norm()) <= BWD_BF16_REL_L2 * float(want[2].norm())
        _assert_bf16_grads(got[2:], want[2:], ("dv",))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,forced", [
    ((4, 8, 256, 256, 160), 2),  # self 16²: the rule keeps 1 (one split per 256 queries); forced to 2
    ((4, 8, 64, 64, 160), 2),  # self 8²: likewise
    ((4, 8, 4096, 77, 40), 3),  # cross 64²: 8
    ((4, 8, 1024, 77, 80), 7),  # cross 32²: 4
    ((2, 3, 300, 200, 24), 5),  # the rule: 2
])
def test_flash_backward_bf16_query_split_matches_unsplit(cuda_device, shape, forced):
    """bf16 B4 with its queries split (by the rule, and a forced count)
    against the unsplit kernel and the plain gradients; the split sums its
    fp32 partials in a fixed order, so each count repeats bit for bit, and
    dQ (B5) does not split."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    B, H, S, T, D = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, B, H, S, T, D, seed=S + T)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cpu").manual_seed(T)).to(cuda_device, q.dtype)
    want = _plain_grads(q, k, v, dout)
    rule = attention_cuda.dkv_splits(B, H, S, T, D, torch.cuda.get_device_properties(cuda_device).multi_processor_count,
                                     bf16=True)
    one = _direct_grads(q, k, v, dout, 1)
    _assert_bf16_grads(one, want)
    for splits in sorted({rule, forced}):
        got = _direct_grads(q, k, v, dout, splits)
        _assert_bf16_grads(got, want)
        assert torch.equal(got[0], one[0])
        for g, u in zip(got[1:], one[1:]):
            assert float((g.float() - u.float()).norm() / u.float().norm()) <= BWD_BF16_REL_L2
        assert all(torch.equal(x, y) for x, y in zip(got, _direct_grads(q, k, v, dout, splits)))
    sums = attention_cuda.dkv_sum_launches()
    auto = _direct_grads(q, k, v, dout)
    assert attention_cuda.dkv_sum_launches() == sums + (rule > 1)
    assert all(torch.equal(x, y) for x, y in zip(auto, _direct_grads(q, k, v, dout, rule)))


@pytest.mark.cuda
def test_flash_backward_bf16_misaligned_input_is_copied(cuda_device):
    """A contiguous bf16 key tensor 8 bytes past a 16-byte boundary is copied
    to an aligned tensor by B3, B4 and B5 alike, counted, and gives the
    gradients of the aligned input bit for bit."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 100, 77, 40, seed=4)
    flat = torch.zeros(k.numel() + 4, dtype=k.dtype, device=cuda_device)
    k_off = flat[4:].view(k.shape)
    k_off.copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 8
    copies = attention_cuda.copies
    with pytest.warns(UserWarning, match="copied"):
        got = _check_grads(q, k_off, v, seed=5)
    assert attention_cuda.copies == copies + 3  # B3's forward, then B4 and B5
    assert all(torch.equal(x, y) for x, y in zip(got, _check_grads(q, k, v, seed=5)))


def test_native_libraries_build_with_gxx(tmp_path, monkeypatch):
    """The data loader's C++ (native/plyio.cpp, imageio.cpp) builds with this
    machine's g++ into a fresh directory, and both libraries load and read."""
    import ctypes

    from gaussctrl_exp_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    for name in ("plyio", "imageio"):
        lib = native.build(name)
        assert lib.parent == tmp_path / "_build" and lib.exists()
    xyz = np.arange(12, dtype="<f4").reshape(4, 3)
    ply = tmp_path / "p.ply"
    head = "ply\nformat binary_little_endian 1.0\nelement vertex 4\n" + "".join(
        f"property float {c}\n" for c in "xyz") + "end_header\n"
    ply.write_bytes(head.encode() + xyz.tobytes())
    from gaussctrl_exp_tpu_torch.data.ply import read_ply_points_native

    got, rgb = read_ply_points_native(ply)
    np.testing.assert_array_equal(got, xyz)
    assert rgb is None
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    dist = np.array([0.05, 0.0, 0.0, 0.0, 0.0, 0.0])
    src = np.random.default_rng(0).uniform(size=(24, 32, 3)).astype(np.float32)
    out = np.zeros_like(src)
    native.get_imageio().undistort_f32(*(a.ctypes.data_as(ctypes.c_void_p) for a in (src,)), 24, 32, 3,
                                       *(a.ctypes.data_as(ctypes.c_void_p) for a in (K, dist, K, out)))
    assert np.isfinite(out).all() and 0 < np.abs(out - src).max() < 1


def test_eval_png_round_trips_at_512(tmp_path):
    """The eval image the writer saves reads back as the frame, in the bytes
    of Pillow's own save of it."""
    from PIL import Image

    from gaussctrl_exp_tpu_torch.engine.writer import EventWriter

    img = np.random.default_rng(1).integers(0, 256, (512, 512, 3)).astype(np.uint8)
    w = EventWriter(tmp_path, quiet=True)
    w.put_image(1, "f", img / 255.0)
    w.close()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f_000001.png")), img)
    Image.fromarray(img).save(tmp_path / "want.png")
    assert (tmp_path / "f_000001.png").read_bytes() == (tmp_path / "want.png").read_bytes()


def _band_case(device, H=128, W=96, n=600, seed=3):
    """parallel/sharded.py's payload of a scene at H × W on ``device``: a
    gaussian cloud whose boxes straddle the band edges."""
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianParams
    from gaussctrl_exp_tpu_torch.parallel import sharded as S

    rng = np.random.default_rng(seed)
    p = GaussianParams(
        means=torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=device),
        scales=torch.as_tensor((rng.normal(size=(n, 3)) * 0.4 - 3.0).astype(np.float32), device=device),
        quats=torch.as_tensor(rng.normal(size=(n, 4)).astype(np.float32), device=device),
        features_dc=torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=device),
        features_rest=torch.zeros((n, 15, 3), device=device),
        opacities=torch.as_tensor(rng.uniform(-1, 3, (n, 1)).astype(np.float32), device=device))
    cfg = S.ShardedRenderConfig(height=H, width=W)
    c2w = torch.as_tensor(look_at([0.0, -4.0, 0.5], np.zeros(3)), device=device)
    cam = make_camera(c2w.cpu().numpy(), 1.2 * W, 1.2 * W, W / 2, H / 2, W, H, device=device)
    payload = S.project_local(p, torch.ones(n, dtype=torch.bool, device=device), cam, 30_000, cfg)
    return S, cfg, {k: v.detach() for k, v in payload.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_band_blend_matches_the_full_frame(cuda_device, n_bands):
    """Each band of parallel/sharded.py's band blend (B1 at band-local
    offsets) against its rows of the full-frame B1 render, and the sum of
    the bands' B2 gradients against the full frame's. The band shifts the
    centres by its first row, so a pair at the 1/255 alpha edge or a pixel
    at the stop can round the other way: |d| ≤ 1e-2 (one such gaussian's
    weight), and over 1e-5 at no more than 1% of the pixels; gradients
    relative L2 ≤ 1e-4 per field."""
    S, cfg, payload = _band_case(cuda_device)
    H, W = cfg.height, cfg.width
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g = torch.randn((H, W, 4), generator=gen, device=cuda_device)

    def run(k):
        leaves = {f: payload[f].clone().requires_grad_() for f in ("xys", "conics", "colors", "opacs")}
        rows = []
        b1, b2 = blend_cuda.launches, blend_cuda.bwd_launches
        for b in range(k):
            img, _, _ = S.band_blend(S.band_payload(dict(payload, **leaves), b, k, cfg), k, cfg)
            (img * g[b * H // k : (b + 1) * H // k]).sum().backward()
            rows.append(img.detach())
        torch.cuda.synchronize()
        assert (blend_cuda.launches - b1, blend_cuda.bwd_launches - b2) == (k, k)
        return torch.cat(rows), {f: t.grad for f, t in leaves.items()}

    full, gfull = run(1)
    bands, gbands = run(n_bands)
    d = (bands - full).abs()
    assert float(d.max()) <= 1e-2 and float((d.amax(-1) > 1e-5).float().mean()) <= 1e-2
    for f in gfull:
        assert float((gbands[f] - gfull[f]).norm() / gfull[f].norm()) <= 1e-4, f


@pytest.mark.cuda
def test_viewer_jpeg_of_a_frame_read_back_from_the_card(cuda_device):
    """The viewer's ``/render`` on the card: its body is Pillow's quality-90
    encode (the JAX viewer's call) of the B1 render read back from the card."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from gaussctrl_exp_tpu_torch.cli import viewer
    from gaussctrl_exp_tpu_torch.models.gaussians import GaussianParams, GaussianState
    from gaussctrl_exp_tpu_torch.models.splat_model import SplatModelConfig, render_model

    rng = np.random.default_rng(4)
    n, size = 800, 128

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=cuda_device)

    params = GaussianParams(means=t(rng.normal(size=(n, 3)) * 0.5), scales=t(rng.normal(size=(n, 3)) * 0.3 - 3.0),
                            quats=t(rng.normal(size=(n, 4))), features_dc=t(rng.normal(size=(n, 3))),
                            features_rest=t(np.zeros((n, 15, 3))), opacities=t(rng.uniform(0, 3, (n, 1))))
    state = GaussianState(params, torch.ones(n, dtype=torch.bool, device=cuda_device))
    cfg = SplatModelConfig(background_color="white")
    httpd = viewer.serve(state, cfg, port=0, size=size, device=cuda_device)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://localhost:{httpd.server_address[1]}/render?az=0.4&el=0.3&r=3.5",
                                    timeout=120) as r:
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
    with torch.no_grad():
        out = render_model(state, viewer.orbit_camera(0.4, 0.3, 3.5, np.zeros(3), size, cuda_device),
                           viewer.RENDER_STEP, cfg)
    frame = (np.clip(out.rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    assert frame.std() > 5
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=90)
    assert body == buf.getvalue()


# ------------------------------------- the CUDA graph of the ControlNet + UNet

SD_TINY = dict(block_out=(32, 64), vae_block_out=(32, 32, 32, 32), heads=2, cross_dim=32, layers_per_block=1)


@pytest.fixture
def tracing():
    from gaussctrl_exp_tpu_torch.utils import trace

    trace.reset(trace.CAPACITY)
    trace.enable()
    yield trace
    trace.disable()
    trace.reset(trace.CAPACITY)


def _sd_inputs(device, B=1, h=16, cross=32, seed=0):
    """Latents (B, h, h, 4), t (B,), text states (B, 77, cross), hint (B, 8h, 8h, 3)."""
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn((B, h, h, 4), generator=g).to(device)
    t = torch.full((B,), 501, dtype=torch.long, device=device)
    ctx = torch.randn((B, 77, cross), generator=g).to(device)
    hint = torch.rand((B, 8 * h, 8 * h, 3), generator=g).to(device)
    return lat, t, ctx, hint


def _tiny_sd_pipe(device, dtype):
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, init_random_models

    return SDControlNetPipeline(init_random_models(7, device, dtype, **SD_TINY))


def _b3_launches(fn):
    """``fn()`` and the B3 launches it counted, after the device finished."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    before = attention_cuda.launches
    out = fn()
    torch.cuda.synchronize()
    return out, attention_cuda.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eps_graph_invert_matches_eager_bit_for_bit(cuda_device, tracing, dtype):
    """A 20-step inversion through the graph (captured at its first step,
    replayed at the other 19) gives the eager inversion's z0 bit for bit
    with as many B3 launches; a second view with new inputs replays the same
    graph and matches too."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor

    pipe = _tiny_sd_pipe(cuda_device, dtype)
    lat, _, ctx, hint = _sd_inputs(cuda_device)
    z_graph, n_graph = _b3_launches(lambda: pipe.invert(lat, ctx, hint, 20))
    # each of the 20 evaluations (the capture's warm-up, 19 replays) counts the tiny stack's 31 GroupNorms:
    # N1 on the bf16 stack, the NCHW path on the float32 one (its norms' parameters share its type)
    norms = "sd.norm.nhwc" if dtype == torch.bfloat16 else "sd.norm.nchw"
    assert tracing.counters() == {"sd.eps.graph_capture": 1, "sd.eps.graph_replay": 19, norms: 20 * 31}
    z_eager, n_eager = _b3_launches(lambda: pipe.invert(lat, ctx, hint, 20, processor=default_processor))
    assert torch.equal(z_graph, z_eager)
    assert n_graph == n_eager == 20 * 2 * (4 + 2)  # Transformer2D blocks: UNet 4, ControlNet 2; 2 calls each

    tracing.reset()
    lat2, _, _, hint2 = _sd_inputs(cuda_device, seed=1)
    z2 = pipe.invert(lat2, ctx, hint2, 20)
    assert tracing.counters() == {"sd.eps.graph_replay": 20, norms: 20 * 31} and len(pipe.graphs.entries) == 1
    assert not torch.equal(z2, z_graph)
    assert torch.equal(z2, pipe.invert(lat2, ctx, hint2, 20, processor=default_processor))


@pytest.mark.cuda
def test_eps_graph_recaptures_for_a_new_scale_batch_or_parameters(cuda_device, tracing):
    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor

    pipe = _tiny_sd_pipe(cuda_device, torch.bfloat16)
    one, two = _sd_inputs(cuda_device), _sd_inputs(cuda_device, B=2, seed=2)
    for args, scale in [(one, 1.0), (one, 1.0), (one, 0.5), (two, 1.0), (two, 1.0), (one, 0.5)]:
        got = pipe._eps(*args, scale)
        assert torch.equal(got, pipe._eps(*args, scale, default_processor))
    c = tracing.counters()
    assert (c["sd.eps.graph_capture"], c["sd.eps.graph_replay"]) == (3, 3) and len(pipe.graphs.entries) == 3

    w = pipe.m.unet.conv_in.weight  # moved: the graphs read the old storage, so every one goes
    w.data = w.data * 2
    tracing.reset()
    got = pipe._eps(*one, 1.0)
    assert tracing.counters()["sd.eps.graph_capture"] == 1 and len(pipe.graphs.entries) == 1
    got = pipe._eps(*one, 1.0)
    assert tracing.counters()["sd.eps.graph_replay"] == 1
    assert torch.equal(got, pipe._eps(*one, 1.0, default_processor))


@pytest.mark.cuda
def test_eps_graph_output_survives_the_next_replay(cuda_device):
    pipe = _tiny_sd_pipe(cuda_device, torch.bfloat16)
    a, b = _sd_inputs(cuda_device, seed=3), _sd_inputs(cuda_device, seed=4)
    pipe._eps(*a, 1.0)  # capture
    eps_a = pipe._eps(*a, 1.0)  # replay
    kept = eps_a.clone()
    eps_b = pipe._eps(*b, 1.0)  # replay over the same static output
    torch.cuda.synchronize()
    assert torch.equal(eps_a, kept) and not torch.equal(eps_a, eps_b)


@pytest.mark.cuda
def test_eps_graph_full_width_step_matches_eager(cuda_device):
    """One inversion step of the SD 1.x stack at full width in bf16, B = 1
    at 64² latents: the replay equals the eager call bit for bit, with as
    many B3 launches (16 Transformer2D blocks in the UNet, 7 in the
    ControlNet, 2 calls each)."""
    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, init_random_models

    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    pipe = SDControlNetPipeline(init_random_models(7, cuda_device, torch.bfloat16))
    args = _sd_inputs(cuda_device, h=64, cross=768, seed=5)
    norms = []
    for call in (lambda: pipe._eps(*args, 1.0), lambda: pipe._eps(*args, 1.0),
                 lambda: pipe._eps(*args, 1.0, default_processor)):
        before = groupnorm_cuda.launches
        norms.append(_b3_launches(call) + (groupnorm_cuda.launches - before,))
    (_, n_capture, m_capture), (replay, n_replay, m_replay), (eager, n_eager, m_eager) = norms
    assert torch.equal(replay, eager) and bool(torch.isfinite(eager).all())
    assert n_capture == n_replay == n_eager == 2 * (16 + 7)
    assert m_capture == m_replay == m_eager == 88  # every GroupNorm through N1: UNet 61, ControlNet 27


@pytest.mark.cuda
def test_eps_graph_captures_while_another_thread_renders(cuda_device):
    """The viewer renders from its own thread while the edit phase inverts:
    a thread that allocates fresh device memory, computes and copies to the
    host all through a capture neither fails nor breaks the capture, whose
    replays still match the eager call bit for bit. Like the viewer, it
    draws nothing from the default CUDA generator, which every capture
    takes over (a draw from another thread meanwhile raises)."""
    import sys
    import threading

    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor

    pipe = _tiny_sd_pipe(cuda_device, torch.bfloat16)
    args = _sd_inputs(cuda_device, seed=6)
    stop, errors, done = threading.Event(), [], [0]

    def render_loop():
        try:
            while not stop.is_set():
                mb = 1 + done[0] % 48  # sizes the allocator has not cached yet, on the first pass
                x = torch.full((mb << 18,), 1.0 + done[0], device=cuda_device)
                float((x * x).sum().cpu())
                done[0] += 1
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    thread = threading.Thread(target=render_loop, daemon=True)
    try:
        thread.start()
        while done[0] < 2:
            pass
        before = done[0]
        pipe._eps(*args, 1.0)  # warm-up and capture
        during = done[0] - before
    finally:
        stop.set()
        thread.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not thread.is_alive() and not errors, errors
    assert during > 0
    assert torch.equal(pipe._eps(*args, 1.0), pipe._eps(*args, 1.0, default_processor))


# ------------------------------------------- N1: the NHWC GroupNorm (+ SiLU)

NORM_DIFFER_MAX, NORM_REL = 1e-2, 5e-4  # as tests/test_torch_sd_bf16.py
# (C, side) of the SD 1.x UNet's and ControlNet's norms at 64² latents
SD_NORMS = [(320, 64), (640, 64), (960, 64), (320, 32), (640, 32), (960, 32), (1280, 32), (1920, 32), (640, 16),
            (1280, 16), (1920, 16), (2560, 16), (1280, 8), (2560, 8)]


def _nhwc_activation(device, B, C, H, W, seed=0):
    """bf16 (B, C, H, W) channels-last with per-channel offsets and scales;
    float32 scale and bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g) * (0.5 + torch.rand(C, generator=g)) + 2 * torch.randn(C, generator=g)
    w, b = 1.0 + 0.3 * torch.randn(C, generator=g), 0.2 * torch.randn(C, generator=g)
    return x.bfloat16().to(device).permute(0, 3, 1, 2), w.to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("B", [1, 2, 18])
@pytest.mark.parametrize("C,side", SD_NORMS)
def test_group_norm_nhwc_matches_plain(cuda_device, C, side, B, silu):
    """N1 against float32 ``F.group_norm`` of the NCHW input rounded to
    bf16 (and SiLU'd): at most ``NORM_DIFFER_MAX`` of the outputs differ."""
    import torch.nn.functional as F

    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    eps = 1e-5 if C != 640 else 1e-6  # both of the stack's epsilons
    x, w, b = _nhwc_activation(cuda_device, B, C, side, side, seed=C + B)
    before = groupnorm_cuda.launches
    got = groupnorm_cuda.group_norm_nhwc(x, w, b, 32, eps, silu)
    want = F.group_norm(x.contiguous().float(), 32, w, b, eps).bfloat16()
    want = F.silu(want) if silu else want
    torch.cuda.synchronize()
    assert groupnorm_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    got, want = got.float(), want.float()
    assert float((got != want).float().mean()) <= NORM_DIFFER_MAX
    assert float((got - want).norm() / want.norm()) <= NORM_REL


@pytest.mark.cuda
@pytest.mark.parametrize("C,groups", [(32, 32), (64, 32), (96, 32), (8, 4), (4096, 32)])
def test_group_norm_nhwc_narrow_and_wide_groups(cuda_device, C, groups):
    """Groups of 1, 2 and 3 channels (a vector over 8, 4 or 3 groups), of 2
    in 8 channels, and the widest C it takes, on ragged positions."""
    import torch.nn.functional as F

    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    x, w, b = _nhwc_activation(cuda_device, 3, C, 7, 11, seed=C)
    got = groupnorm_cuda.group_norm_nhwc(x, w, b, groups, 1e-5, True).float()
    want = F.silu(F.group_norm(x.contiguous().float(), groups, w, b, 1e-5).bfloat16()).float()
    assert float((got != want).float().mean()) <= NORM_DIFFER_MAX
    assert float((got - want).norm() / want.norm()) <= NORM_REL


@pytest.mark.cuda
def test_group_norm_nhwc_repeats_bit_for_bit(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    x, w, b = _nhwc_activation(cuda_device, 18, 320, 64, 64)
    first = groupnorm_cuda.group_norm_nhwc(x, w, b, 32, 1e-5, True)
    assert all(torch.equal(first, groupnorm_cuda.group_norm_nhwc(x, w, b, 32, 1e-5, True)) for _ in range(3))


@pytest.mark.cuda
def test_group_norm_nhwc_refuses_what_it_does_not_take(cuda_device):
    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    x, w, b = _nhwc_activation(cuda_device, 1, 320, 8, 8)
    for bad in (x.contiguous(), x.float(), x[:, :-8], torch.empty(1, 8192, 2, 2, device=cuda_device,
                                                                     dtype=torch.bfloat16).permute(0, 3, 1, 2)):
        with pytest.raises((ValueError, TypeError)):
            groupnorm_cuda.group_norm_nhwc(bad, w[: bad.shape[1]], b[: bad.shape[1]], 32, 1e-5)
    with pytest.raises(ValueError):
        groupnorm_cuda.group_norm_nhwc(x, w.bfloat16(), b, 32, 1e-5)
    with pytest.raises(ValueError):
        groupnorm_cuda.group_norm_nhwc(x, w, b, 30, 1e-5)


@pytest.mark.cuda
def test_eps_step_runs_no_layout_conversion(cuda_device):
    """One eager ε evaluation of the full-width bf16 stack at B = 1 (the
    inversion's step, as a graph replays it) under torch.profiler: no cuDNN
    layout conversion (``nchwToNhwc``, ``nhwcToNchw``) runs, every
    GroupNorm is N1's two kernels, and torch's GroupNorm kernels never run."""
    from torch.profiler import ProfilerActivity, profile

    from gaussctrl_exp_tpu_torch.diffusion.attention import default_processor
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, init_random_models
    from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda

    pipe = SDControlNetPipeline(init_random_models(7, cuda_device, torch.bfloat16))
    args = _sd_inputs(cuda_device, h=64, cross=768, seed=5)
    pipe._eps(*args, 1.0, default_processor)  # warm-up: libraries loaded, cuDNN's plans chosen
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe._eps(*args, 1.0, default_processor)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names
    assert [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n] == []
    assert sum(groupnorm_cuda.KERNEL in n for n in names) == 2 * 88
    assert not [n for n in names if "RowwiseMoments" in n or "GroupNorm" in n]
