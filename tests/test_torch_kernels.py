"""Kernels B1 and B2 (the CUDA tile blend and its backward), B3 (the
flash-attention forward), B4, B5 (its backward) and B1v (the blend-forward
ablations) against their plain PyTorch versions.

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
@pytest.mark.parametrize("shape,splits", [
    ((4, 8, 4096, 4096, 40), 1),  # self 64²: 64 · 32 = 2,048 CTAs
    ((4, 8, 1024, 1024, 80), 1),  # self 32²: 512
    ((4, 8, 256, 256, 160), 3),  # self 16²: 128 CTAs → 3 splits (384)
    ((4, 8, 64, 64, 40), 1),  # self 8²: 32 CTAs, but 64 queries
    ((4, 8, 4096, 77, 40), 5),  # cross 64²: 64 CTAs → 5 splits (320)
    ((4, 8, 1024, 77, 80), 5),
    ((4, 8, 256, 77, 160), 4),  # at most one split per 64 queries
    ((2, 3, 100, 77, 40), 2),
    ((5, 7, 288, 77, 40), 3),  # 70 CTAs want 4 splits; 9 ring tiles of 32 go 3 a split
    ((33, 8, 100, 64, 40), 1),  # 264 CTAs: two an SM already
    ((32, 8, 100, 64, 40), 2),  # 256: one short
])
def test_dkv_query_splits(cuda_device, shape, splits):
    """fp32 B4 splits each key block's queries over more CTAs where its
    ceil(T / 64) · B · H CTAs give fewer than two for each of 132 SMs, at
    most one split per 64 queries; bf16 never splits."""
    from gaussctrl_exp_tpu_torch.ops import attention_cuda

    assert attention_cuda.dkv_splits(*shape, sms=132) == splits
    assert attention_cuda._bwd_lib().gctorch_flash_attn_bwd_dkv_splits(*shape, 1, 132) == 1


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
