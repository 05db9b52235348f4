"""The UNet and the ControlNet channels-last, on the CPU.

On the card the edit pipeline re-stores the UNet's and the ControlNet's conv
weights channels-last (``layers.to_channels_last``) and hands them NHWC
views, so that cuDNN's NHWC convolutions read weights and activations as they
lie; every GroupNorm of the stack then takes kernel N1 (GroupNorm, with the
SiLU after it fused) through ``groupnorm_cuda.group_norm_nhwc``. The kernel
runs only on the card (``tests/test_torch_kernels.py``); here:

- the NHWC path of ``layers.GroupNorm`` (on the CPU the plain version)
  against ``F.group_norm`` of the NCHW input in float32, rounded to bf16,
  for group widths 10 to 80 and both epsilons, with and without SiLU: at
  most ``NORM_DIFFER_MAX`` of the bf16 outputs differ (the CPU's NHWC and
  NCHW norms sum in other orders) and the relative L2 is ≤ ``NORM_REL``, the
  limits of ``test_torch_sd_bf16.py``;
- the rule that splits each sample's positions into N1's chunks, at the
  SD shapes on an H100's SM counts;
- a tiny converted stack: every conv and norm input of an ε step is
  channels-last, every norm counts ``sd.norm.nhwc``, and ε equals the NCHW
  stack's within float32 rounding;
- the VAE, the depth generator (its training and its sampling) and every
  CPU call of an unconverted stack keep the NCHW norm.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_exp_tpu_torch.diffusion import mv_generator as mv
from gaussctrl_exp_tpu_torch.diffusion.layers import GroupNorm, to_channels_last
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDControlNetPipeline, init_random_models
from gaussctrl_exp_tpu_torch.ops import groupnorm_cuda
from gaussctrl_exp_tpu_torch.utils import trace
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NORM_DIFFER_MAX, NORM_REL = 1e-2, 5e-4  # as tests/test_torch_sd_bf16.py
EPS_F32_REL = 1e-5  # ε of the float32 tiny stack, channels-last against NCHW
SMS = (132, 114)  # an H100 SXM's and PCIe's SMs, for the chunking rule
# (C, side) of the SD 1.x UNet's and ControlNet's norms at 64² latents
SD_NORMS = [(320, 64), (640, 64), (960, 64), (320, 32), (640, 32), (960, 32), (1280, 32), (1920, 32), (640, 16),
            (1280, 16), (1920, 16), (2560, 16), (1280, 8), (2560, 8)]


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset(trace.CAPACITY)
    yield
    trace.disable()
    trace.reset(trace.CAPACITY)


def _activation(B, C, H, W, seed=0):
    """A bf16 (B, C, H, W) channels-last activation with per-channel offsets
    and scales, so that groups have means well away from 0; float32 scale
    and bias as the edit stack's norms hold them."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((B, H, W, C), generator=g) * (0.5 + torch.rand(C, generator=g)) + 2 * torch.randn(C, generator=g))
    w = 1.0 + 0.3 * torch.randn(C, generator=g)
    b = 0.2 * torch.randn(C, generator=g)
    return x.bfloat16().permute(0, 3, 1, 2), w, b


def _reference(x, w, b, groups, eps, silu):
    """``F.group_norm`` of the NCHW input in float32, rounded to bf16, SiLU'd."""
    y = F.group_norm(x.contiguous().float(), groups, w, b, eps).bfloat16()
    return F.silu(y) if silu else y


def _assert_close(got, want):
    got, want = got.float(), want.float()
    assert float((got != want).float().mean()) <= NORM_DIFFER_MAX
    assert float((got - want).norm() / want.norm()) <= NORM_REL


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("width", [10, 20, 30, 40, 60, 80])
def test_nhwc_norm_path_matches_group_norm(width, silu, eps):
    C = 32 * width
    x, w, b = _activation(2, C, 5, 7, seed=width)
    norm = GroupNorm(32, C, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        trace.enable()
        got = norm(x, silu=silu)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    assert trace.counters() == {"sd.norm.nhwc": 1}
    _assert_close(got, _reference(x, w, b, 32, eps, silu))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B", [1, 2, 18])
@pytest.mark.parametrize("C,side", SD_NORMS)
def test_chunks_fill_the_card_and_cover_every_position(C, side, B, sms):
    HW = side * side
    K, P, R = groupnorm_cuda.chunks(B, HW, C, sms)
    assert K * P >= HW > (K - 1) * P  # no empty chunk
    assert 32 <= R * (C // 8) <= groupnorm_cuda.MAX_THREADS
    assert K * B <= max(2 * sms, B) and K <= sms  # at most one wave of two CTAs an SM, one chunk an SM a sample
    assert 4 * K * B >= 3 * min(2 * sms, B * sms, B * -(-HW // R))  # and most of it, unless positions run out


def _tiny_step(dtype, converted, seed=0):
    """A pipeline on the tiny stack in ``dtype`` (channels-last where
    ``converted``, as the card's pipeline keeps it) and one ε's inputs."""
    models = init_random_models(3, "cpu", dtype, **TINY)
    pipe = SDControlNetPipeline(models)
    assert pipe.layout == torch.contiguous_format  # the CPU's pipeline converts nothing
    if converted:
        to_channels_last(models.unet)
        to_channels_last(models.controlnet)
        pipe.layout = torch.channels_last
    g = torch.Generator().manual_seed(seed)
    args = (torch.randn((2, 8, 8, 4), generator=g), torch.tensor([501, 901]),
            torch.randn((2, 77, TINY["cross_dim"]), generator=g), torch.rand((2, 64, 64, 3), generator=g))
    return pipe, args


def test_every_conv_and_norm_of_a_converted_step_reads_channels_last():
    pipe, args = _tiny_step(torch.bfloat16, converted=True)
    inputs = []
    handles = [m.register_forward_pre_hook(lambda m, a, name=f"{part}.{name}": inputs.append((name, a[0])))
               for part in ("unet", "controlnet") for name, m in getattr(pipe.m, part).named_modules()
               if isinstance(m, (nn.Conv2d, nn.GroupNorm))]
    trace.enable()
    eps = pipe._eps(*args, 1.0)
    for h in handles:
        h.remove()
    assert len(inputs) == len(handles)  # every conv and norm ran once
    assert [n for n, x in inputs if not x.is_contiguous(memory_format=torch.channels_last)] == []
    assert trace.counters() == {"sd.eps.eager": 1, "sd.norm.nhwc": 31}  # UNet 21 norms, ControlNet 10
    assert eps.shape == (2, 8, 8, 4) and eps.is_contiguous()


def test_converted_eps_matches_the_nchw_stack_in_float32():
    (pipe, args), (cl, _) = _tiny_step(torch.float32, False), _tiny_step(torch.float32, True)
    want, got = pipe._eps(*args, 1.0), cl._eps(*args, 1.0)
    assert got.is_contiguous() and got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) <= EPS_F32_REL * float(want.abs().max())


def test_to_channels_last_restores_only_conv_weights_in_place():
    models = init_random_models(3, "cpu", torch.bfloat16, **TINY)
    before = {n: p for n, p in models.controlnet.named_parameters()}
    want = {n: p.detach().clone() for n, p in before.items()}
    to_channels_last(models.controlnet)
    for n, p in models.controlnet.named_parameters():
        assert p is before[n] and torch.equal(p, want[n]), n
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), n
        else:
            assert p.is_contiguous(), n


@pytest.fixture
def no_nhwc_norm(monkeypatch):
    """``group_norm_nhwc`` replaced by one that fails the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("the NHWC norm ran")

    monkeypatch.setattr(groupnorm_cuda, "group_norm_nhwc", refuse)


def test_vae_and_unconverted_cpu_stack_keep_the_nchw_norm(no_nhwc_norm):
    converted, _ = _tiny_step(torch.bfloat16, converted=True)  # the VAE beside a channels-last stack
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    trace.enable()
    latents = converted.image_to_latent(images, torch.Generator().manual_seed(2))
    assert converted.latent_to_image(latents).shape == (2, 64, 64, 3)
    unconverted, args = _tiny_step(torch.bfloat16, converted=False)
    assert unconverted._eps(*args, 1.0).shape == (2, 8, 8, 4)
    assert trace.counters() == {"sd.eps.eager": 1}  # CPU calls of the old path count nothing


@pytest.mark.parametrize("grad", [True, False])
def test_depth_generator_keeps_the_nchw_norm(no_nhwc_norm, grad):
    gen = mv.init_depth_generator(0, latent=8, block_out=(32, 64), heads=2, cross_dim=16, layers_per_block=1,
                                  dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, dl = torch.randn((2, 8, 8, 4), generator=g), torch.randn((2, 8, 8, 1), generator=g)
    with torch.set_grad_enabled(grad):
        eps = gen._eps(x, dl, torch.tensor([10, 900]), torch.randn((2, 77, 16), generator=g), None)
    assert eps.dtype == torch.bfloat16 and eps.requires_grad == grad


def test_tally_takes_the_counts_of_its_block_whether_or_not_recording():
    trace.count("a")  # off: nothing
    with trace.tally() as outer:
        trace.count("a", 2)
        with trace.tally() as inner:
            trace.count("b")
        trace.count("a")
    assert outer == {"a": 3} and inner == {"b": 1} and trace.counters() == {}
    trace.enable()
    with trace.tally() as on:
        trace.count("c", 4)
    trace.count("c")
    assert on == {"c": 4} and trace.counters() == {"c": 1}

