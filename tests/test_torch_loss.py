"""PyTorch port vs the JAX package: SSIM, L1, PSNR, the splatfacto loss
(values and gradients) and LPIPS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.ops import lpips as jlpips
from gaussctrl_exp_tpu.ops import ssim as jssim
from gaussctrl_exp_tpu_torch.ops import lpips as tlpips
from gaussctrl_exp_tpu_torch.ops import ssim as tssim
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 on both sides with the same banded-matrix filter; sums in another
# order, so values and gradients agree to a few ulp of their scale
RTOL, ATOL = 1e-5, 1e-6


def _images(seed=0, H=48, W=40):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, (H, W, 3)), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["ssim", "l1", "psnr"])
def test_metric_value_and_grad(name):
    a, b = _images()
    jfn, tfn = getattr(jssim, name), getattr(tssim, name)
    jval, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.as_tensor(a).requires_grad_()
    tval = tfn(x, torch.as_tensor(b))
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=RTOL, atol=ATOL * np.abs(g).max())


def test_ssim_map_matches():
    a, b = _images(1)
    got = tssim.ssim_map(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jssim.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (48 - 10, 40 - 10, 3)  # 11×11 window, valid mode
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    same = tssim.ssim_map(torch.as_tensor(a), torch.as_tensor(a))
    torch.testing.assert_close(same, torch.ones_like(same))


def test_splatfacto_loss_value_metrics_and_grad():
    a, b = _images(2)

    def jloss(x):
        loss, m = jssim.splatfacto_loss(x, jnp.asarray(b), 0.2)
        return loss, m

    (jval, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(a))
    x = torch.as_tensor(a).requires_grad_()
    tval, tm = tssim.splatfacto_loss(x, torch.as_tensor(b), 0.2)
    tval.backward()
    assert set(tm) == set(jm) == {"l1", "ssim", "main_loss", "psnr"}
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tval.item(), 0.8 * tm["l1"].item() + 0.2 * (1 - tm["ssim"].item()), rtol=1e-6)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), g, rtol=RTOL, atol=ATOL * np.abs(g).max())


def test_lpips_matches_flax_with_the_same_weights():
    """Random Flax weights carried across; the port's convolutions run in
    float32 on the CPU, XLA's too, in another summation order over up to
    4608 terms per output, hence rtol 1e-4."""
    model, params = jlpips.lpips_random(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    port = tlpips.LPIPS()
    port.load_state_dict(tlpips.lpips_params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = port(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.shape == (2,) and np.all(np.abs(want) > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    r = tlpips.lpips_random(0, device="cpu")
    assert not any(p.requires_grad for p in r.parameters())


def _toy_torch_lpips_state(seed=0):
    """A torchvision-shaped VGG16 ``features.*`` state dict and LPIPS
    ``lin*.model.1.weight`` heads, random, at the real widths."""
    g = torch.Generator().manual_seed(seed)
    vgg, idx, cin = {}, 0, 3
    for widths in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)):
        for w in widths:
            vgg[f"features.{idx}.weight"] = torch.randn((w, cin, 3, 3), generator=g) * 0.05
            vgg[f"features.{idx}.bias"] = torch.randn((w,), generator=g) * 0.05
            cin, idx = w, idx + 2  # conv, relu
        idx += 1  # max pool
    lin = {f"lin{li}.model.1.weight": torch.rand((1, w, 1, 1), generator=g)
           for li, w in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


def test_convert_and_load_torch_lpips(tmp_path):
    vgg, lin = _toy_torch_lpips_state()
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lpips_lin.pth")
    model = tlpips.load_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "lpips_lin.pth"), device="cpu")
    _, jparams = jlpips.load_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "lpips_lin.pth"))
    want = tlpips.lpips_params_from_flax(jparams)
    got = model.state_dict()
    assert set(got) == set(want) and len(got) == 13 * 2 + 5
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert torch.equal(got["vgg.convs.conv_12.weight"], vgg["features.28.weight"])
