"""SSIM, L1, PSNR and the splatfacto training loss.

Port of ``gaussctrl_exp_tpu/ops/ssim.py``: ``(1−λ)·L1 + λ·(1−SSIM)`` with
λ = 0.2, SSIM with an 11×11 gaussian window (σ = 1.5), k1 = 0.01, k2 = 0.03,
data range 1, averaged over the valid (unpadded) region. The separable
filter is the same pair of banded matrix products (``X·B_w`` then
``B_hᵀ·X``), all five SSIM statistics in one batched contraction; float32
matrix products on the card run in full float32 unless TF32 is switched on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, size: int, sigma: float) -> np.ndarray:
    """(n, n−size+1) banded B with B[i, j] = kernel[i − j]: ``X @ B`` is the
    valid-mode 1-D gaussian filter along that axis."""
    k = _gaussian_kernel_1d(size, sigma)
    m = n - size + 1
    band = np.zeros((n, m), np.float32)
    for t in range(size):
        band[np.arange(m) + t, np.arange(m)] = k[t]
    return band


_BANDS: dict = {}


def _band(n: int, size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    key = (n, size, sigma, like.device, like.dtype)
    if key not in _BANDS:
        _BANDS[key] = torch.as_tensor(_band_matrix(n, size, sigma), dtype=like.dtype, device=like.device)
    return _BANDS[key]


def _filter_stack(stack: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """(C, H, W) → (C, H', W') valid-mode separable gaussian filter."""
    _, H, W = stack.shape
    out = torch.einsum("chw,wv->chv", stack, _band(W, size, sigma, stack))
    return torch.einsum("chv,hu->cuv", out, _band(H, size, sigma, stack))


def ssim_map(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-window SSIM between (H, W, C) images → (H−k+1, W−k+1, C)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    at, bt = a.permute(2, 0, 1), b.permute(2, 0, 1)
    stats = torch.cat([at, bt, at * at, bt * bt, at * bt], dim=0)  # (5C, H, W)
    f = _filter_stack(stats, kernel_size, sigma)
    C = a.shape[-1]
    mu_a, mu_b, mu_aa, mu_bb, mu_ab = (f[i * C : (i + 1) * C].permute(1, 2, 0) for i in range(5))
    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return num / den


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between (H, W, C) images."""
    return ssim_map(a, b, data_range, kernel_size, sigma, k1, k2).mean()


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = ((a - b) ** 2).mean()
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def splatfacto_loss(pred: torch.Tensor, gt: torch.Tensor, ssim_lambda: float = 0.2):
    """(1−λ)·L1 + λ·(1−SSIM) → (loss, metrics with l1, ssim, main_loss, psnr)."""
    l1_val = l1(pred, gt)
    ssim_val = ssim(pred, gt)
    loss = (1.0 - ssim_lambda) * l1_val + ssim_lambda * (1.0 - ssim_val)
    return loss, {"l1": l1_val, "ssim": ssim_val, "main_loss": loss, "psnr": psnr(pred, gt)}
