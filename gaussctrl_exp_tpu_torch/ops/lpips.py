"""LPIPS perceptual distance (VGG16 trunk + per-layer linear heads).

Port of ``gaussctrl_exp_tpu/ops/lpips.py``. The modules take (B, H, W, 3)
images in [0, 1], as the JAX ones do, and compute in NCHW inside. Pretrained
VGG16 and LPIPS linear weights are not in the repository: ``load_lpips``
reads them from torch checkpoints at deployment, ``lpips_random`` makes
random weights for tests, and ``lpips_params_from_flax`` carries the JAX
package's Flax parameters across (HWIO kernels → OIHW).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device

# VGG16 feature config (conv channels per block, pre-pool)
_VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
# ImageNet normalization LPIPS uses (its "scaling layer")
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning the 5 pre-pool ReLU activations (NCHW)."""

    def __init__(self):
        super().__init__()
        convs, ci, cin = {}, 0, 3
        for widths in _VGG_BLOCKS:
            for w in widths:
                convs[f"conv_{ci}"] = nn.Conv2d(cin, w, 3, padding=1)
                cin, ci = w, ci + 1
        self.convs = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats, ci = [], 0
        for bi, widths in enumerate(_VGG_BLOCKS):
            for _ in widths:
                x = F.relu(self.convs[f"conv_{ci}"](x))
                ci += 1
            feats.append(x)
            if bi < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    """LPIPS distance: channel-normalized VGG features, 1×1 linear heads."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lins = nn.ModuleList(
            nn.Conv2d(widths[-1], 1, 1, bias=False) for widths in _VGG_BLOCKS
        )
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] → (B,) perceptual distances."""

        def norm_input(x):
            return ((x.permute(0, 3, 1, 2) * 2.0 - 1.0) - self.shift) / self.scale

        total = 0.0
        for lin, xa, xb in zip(self.lins, self.vgg(norm_input(a)), self.vgg(norm_input(b))):
            xa = xa / torch.clamp(torch.linalg.norm(xa, dim=1, keepdim=True), min=1e-10)
            xb = xb / torch.clamp(torch.linalg.norm(xb, dim=1, keepdim=True), min=1e-10)
            total = total + lin((xa - xb) ** 2).mean(dim=(1, 2, 3))
        return total


def lpips_random(seed: int = 0, device: str | torch.device = "cuda") -> LPIPS:
    """Random-weight LPIPS (tests and shape checks only), from ``seed``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LPIPS()
    return model.to(device).eval().requires_grad_(False)


def lpips_params_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's Flax ``LPIPS`` params → a state dict for :class:`LPIPS`."""
    sd = {}
    for ci in range(sum(len(w) for w in _VGG_BLOCKS)):
        p = params["vgg"][f"conv_{ci}"]
        sd[f"vgg.convs.conv_{ci}.weight"] = torch.tensor(np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"vgg.convs.conv_{ci}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))
    for li in range(len(_VGG_BLOCKS)):
        k = np.asarray(params[f"lin_{li}"]["kernel"], np.float32)
        sd[f"lins.{li}.weight"] = torch.tensor(k.transpose(3, 2, 0, 1))
    return sd


def convert_torch_lpips(vgg_state: dict, lin_state: dict) -> dict[str, torch.Tensor]:
    """torchvision VGG16 ``features.*`` + LPIPS ``lin*.model.1.weight`` →
    a state dict for :class:`LPIPS`."""
    sd, ci = {}, 0
    for k in sorted(vgg_state, key=lambda s: int(s.split(".")[1])):
        if not k.endswith("weight") or "features" not in k:
            continue
        w = torch.as_tensor(vgg_state[k])
        if w.ndim != 4:
            continue
        sd[f"vgg.convs.conv_{ci}.weight"] = w.float()
        sd[f"vgg.convs.conv_{ci}.bias"] = torch.as_tensor(vgg_state[k.replace("weight", "bias")]).float()
        ci += 1
    for li in range(len(_VGG_BLOCKS)):
        for name in (f"lin{li}.model.1.weight", f"lins.{li}.model.1.weight"):
            if name in lin_state:
                sd[f"lins.{li}.weight"] = torch.as_tensor(lin_state[name]).float()
                break
    return sd


def load_lpips(vgg_path: str, lin_path: str, device: str | torch.device = "cuda") -> LPIPS:
    """Load torch checkpoints (torchvision vgg16 state dict + LPIPS lins)."""
    device = resolve_device(device)
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    model = LPIPS()
    model.load_state_dict(convert_torch_lpips(vgg_sd, lin_sd))
    return model.to(device).eval().requires_grad_(False)
