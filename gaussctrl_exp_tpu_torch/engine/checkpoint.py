"""Splatfacto checkpoint import/export.

Port of the splatfacto part of ``gaussctrl_exp_tpu/engine/checkpoint.py``:
nerfstudio's ``_model.gauss_params.{means,scales,quats,features_dc,
features_rest,opacities}`` tensors ↔ a fixed-capacity :class:`GaussianState`.
Slots past the checkpoint's gaussians are padded with scales −10 and
opacity logit −10 and marked dead in the alive mask.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussians import PARAM_NAMES, GaussianState, params_from_numpy

_PREFIXES = ("_model.gauss_params.", "model.gauss_params.", "gauss_params.", "")
_PAD = {"scales": -10.0, "opacities": -10.0}


def import_splatfacto_checkpoint(
    ckpt_path: str | Path,
    capacity: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> tuple[GaussianState, int]:
    """Load a splatfacto torch checkpoint ({"step", "pipeline": state_dict},
    or the bare state_dict) into a GaussianState on ``device``."""
    device = resolve_device(device)
    raw = torch.load(str(ckpt_path), map_location="cpu", weights_only=True)
    step = int(raw.get("step", 0)) if isinstance(raw, dict) else 0
    sd = raw.get("pipeline", raw) if isinstance(raw, dict) else raw

    def find(name):
        for prefix in _PREFIXES:
            if prefix + name in sd:
                return sd[prefix + name].detach().cpu().numpy().astype(np.float32)
        raise KeyError(f"cannot find {name} in checkpoint (keys: {list(sd)[:8]}…)")

    arrays = {name: find(name) for name in PARAM_NAMES}
    n = arrays["means"].shape[0]
    arrays["opacities"] = arrays["opacities"].reshape(n, 1)
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint gaussians {n}")
    for name, x in arrays.items():
        pad = np.full((cap - n,) + x.shape[1:], _PAD.get(name, 0.0), np.float32)
        arrays[name] = np.concatenate([x, pad], axis=0)
    alive = torch.arange(cap, device=device) < n
    return GaussianState(params_from_numpy(arrays, device), alive), step


def export_splatfacto_checkpoint(state: GaussianState, path: str | Path, step: int = 0) -> None:
    """Write the alive gaussians as a splatfacto-compatible torch checkpoint."""
    idx = torch.nonzero(state.alive.cpu()).reshape(-1)
    sd = {
        f"_model.gauss_params.{name}": getattr(state.params, name).detach().cpu()[idx].clone()
        for name in PARAM_NAMES
    }
    torch.save({"step": step, "pipeline": sd}, str(path))
