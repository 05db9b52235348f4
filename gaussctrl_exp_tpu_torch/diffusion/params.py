"""The JAX package's Flax parameter trees → the port's state dicts.

Each function takes a tree of nested dicts of arrays (``unet_params``,
``controlnet_params``, ``vae_params`` of the JAX package's ``SDModels``, a
``DepthGenerator``'s ``unet_params``, or ``FlaxCLIPTextModel.params``) and
returns the state dict that the matching port module loads with
``load_state_dict(strict=True)``; the depth generator's 5-channel
``conv_in`` needs nothing more than the UNet's rename. The JAX package's
bf16 depth generator (``init_depth_generator(dtype=jnp.bfloat16)``) keeps
float32 parameters, Flax's ``param_dtype``, so they carry across unchanged
into the port's generator, whose parameters are float32 too and whose UNet
computes in bf16 (``UNet2DCondition(compute_dtype=...)``). The module names of
the port mirror the Flax ones, so the mapping is mechanical:

  * conv ``kernel`` (kh, kw, I, O) → ``weight`` (O, I, kh, kw)
  * dense ``kernel`` (I, O) → ``weight`` (O, I)
  * norm ``scale`` → ``weight``; embedding ``embedding`` → ``weight``
  * ``bias`` → ``bias``; nested names joined with dots.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def state_dict_from_flax(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(state_dict_from_flax(value, f"{prefix}{key}."))
            continue
        a = np.asarray(value, dtype=np.float32)
        if key == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            key = "weight"
        elif key in ("scale", "embedding"):
            key = "weight"
        elif key != "bias":
            raise ValueError(f"unknown Flax parameter {prefix}{key}")
        out[f"{prefix}{key}"] = torch.tensor(a)
    return out


# one mapping serves every module: the names already agree
unet_params_from_flax = controlnet_params_from_flax = vae_params_from_flax = state_dict_from_flax
clip_params_from_flax = state_dict_from_flax  # FlaxCLIPTextModel.params (text_model/...)
