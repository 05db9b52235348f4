"""SAM checkpoints for ``segmentation/sam.py``.

Port of ``gaussctrl_exp_tpu/segmentation/convert.py``. The port's modules
carry ``segment_anything``'s state-dict names and layouts, so a
``sam_vit_*.pth`` loads as it stands: ``load_sam`` drops exactly what the
JAX converter skips (the pixel statistics and the mask-input downscaler,
which neither package implements) and refuses any other key it cannot
place. ``sam_state_dict_from_flax`` goes the other way from the JAX
package's parameters: it undoes the Dense transpose and the HWIO convs.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .sam import SAM, SAMConfig

_SKIP = re.compile(r"pixel_mean|pixel_std|prompt_encoder\.mask_downscaling")
DECODER_HEADS = 8  # segment_anything's TwoWayTransformer(num_heads=8); not in the weights' shapes


def sam_config_from_state_dict(sd: dict, decoder_heads: int = DECODER_HEADS) -> SAMConfig:
    """The ``SAMConfig`` a segment_anything state dict was built with, read
    from its shapes: ViT-H, -L and -B and the tests' tiny ones. A block
    whose relative-position table spans the whole patch grid is global; the
    others give the window."""
    patch = sd["image_encoder.patch_embed.proj.weight"].shape[-1]
    hw = sd["image_encoder.pos_embed"].shape[1]
    dim = sd["image_encoder.pos_embed"].shape[-1]
    depth = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"image_encoder\.blocks\.(\d+)\.", k)))
    tables = [sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape for i in range(depth)]
    global_attn = tuple(i for i, t in enumerate(tables) if t[0] == 2 * hw - 1)
    windows = {(t[0] + 1) // 2 for i, t in enumerate(tables) if i not in global_attn}
    if len(windows) > 1:
        raise ValueError(f"SAM checkpoint with several window sizes {sorted(windows)}")
    prompt = sd["image_encoder.neck.0.weight"].shape[0]
    dec_depth = 1 + max(int(m.group(1)) for k in sd
                        if (m := re.match(r"mask_decoder\.transformer\.layers\.(\d+)\.", k)))
    cross = sd["mask_decoder.transformer.layers.0.cross_attn_token_to_image.q_proj.weight"].shape[0]
    return SAMConfig(
        img_size=hw * patch, patch_size=patch, encoder_dim=dim, encoder_depth=depth,
        encoder_heads=dim // tables[0][1], encoder_global_attn=global_attn,
        window_size=windows.pop() if windows else SAMConfig.window_size, prompt_dim=prompt,
        decoder_depth=dec_depth, decoder_heads=decoder_heads, decoder_downsample=prompt // cross,
        num_multimask=sd["mask_decoder.mask_tokens.weight"].shape[0] - 1,
        mlp_ratio=sd["image_encoder.blocks.0.mlp.lin1.weight"].shape[0] / dim)


def load_sam(ckpt_path: str | Path, cfg: SAMConfig | None = None, device: str | torch.device = "cuda") -> SAM:
    """A ``sam_vit_*.pth`` (segment_anything's state dict) as a ``SAM`` in
    eval mode on ``device``, float32. ``cfg`` defaults to the one the
    weights' shapes give (``sam_config_from_state_dict``)."""
    device = resolve_device(device)
    sd = torch.load(str(ckpt_path), map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not _SKIP.search(k)}
    cfg = cfg or sam_config_from_state_dict(sd)
    with torch.device("meta"):
        model = SAM(cfg)
    unmatched = sorted(set(sd) - set(model.state_dict()))
    if unmatched:
        raise ValueError(f"unconverted SAM keys: {unmatched[:8]}{'…' if len(unmatched) > 8 else ''}")
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    return model.to(device).requires_grad_(False).eval()


def sam_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's SAM parameters (``{"params": …}`` or the tree under
    it, numpy leaves) → the port's state dict: Dense kernels transposed,
    conv kernels HWIO → OIHW, LayerNorm ``scale`` → ``weight``, the rest as
    they are (the transposed convs are in torch's layout on both sides)."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [k])
            return
        w, leaf, stem = np.asarray(node, np.float32), path[-1], ".".join(path[:-1])
        if leaf == "kernel":
            w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T
            key = f"{stem}.weight"
        elif leaf == "scale":
            key = f"{stem}.weight"
        else:
            key = ".".join(path)
        out[key] = torch.from_numpy(np.ascontiguousarray(w))

    walk(tree, [])
    return out
