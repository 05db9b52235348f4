"""Tiny SAM and CLIP checkpoints, made from a seed, for the port's
segmentation tests, and the JAX package's references on them.

- SAM: seeded parameters of the JAX package's ``SAM`` at a tiny config
  (the relative-position tables and positional embedding nonzero), written
  as a segment_anything
  ``.pth`` through the JAX package's ``flax_to_torch_keys`` with the keys a
  real checkpoint also holds and neither package uses (``pixel_mean``,
  ``pixel_std``, ``prompt_encoder.mask_downscaling.*``).
- CLIP: transformers' torch ``CLIPModel`` at a tiny config, saved with
  ``save_pretrained`` beside the tokenizer's miniature vocabulary.
- ``jax_clip_grounder``: the JAX package's ``ClipPatchBoxProvider`` on the
  same directory. Its text side is the JAX package's ``load_clip_grounder``
  (transformers' ``FlaxCLIPModel`` through its ``from_pt=True`` branch).
  Its patch side is the same computation (grounding.py:161-173) with the
  vision tower reached through the Flax module: ``load_clip_grounder``'s own
  ``embed_patches`` calls ``model.vision_model``, which ``FlaxCLIPModel``
  does not have, and raises ``AttributeError``.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussctrl_exp_tpu.diffusion.tokenizer import make_test_vocab
from gaussctrl_exp_tpu.segmentation import grounding as jgrounding
from gaussctrl_exp_tpu.segmentation.convert import flax_to_torch_keys
from gaussctrl_exp_tpu.segmentation.sam import SAM as JSAM
from gaussctrl_exp_tpu.segmentation.sam import SAMConfig as JSAMConfig

# tests/test_segmentation.py's TINY
TINY = dict(img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2, encoder_heads=2, encoder_global_attn=(1,),
            window_size=4, prompt_dim=16, decoder_heads=2)
# a 10 × 10 patch grid in windows of 4: the windowed blocks pad to 12 and crop back
PADDED = dict(TINY, img_size=80, encoder_depth=3, encoder_global_attn=(1,))
# segment_anything's 8 decoder heads, which the port reads no checkpoint's shapes for
CLI = dict(TINY, prompt_dim=32, decoder_heads=8)
PARAM_NOISE = 0.1
SKIPPED = {"pixel_mean": (3, 1, 1), "pixel_std": (3, 1, 1),
           **{f"prompt_encoder.mask_downscaling.{i}.{p}": s for i, shapes in
              {0: ((4, 1, 2, 2), (4,)), 1: ((4,), (4,)), 3: ((16, 4, 2, 2), (16,)), 4: ((16,), (16,)),
               6: ((16, 16, 1, 1), (16,))}.items() for p, s in zip(("weight", "bias"), shapes)}}


def jax_sam_params(cfg: dict, seed: int = 0) -> dict:
    """Seeded parameters of the JAX SAM's tree at ``cfg`` (numpy leaves;
    shapes from ``jax.eval_shape``, no eager init): Dense and conv kernels
    normal over √fan-in, norm scales 1 + noise, learned embeddings and the
    positional gaussian normal, the rest (biases, positional embedding,
    relative-position tables) noise."""
    c = JSAMConfig(**cfg)
    img = jnp.zeros((1, c.img_size, c.img_size, 3))
    shapes = jax.eval_shape(JSAM(c).init, jax.random.PRNGKey(0), img, jnp.asarray([[8.0, 8.0, 40.0, 48.0]]))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(shape[:-1]))
        if name == "scale" or (name == "weight" and len(shape) == 1):
            return 1 + PARAM_NOISE * n
        if name.endswith(".weight") and len(shape) == 4:  # transposed conv (C, out, 2, 2)
            return n / np.sqrt(shape[0])
        if name.endswith(".weight") or name.endswith("matrix"):
            return n
        return PARAM_NOISE * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def write_sam_pth(path: Path, params: dict) -> Path:
    """``params`` as a segment_anything-keyed ``.pth``, with the keys a real
    checkpoint holds that neither package uses."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flax_to_torch_keys(params).items()}
    rng = np.random.default_rng(1)
    sd.update({k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in SKIPPED.items()})
    torch.save(sd, str(path))
    return path


def write_tiny_clip(root: Path, seed: int = 0) -> Path:
    """transformers' torch CLIPModel at tiny widths, saved to ``root`` with
    the miniature vocabulary (vocab.json, merges.txt)."""
    import transformers

    root.mkdir(parents=True, exist_ok=True)
    vocab, merges = make_test_vocab()
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77),
        vision_config=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                           image_size=28, patch_size=7),
        projection_dim=24)
    torch.manual_seed(seed)
    transformers.CLIPModel(cfg).save_pretrained(str(root))
    return root


def jax_clip_grounder(root: Path, **kw) -> jgrounding.ClipPatchBoxProvider:
    """The JAX package's grounder on ``root`` (see the module docstring)."""
    from PIL import Image
    from transformers import FlaxCLIPModel

    text_side = jgrounding.load_clip_grounder(str(root), **kw)
    model = FlaxCLIPModel.from_pretrained(str(root), from_pt=True)
    size, patch = model.config.vision_config.image_size, model.config.vision_config.patch_size
    vision = jax.jit(lambda params, px: model.module.apply(
        {"params": params}, px, method=lambda m, x: m.vision_model(pixel_values=x)).last_hidden_state)

    def embed_patches(image: np.ndarray) -> np.ndarray:
        img = image if image.dtype == np.uint8 else (np.clip(image, 0, 1) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR), np.float32) / 255.0
        mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
        std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
        pixel = ((img - mean) / std)[None]  # the Flax module takes NHWC
        last = vision(model.params, jnp.asarray(pixel))
        vp = np.asarray(model.params["visual_projection"]["kernel"])
        g = size // patch
        return (np.asarray(last[0, 1:]) @ vp).reshape(g, g, -1)

    return jgrounding.ClipPatchBoxProvider(embed_patches, text_side.embed_text, text_side.rel_threshold,
                                           text_side.min_area, text_side.max_boxes)


def jax_upscaled_logits(low_res, scale: float, out_hw, img_size: int) -> np.ndarray:
    """The JAX package's ``postprocess_masks`` (sam.py:415-426) before its
    threshold."""
    B, n = low_res.shape[:2]
    up = jax.image.resize(jnp.asarray(low_res), (B, n, img_size, img_size), "bilinear")
    oh, ow = out_hw
    up = up[:, :, : int(round(oh * scale)), : int(round(ow * scale))]
    return np.asarray(jax.image.resize(up, (B, n, oh, ow), "bilinear"))


def jax_langsam_logits(ls, image: np.ndarray, text: str):
    """The JAX ``LangSAM.predict``'s boxes and its upsampled logits
    (n_boxes, H, W) on a uint8 image."""
    from gaussctrl_exp_tpu.segmentation.sam import preprocess_image

    boxes, _, _ = ls.box_provider(image, text)
    batch, scale = preprocess_image(image, ls.cfg.img_size)
    emb = ls._encode(ls.params, batch)
    emb = np.broadcast_to(np.asarray(emb), (boxes.shape[0], *emb.shape[1:]))
    low_res, _ = ls._predict(ls.params, emb, boxes * scale)
    return boxes, jax_upscaled_logits(low_res, scale, image.shape[:2], ls.cfg.img_size)[:, 0]
