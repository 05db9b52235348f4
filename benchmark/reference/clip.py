"""Plain reference of LangSAM's text→box grounding with CLIP: the vision
tower's patch embeddings, the text features, the similarity heat map and
its boxes.

CLIP (Radford et al., arXiv:2103.00020; ``openai/clip-vit-large-patch14``)
as functions over a flat dict of float32 tensors named as transformers'
``CLIPModel`` (``vision_model.encoder.layers.0.self_attn.q_proj.weight``,
...), the measured program's names too. The vision tower: a patch
convolution without bias, the class token and position embeddings,
``pre_layrnorm``, pre-norm layers with QuickGELU, no ``post_layernorm`` on
the patch tokens, then ``visual_projection`` (the zero-shot OWL-ViT /
MaskCLIP recipe for patch embeddings). The text side: ``sd.clip_text``
pooled at the EOS token (the largest id) through ``text_projection``.

The boxes follow the recipe the program documents: cosine similarity of
each patch with the text, a threshold at ``min + rel_threshold·(max − min)``,
4-connected components (found here by propagating the smallest label,
not by the program's scan), components under ``min_area`` patches dropped,
a box per component in grid cells scaled to image pixels, scored by its
largest similarity, the ``max_boxes`` best kept.

Departures: the input image is resized straight to 224² by Pillow's
bilinear (``sam.pil_bilinear_uint8``), as the program does, where CLIP's
own preprocessing resizes the short side by bicubic and crops the centre.
Every product rounds its operands through ``precision.q``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import q
from .sam import pil_bilinear_uint8, to_uint8
from .sd import Params, clip_text, layer_norm, linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def pixels(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """An (H, W, 3) [0, 1] float or uint8 frame → (1, 3, size, size) CLIP input."""
    x = pil_bilinear_uint8(to_uint8(rgb), (size, size)).float() / 255.0
    x = (x - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(CLIP_STD, device=x.device)
    return x.permute(2, 0, 1)[None]


def _layer(P, n, x, d, heads, inter):
    B, T, _ = x.shape
    h = layer_norm(P, n + "layer_norm1", x, d, 1e-5)
    qq, kk, vv = (linear(P, n + f"self_attn.{s}_proj", h, d, d).reshape(B, T, heads, d // heads).transpose(1, 2)
                  for s in "qkv")
    s = torch.matmul(q(qq), q(kk).transpose(-1, -2)) * (d // heads) ** -0.5
    o = torch.matmul(q(torch.softmax(s, -1)), q(vv)).transpose(1, 2).reshape(B, T, d)
    x = x + linear(P, n + "self_attn.out_proj", o, d, d)
    h = linear(P, n + "mlp.fc1", layer_norm(P, n + "layer_norm2", x, d, 1e-5), d, inter)
    return x + linear(P, n + "mlp.fc2", h * torch.sigmoid(1.702 * h), inter, d)


def patch_embeddings(P, cfg, px):
    """(B, 3, S, S) CLIP input → (B, grid, grid, projection) patch embeddings."""
    v = cfg["vision"]
    d, ps, S = v["hidden_size"], v["patch_size"], v["image_size"]
    g = S // ps
    p = "vision_model."
    w = P(p + "embeddings.patch_embedding.weight", (d, 3, ps, ps), ("normal", 1.0 / math.sqrt(3 * ps * ps)))
    x = F.conv2d(q(px), q(w), stride=ps).flatten(2).transpose(1, 2)
    cls = P(p + "embeddings.class_embedding", (d,), ("normal", d**-0.5))
    pos = P(p + "embeddings.position_embedding.weight", (g * g + 1, d), ("normal", 0.02))
    x = torch.cat([cls.expand(x.shape[0], 1, d), x], dim=1) + pos[None]
    x = layer_norm(P, p + "pre_layrnorm", x, d, 1e-5)
    for i in range(v["num_hidden_layers"]):
        x = _layer(P, f"{p}encoder.layers.{i}.", x, d, v["num_attention_heads"], v["intermediate_size"])
    layer_norm(P, p + "post_layernorm", x[:, :1], d, 1e-5)  # the class token's; not on the patch tokens
    out = linear(P, "visual_projection", x[:, 1:], d, cfg["projection_dim"], bias=False)
    return out.reshape(x.shape[0], g, g, -1)


def text_features(P, cfg, ids):
    """(B, T) ids → (B, projection) text features, pooled at the largest id (EOS)."""
    h = clip_text(P, {"text": cfg["text"]}, ids)
    pooled = h[torch.arange(h.shape[0], device=h.device), ids.argmax(-1)]
    return linear(P, "text_projection", pooled, cfg["text"]["hidden_size"], cfg["projection_dim"], bias=False)


def heat_map(patches: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """(g, g, D) patch embeddings, (D,) text feature → (g, g) cosine similarity."""
    p = patches / torch.clamp(torch.linalg.vector_norm(patches, dim=-1, keepdim=True), min=1e-8)
    t = text / max(float(torch.linalg.vector_norm(text)), 1e-8)
    return torch.matmul(q(p), q(t))


def components(mask: np.ndarray) -> np.ndarray:
    """4-connected components of a boolean grid: each cell labelled with the
    smallest (1-based raster) index in its component, 0 off the mask."""
    h, w = mask.shape
    lab = np.where(mask, np.arange(1, h * w + 1).reshape(h, w), 0)
    big = h * w + 1
    while True:
        pad = np.pad(np.where(mask, lab, big), 1, constant_values=big)
        nb = np.minimum.reduce([pad[1:-1, 1:-1], pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]])
        new = np.where(mask, nb, 0)
        if np.array_equal(new, lab):
            return lab
        lab = new


def boxes(heat: np.ndarray, image_hw, rel_threshold: float, min_area: int, max_boxes: int, margin: float) -> dict:
    """The boxes of ``heat`` in image pixels (xyxy, the best first) and their
    scores; ``near`` when the comparison cannot hold box for box: a cell lies
    within ``margin``·(max − min) of the threshold, or two scores within it
    decide which boxes make the ``max_boxes`` cut."""
    heat = np.asarray(heat, np.float64)
    lo, hi = float(heat.min()), float(heat.max())
    if hi - lo < 1e-8:
        return dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0), near=True)
    thr = lo + rel_threshold * (hi - lo)
    tol = margin * (hi - lo)
    lab = components(heat >= thr)
    found = []
    for v in np.unique(lab[lab > 0]):
        ys, xs = np.nonzero(lab == v)
        if ys.size >= min_area:
            found.append((float(heat[ys, xs].max()), [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]))
    found.sort(key=lambda f: -f[0])
    scores = np.asarray([f[0] for f in found])
    near = bool((np.abs(heat - thr) < tol).any())
    if len(found) > max_boxes:
        near |= bool(scores[max_boxes - 1] - scores[max_boxes] < tol)
    gh, gw = heat.shape
    H, W = image_hw
    scale = np.array([W / gw, H / gh, W / gw, H / gh], np.float32)
    b = np.asarray([f[1] for f in found[:max_boxes]], np.float32).reshape(-1, 4) * scale
    return dict(boxes=b, scores=scores[:max_boxes], near=near)


def param_spec(cfg: dict) -> dict:
    """{name: (shape, initialiser)} of the CLIP model at ``cfg``, recorded on the meta device."""
    P = Params()
    S = cfg["vision"]["image_size"]
    patch_embeddings(P, cfg, torch.empty((1, 3, S, S), device="meta"))
    text_features(P, cfg, torch.zeros((1, 7), dtype=torch.long, device="meta"))
    P("logit_scale", (), ("zero",))
    return P.spec
