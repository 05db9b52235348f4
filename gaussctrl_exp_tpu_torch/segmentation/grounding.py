"""Open-vocabulary text→box grounding (CLIP patch-similarity proposal).

Port of ``gaussctrl_exp_tpu/segmentation/grounding.py``, which replaces the
GroundingDINO stage of the reference's Lang-SAM with the zero-shot core of
the OWL-ViT recipe:

  1. embed the image's PATCH grid with a CLIP vision tower (the patch tokens
     of the last layer, through the visual projection),
  2. embed the text query with the CLIP text tower (+ projection),
  3. cosine-similarity heat map over the patch grid,
  4. relative thresholding + connected components → axis-aligned boxes with
     per-box scores (max similarity inside the component).

The heat map and box code is the port's own copy of the JAX package's numpy
(the same arithmetic, so the same boxes for the same embeddings). The
encoders are pluggable callables; ``load_clip_grounder`` builds them on the
port's ``clip_vision.CLIPModel``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..utils.resize import pil_bilinear_uint8

BoxResult = Tuple[np.ndarray, Sequence[str], np.ndarray]

# CLIP's image normalisation (the JAX package's grounding.py:166-167)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def similarity_heatmap(patch_emb: np.ndarray, text_emb: np.ndarray) -> np.ndarray:
    """(gh, gw, D) patch embeddings × (D,) text embedding → (gh, gw) cosine
    similarity in [-1, 1]."""
    p = np.asarray(patch_emb, np.float32)
    t = np.asarray(text_emb, np.float32)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-8)
    t = t / max(np.linalg.norm(t), 1e-8)
    return p @ t


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """4-connected labeling of a boolean grid → int labels (0 = background).
    Plain BFS — the grid is a patch grid (≤ ~64²), host-side cost is nil."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    cur = 0
    for sy in range(h):
        for sx in range(w):
            if not mask[sy, sx] or labels[sy, sx]:
                continue
            cur += 1
            stack = [(sy, sx)]
            labels[sy, sx] = cur
            while stack:
                y, x = stack.pop()
                for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                    if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not labels[ny, nx]:
                        labels[ny, nx] = cur
                        stack.append((ny, nx))
    return labels


def heatmap_to_boxes(
    heat: np.ndarray,
    rel_threshold: float = 0.75,
    min_area: int = 2,
    max_boxes: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Heat map → (boxes (k, 4) in GRID coords [x0, y0, x1, y1), scores (k,)).

    Thresholding is RELATIVE (≥ min + rel_threshold·(max−min)): CLIP cosine
    similarities live on an arbitrary affine scale per image/prompt;
    components below ``min_area`` patches are noise-culled. Equal scores
    keep ``argsort(...)[::-1]``'s order.
    """
    heat = np.asarray(heat, np.float32)
    lo, hi = float(heat.min()), float(heat.max())
    if hi - lo < 1e-8:
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    labels = _connected_components(heat >= lo + rel_threshold * (hi - lo))
    boxes, scores = [], []
    for lab in range(1, labels.max() + 1):
        ys, xs = np.nonzero(labels == lab)
        if ys.size < min_area:
            continue
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        scores.append(float(heat[ys, xs].max()))
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    order = np.argsort(scores)[::-1][:max_boxes]
    return np.asarray(boxes, np.float32)[order], np.asarray(scores, np.float32)[order]


class ClipPatchBoxProvider:
    """BoxProvider: text → boxes via CLIP patch/text embedding similarity.

    Args:
      embed_patches: (H, W, 3) uint8/float image → (gh, gw, D) patch embeddings.
      embed_text: str → (D,) text embedding.
      rel_threshold/min_area/max_boxes: see :func:`heatmap_to_boxes`.
    """

    def __init__(
        self,
        embed_patches: Callable[[np.ndarray], np.ndarray],
        embed_text: Callable[[str], np.ndarray],
        rel_threshold: float = 0.75,
        min_area: int = 2,
        max_boxes: int = 8,
    ):
        self.embed_patches = embed_patches
        self.embed_text = embed_text
        self.rel_threshold = rel_threshold
        self.min_area = min_area
        self.max_boxes = max_boxes
        self._text_cache: dict[str, np.ndarray] = {}

    def __call__(self, image: np.ndarray, text: str) -> BoxResult:
        if text not in self._text_cache:
            self._text_cache[text] = np.asarray(self.embed_text(text), np.float32)
        patch = np.asarray(self.embed_patches(image), np.float32)
        heat = similarity_heatmap(patch, self._text_cache[text])
        gboxes, scores = heatmap_to_boxes(heat, self.rel_threshold, self.min_area, self.max_boxes)
        H, W = image.shape[:2]
        gh, gw = heat.shape
        scale = np.array([W / gw, H / gh, W / gw, H / gh], np.float32)
        return gboxes * scale, [text] * len(gboxes), scores


def clip_pixels(image: np.ndarray, size: int) -> np.ndarray:
    """An (H, W, 3) uint8 or [0, 1] float image → (1, 3, size, size) CLIP
    input: truncated to uint8, PIL's bilinear resize, CLIP's normalisation."""
    img = image if image.dtype == np.uint8 else (np.clip(image, 0, 1) * 255).astype(np.uint8)
    img = pil_bilinear_uint8(img, (size, size)).astype(np.float32) / 255.0
    return ((img - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)[None]


def load_clip_grounder(
    clip_dir: str,
    rel_threshold: float = 0.75,
    min_area: int = 2,
    max_boxes: int = 8,
    device: str | torch.device = "cuda",
) -> ClipPatchBoxProvider:
    """The provider on a local CLIP checkpoint directory (transformers
    layout — config.json + weights + vocab.json/merges.txt), run on
    ``device``. The patch embeddings are the vision tower's last-layer patch
    tokens through ``visual_projection`` — the zero-shot OWL-ViT/MaskCLIP
    recipe."""
    from ..diffusion.tokenizer import CLIPTokenizer
    from .clip_vision import load_clip

    model = load_clip(clip_dir, device)
    tok = CLIPTokenizer.from_pretrained(clip_dir)
    vcfg = model.vision_config
    dev = model.visual_projection.weight.device

    @torch.no_grad()
    def embed_patches(image: np.ndarray) -> np.ndarray:
        pixel = torch.as_tensor(clip_pixels(image, vcfg.image_size), device=dev)
        emb = model.patch_embeddings(pixel)[0].cpu().numpy()
        return emb.reshape(vcfg.grid, vcfg.grid, -1)

    @torch.no_grad()
    def embed_text(text: str) -> np.ndarray:
        ids = torch.as_tensor(tok([text]), device=dev)
        return model.get_text_features(ids)[0].cpu().numpy()

    return ClipPatchBoxProvider(embed_patches, embed_text, rel_threshold, min_area, max_boxes)
