"""LangSAM-equivalent: text → boxes → SAM masks, with pluggable box providers.

Port of ``gaussctrl_exp_tpu/segmentation/lang_sam.py``. The reference vendors
Lang-SAM (GroundingDINO turns the text prompt into boxes, SAM turns boxes
into masks); the text→box stage is a protocol here:

  * ``PrecomputedBoxes`` reads per-image box sidecars (``boxes.json``),
  * ``FullImageBox`` degrades to the whole frame (mask ≈ everything),
  * ``grounding.ClipPatchBoxProvider`` grounds the text with CLIP,
  * any ``Callable[(image, text)] -> (boxes, phrases, logits)`` plugs in.

``LangSAM.predict(image, text)`` keeps the reference's return signature
(masks, boxes, phrases, logits), so the edit pipeline's mask compositing is
provider-agnostic. SAM runs on the device its parameters are on; the image
embedding is computed once per image and broadcast to every box.

Spans (``utils/trace.py``): ``seg.ground`` (the box provider), then, where
it found boxes, ``seg.sam.prep`` (the host resize, normalisation and
upload), ``seg.sam.encode`` and ``seg.sam.decode`` (device),
``seg.mask.upscale`` (device) and ``seg.mask.to_host`` (sync). Counters:
``seg.images``, ``seg.boxes`` (boxes prompted), ``seg.no_box`` (images
whose provider found none, so SAM did not run).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from .sam import SAM, postprocess_masks, preprocess_image

BoxResult = Tuple[np.ndarray, Sequence[str], np.ndarray]  # boxes xyxy, phrases, logits


class BoxProvider(Protocol):
    def __call__(self, image: np.ndarray, text: str) -> BoxResult: ...


class FullImageBox:
    """Whole-frame box — the no-detector fallback (masks everything)."""

    def __call__(self, image: np.ndarray, text: str) -> BoxResult:
        h, w = image.shape[:2]
        return np.array([[0.0, 0.0, w, h]], np.float32), [text], np.ones(1, np.float32)


class PrecomputedBoxes:
    """Boxes from a json sidecar: {"<image name>": [[x0,y0,x1,y1], ...], ...}."""

    def __init__(self, path: str | Path, key: Optional[str] = None):
        self.table = json.loads(Path(path).read_text())
        self.key = key

    def __call__(self, image: np.ndarray, text: str) -> BoxResult:
        if self.key is None or self.key not in self.table:
            raise KeyError(f"no precomputed boxes for {self.key!r}")
        boxes = np.asarray(self.table[self.key], np.float32).reshape(-1, 4)
        return boxes, [text] * len(boxes), np.ones(len(boxes), np.float32)

    def bind(self, key: str) -> "PrecomputedBoxes":
        out = PrecomputedBoxes.__new__(PrecomputedBoxes)
        out.table, out.key = self.table, key
        return out


class LangSAM:
    """predict(image_uint8, text) -> (masks, boxes, phrases, logits).

    Same call signature/ordering as the reference's LangSAM.predict
    (lang_sam.py:115-121). ``sam`` is a ``SAM`` (``convert.load_sam``);
    ``box_provider`` defaults to the whole-frame fallback.
    """

    def __init__(self, sam: SAM, box_provider: Optional[BoxProvider] = None):
        self.sam = sam
        self.cfg = sam.cfg
        self.box_provider = box_provider or FullImageBox()

    @property
    def device(self) -> torch.device:
        return self.sam.mask_decoder.iou_token.weight.device

    @torch.no_grad()
    def low_res_logits(self, image: np.ndarray, boxes: np.ndarray) -> tuple[torch.Tensor, float]:
        """SAM's (n_boxes, 1, 4·hw, 4·hw) mask logits for a uint8 image and
        its xyxy boxes in image pixels, with the image→model scale."""
        dev = self.device
        with trace.span("seg.sam.prep"):
            batch, scale = preprocess_image(image, self.cfg.img_size)
            batch = torch.as_tensor(batch, device=dev)
        with trace.span("seg.sam.encode", device=dev):
            emb = self.sam.encode_image(batch)
        with trace.span("seg.sam.decode", device=dev):
            emb = emb.expand(boxes.shape[0], *emb.shape[1:])
            low_res, _iou = self.sam.predict_boxes(emb, torch.as_tensor(boxes * scale, device=dev))
        return low_res, scale

    def predict(self, image: np.ndarray, text: str):
        trace.count("seg.images")
        with trace.span("seg.ground"):
            boxes, phrases, logits = self.box_provider(image, text)
        if boxes.shape[0] == 0:
            trace.count("seg.no_box")
            h, w = image.shape[:2]
            return np.zeros((0, h, w), bool), boxes, phrases, logits
        trace.count("seg.boxes", boxes.shape[0])
        low_res, scale = self.low_res_logits(image, boxes)
        with trace.span("seg.mask.upscale", device=self.device):
            masks = postprocess_masks(low_res, scale, image.shape[:2], self.cfg.img_size)
        with trace.span("seg.mask.to_host", sync=True):
            masks = masks[:, 0].cpu().numpy()
        return masks, boxes, phrases, logits

    def as_mask_provider(self):
        """Adapter to the edit pipeline's ``mask_provider`` slot
        (diffusion/pipeline.py): (rgb float[0,1] or uint8, text) → (H, W) f32
        union mask, the role Lang-SAM plays in ad_pipeline.py:154-158. A
        float image is truncated to uint8, as the JAX package does."""

        def provide(rgb: np.ndarray, text: str) -> np.ndarray:
            img = rgb if rgb.dtype == np.uint8 else (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            masks, _, _, _ = self.predict(img, text)
            if masks.shape[0] == 0:
                return np.zeros(img.shape[:2], np.float32)
            return masks.any(axis=0).astype(np.float32)

        return provide
