"""CLIP (vision and text towers with their projections) in PyTorch, for the
text→box grounder.

The JAX package loads transformers' ``FlaxCLIPModel`` from a local CLIP
directory (``segmentation/grounding.py:149-156``). This is the same network
written out, named as transformers' torch ``CLIPModel`` so its checkpoints
load without renaming:

- the vision tower: a patch convolution without bias, the class embedding,
  the position embedding, ``pre_layrnorm`` (transformers' spelling), the
  encoder layers of the port's ``diffusion/text_encoder.py`` without the
  causal mask, and ``post_layernorm`` on the class token only. The
  grounder reads the last hidden state's patch tokens, which do not pass
  through ``post_layernorm``.
- the text tower: the port's ``CLIPTextTransformer``, pooled at the EOS
  position as transformers' Flax CLIP does (the argmax of the ids when the
  config's ``eos_token_id`` is 2, else the first id equal to it), then
  ``text_projection``.

Attention is plain products and a softmax, as in the text tower: the JAX
side computes CLIP outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch
from torch import nn

from ..device import resolve_device
from ..diffusion.text_encoder import CLIPEncoder, CLIPTextConfig, CLIPTextTransformer


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT-L/14 at 224² (openai/clip-vit-large-patch14) by default."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# transformers' defaults (CLIPTextConfig, CLIPVisionConfig, CLIPConfig),
# for the fields a saved config.json leaves out
HF_TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                        num_attention_heads=8, max_position_embeddings=77, layer_norm_eps=1e-5,
                        eos_token_id=49407)
HF_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                          image_size=224, patch_size=32, layer_norm_eps=1e-5)
HF_PROJECTION_DIM = 512


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.grid**2 + 1, d)

    def forward(self, pixel_values):  # (B, 3, S, S)
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values) -> torch.Tensor:
        """(B, 3, S, S) normalised pixels → (B, 1 + grid², hidden) last
        hidden state (the class token first); ``post_layernorm`` is not
        applied."""
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x, 0.0)
        return x


class CLIPModel(nn.Module):
    def __init__(self, text: CLIPTextConfig = CLIPTextConfig(), vision: CLIPVisionConfig = CLIPVisionConfig(),
                 projection_dim: int = 768, eos_token_id: int = 2):
        super().__init__()
        self.eos_token_id = eos_token_id
        self.vision_config = vision
        self.text_model = CLIPTextTransformer(text)
        self.vision_model = CLIPVisionTransformer(vision)
        self.visual_projection = nn.Linear(vision.hidden_size, projection_dim, bias=False)
        self.text_projection = nn.Linear(text.hidden_size, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def get_text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids → (B, projection) pooled, projected text features."""
        ids = input_ids.long()
        h = self.text_model(ids)
        pos = ids.argmax(-1) if self.eos_token_id == 2 else (ids == self.eos_token_id).int().argmax(-1)
        return self.text_projection(h[torch.arange(h.shape[0], device=h.device), pos])

    def patch_embeddings(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) → (B, grid², projection): the last layer's patch
        tokens (no class token, no ``post_layernorm``) through
        ``visual_projection``, the grounder's patch embeddings."""
        return self.visual_projection(self.vision_model(pixel_values)[:, 1:])


def _fields(cls, cfg: dict, defaults: dict) -> dict:
    return {f: cfg.get(f, defaults[f]) for f in cls.__dataclass_fields__}


def load_clip(clip_dir: str | Path, device: str | torch.device = "cuda") -> CLIPModel:
    """A transformers CLIP directory (``config.json`` and ``*.safetensors``
    or ``*.bin`` weights) as a float32 ``CLIPModel`` in eval mode on
    ``device``. Fields the config leaves out take transformers' defaults."""
    from ..diffusion.convert import read_weights

    device = resolve_device(device)
    clip_dir = Path(clip_dir)
    cfg = json.loads((clip_dir / "config.json").read_text())
    tcfg, vcfg = cfg.get("text_config", {}), cfg.get("vision_config", {})
    for c in (tcfg, vcfg):
        if c.get("hidden_act", "quick_gelu") != "quick_gelu":
            raise ValueError(f"CLIP hidden_act {c['hidden_act']!r}: the port's CLIP layers use quick_gelu")
    text = CLIPTextConfig(**_fields(CLIPTextConfig, tcfg, HF_TEXT_DEFAULTS))
    vision = CLIPVisionConfig(**_fields(CLIPVisionConfig, vcfg, HF_VISION_DEFAULTS))
    eos = tcfg.get("eos_token_id", HF_TEXT_DEFAULTS["eos_token_id"])
    with torch.device("meta"):
        model = CLIPModel(text, vision, cfg.get("projection_dim", HF_PROJECTION_DIM), eos)
    sd = {k: v.float() for k, v in read_weights(clip_dir).items() if not k.endswith("position_ids")}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).requires_grad_(False).eval()
