"""Segment Anything (SAM) in PyTorch: image encoder ViT, prompt encoder,
mask decoder.

Port of ``gaussctrl_exp_tpu/segmentation/sam.py``. Parameters are named
with ``segment_anything``'s state-dict keys
(``image_encoder.blocks.0.attn.qkv.weight``, …), so a real
``sam_vit_h_4b8939.pth`` loads with ``strict=True`` once its pixel
statistics and mask-input downscaler are dropped (``convert.load_sam``).
Activations are channels-last (NHWC) as the JAX package's; the convolutions
permute to torch's NCHW around each call.

Numerics follow the JAX package, not ``segment_anything``, where the two
differ: every LayerNorm has ε = 1e-6 (the decoder's are Flax's default),
GELU is exact. The encoder's attention with its decomposed relative-position
bias is written out as plain products and a softmax, as the JAX side
computes it outside any Pallas kernel; at ViT-H's global blocks (16 heads,
4096 tokens) the fp32 scores take 1 GiB a block. No kernel of this package
runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.resize import jax_resize_bilinear


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """ViT-H operating point by default (the reference's sam_vit_h_4b8939)."""

    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280
    encoder_depth: int = 32
    encoder_heads: int = 16
    encoder_global_attn: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    prompt_dim: int = 256  # embedding dim of prompts & image neck
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_downsample: int = 2  # attention_downsample_rate
    num_multimask: int = 3
    mlp_ratio: float = 4.0

    @property
    def embed_hw(self) -> int:
        return self.img_size // self.patch_size


def vit_b_config() -> SAMConfig:
    return SAMConfig(encoder_dim=768, encoder_depth=12, encoder_heads=12, encoder_global_attn=(2, 5, 8, 11))


def vit_l_config() -> SAMConfig:
    return SAMConfig(encoder_dim=1024, encoder_depth=24, encoder_heads=16, encoder_global_attn=(5, 11, 17, 23))


LN_EPS = 1e-6


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A torch (NCHW) convolution applied to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class LayerNorm2d(nn.Module):
    """SAM's channel LayerNorm (ε 1e-6), over the last axis of NHWC."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * self.weight + self.bias


def _rel_pos_bias(rel_table: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """(2·max−1, head_dim) table → (q, k, head_dim) decomposed rel-pos slice."""
    dev = rel_table.device
    coords = torch.arange(q_size, device=dev)[:, None] - torch.arange(k_size, device=dev)[None, :] + (k_size - 1)
    return rel_table[coords]


class ViTAttention(nn.Module):
    """Multi-head attention with decomposed relative positions (SAM encoder);
    ``size`` is the side of the token grid it sees (a window or the whole
    patch grid)."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        hd = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        n, hd = self.heads, C // self.heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, n, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, heads, HW, hd)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        qr = q.reshape(B, n, H, W, hd)
        bias_h = torch.einsum("bnhwc,hkc->bnhwk", qr, _rel_pos_bias(self.rel_pos_h, H, H))
        bias_w = torch.einsum("bnhwc,wkc->bnhwk", qr, _rel_pos_bias(self.rel_pos_w, W, W))
        attn = attn.view(B, n, H, W, H, W) + bias_h[..., :, None] + bias_w[..., None, :]
        attn = torch.softmax(attn.view(B, n, H * W, H * W), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, H, W, C)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _gelu(x):
    return F.gelu(x, approximate="none")


class ViTBlock(nn.Module):
    """Pre-norm block; ``window`` > 0: attention inside ``window``² windows
    of the zero-padded grid, cropped back to (H, W)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), _gelu)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.norm1(x)
        w = self.window
        if w > 0:
            ph, pw = (-H) % w, (-W) % w
            h = F.pad(h, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            h = h.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
        h = self.attn(h)
        if w > 0:
            h = h.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]
        x = x + h
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return _nchw(self.proj, x)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg
        self.patch_embed = PatchEmbed(c.patch_size, c.encoder_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.embed_hw, c.embed_hw, c.encoder_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(c.encoder_dim, c.encoder_heads, c.mlp_ratio,
                     0 if i in c.encoder_global_attn else c.window_size, c.embed_hw)
            for i in range(c.encoder_depth))
        # neck → prompt_dim channels
        self.neck = nn.ModuleList([
            nn.Conv2d(c.encoder_dim, c.prompt_dim, 1, bias=False), LayerNorm2d(c.prompt_dim),
            nn.Conv2d(c.prompt_dim, c.prompt_dim, 3, padding=1, bias=False), LayerNorm2d(c.prompt_dim)])

    def forward(self, x):  # (B, img, img, 3) normalized
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[1](_nchw(self.neck[0], x))
        return self.neck[3](_nchw(self.neck[2], x))  # (B, embed_hw, embed_hw, prompt_dim)


def _pe_encode(coords01: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """PositionEmbeddingRandom: [0,1] coords → (…, 2·feat) sin/cos features."""
    c = (2.0 * coords01 - 1.0) @ gaussian  # (..., feat)
    c = 2.0 * np.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, feat: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn(2, feat))


class PromptEncoder(nn.Module):
    """Sparse (points/boxes) prompt embeddings + dense no-mask embedding:
    4 learned point embeddings (neg, pos, box-corner-1, box-corner-2), a
    not-a-point embedding, a random-gaussian positional encoder shared with
    the decoder's dense PE. The mask-input path (``mask_downscaling``) is
    not implemented, as in the JAX package."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.prompt_dim
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    @property
    def _gaussian(self):
        return self.pe_layer.positional_encoding_gaussian_matrix

    def embed_points(self, points, labels):
        """points: (B, P, 2) pixel coords; labels: (B, P) 1 pos / 0 neg / −1 pad."""
        pe = _pe_encode((points + 0.5) / self.cfg.img_size, self._gaussian)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        zero = torch.zeros((), dtype=pe.dtype, device=pe.device)
        return pe + torch.where(lab == 1, self.point_embeddings[1].weight[0],
                                torch.where(lab == 0, self.point_embeddings[0].weight[0], zero))

    def embed_boxes(self, boxes):
        """boxes: (B, 4) xyxy pixels → (B, 2, prompt_dim) corner embeddings."""
        pe = _pe_encode((boxes.reshape(-1, 2, 2) + 0.5) / self.cfg.img_size, self._gaussian)
        corner = torch.stack([self.point_embeddings[2].weight[0], self.point_embeddings[3].weight[0]])
        return pe + corner

    def dense_pe(self) -> torch.Tensor:
        """(embed_hw, embed_hw, prompt_dim) positional grid for the decoder."""
        hw = self.cfg.embed_hw
        g = (torch.arange(hw, dtype=torch.float32, device=self._gaussian.device) + 0.5) / hw
        coords = torch.stack(torch.meshgrid(g, g, indexing="xy"), dim=-1)  # (hw, hw, 2) x, y
        return _pe_encode(coords, self._gaussian)

    def forward(self, points=None, labels=None, boxes=None):
        parts = []
        if points is not None:
            parts.append(self.embed_points(points, labels))
        if boxes is not None:
            parts.append(self.embed_boxes(boxes))
        dev = self._gaussian.device
        sparse = torch.cat(parts, dim=1) if parts else torch.zeros(1, 0, self.cfg.prompt_dim, device=dev)
        return sparse, self.no_mask_embed.weight.reshape(1, 1, 1, -1)


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj = nn.Linear(dim, d), nn.Linear(dim, d), nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        n = self.heads

        def split(t):
            return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)

        qp, kp, vp = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = torch.einsum("bqhc,bkhc->bhqk", qp, kp) / math.sqrt(qp.shape[-1])
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", attn, vp)
        return self.out_proj(out.reshape(*q.shape[:-1], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        c = cfg
        P = c.prompt_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(P, c.decoder_heads)
        self.norm1 = nn.LayerNorm(P, eps=LN_EPS)
        self.cross_attn_token_to_image = DecoderAttention(P, c.decoder_heads, c.decoder_downsample)
        self.norm2 = nn.LayerNorm(P, eps=LN_EPS)
        self.mlp = MLPBlock(P, 2048 if P == 256 else P * 8, F.relu)
        self.norm3 = nn.LayerNorm(P, eps=LN_EPS)
        self.cross_attn_image_to_token = DecoderAttention(P, c.decoder_heads, c.decoder_downsample)
        self.norm4 = nn.LayerNorm(P, eps=LN_EPS)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = F.relu(lin(x))
        return self.layers[-1](x)


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayBlock(cfg, skip_first_layer_pe=(i == 0))
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(cfg.prompt_dim, cfg.decoder_heads, cfg.decoder_downsample)
        self.norm_final_attn = nn.LayerNorm(cfg.prompt_dim, eps=LN_EPS)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg
        P, n_tokens = c.prompt_dim, 1 + c.num_multimask
        self.cfg = cfg
        self.iou_token = nn.Embedding(1, P)
        self.mask_tokens = nn.Embedding(n_tokens, P)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(P, P // 4, 2, stride=2), LayerNorm2d(P // 4), nn.GELU(),
            nn.ConvTranspose2d(P // 4, P // 8, 2, stride=2), nn.GELU()])
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(P, P, P // 8) for _ in range(n_tokens))
        self.iou_prediction_head = MLP(P, P, n_tokens)

    def forward(self, image_embedding, image_pe, sparse_prompt, dense_prompt):
        """image_embedding: (B, hw, hw, D); sparse_prompt: (B, P, D);
        dense_prompt broadcastable to image_embedding.
        Returns (low_res_masks (B, 1+multi, 4·hw, 4·hw), iou_pred (B, 1+multi))."""
        c = self.cfg
        n_tokens = 1 + c.num_multimask
        B = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])[None].expand(B, -1, -1)
        tokens = torch.cat([out_tokens, sparse_prompt], dim=1)

        src = image_embedding + dense_prompt
        hw = src.shape[1]
        keys = src.reshape(B, hw * hw, c.prompt_dim)
        key_pe = image_pe.reshape(1, hw * hw, c.prompt_dim).expand(keys.shape)

        queries = tokens
        t = self.transformer
        for layer in t.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = t.norm_final_attn(queries + t.final_attn_token_to_image(q, k, keys))

        iou_out = queries[:, 0]
        mask_out = queries[:, 1 : 1 + n_tokens]

        # the 2×2-stride-2 transposed convs: out[2i+di, 2j+dj, o] =
        # Σc x[i, j, c]·W[c, o, di, dj] + b[o], W in torch's (C, out, 2, 2)
        up = self.output_upscaling
        src2 = _gelu(up[1](_nchw(up[0], keys.reshape(B, hw, hw, c.prompt_dim))))
        src2 = _gelu(_nchw(up[3], src2))  # (B, 4hw, 4hw, D/8)

        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper, src2)
        return masks, self.iou_prediction_head(iou_out)


class SAM(nn.Module):
    """Full SAM: encode once, prompt many times (SamPredictor's use,
    the reference's lang_sam.py:115-121)."""

    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, image):
        return self.image_encoder(image)

    def predict_boxes(self, image_embedding, boxes, multimask: bool = False):
        """boxes: (B, 4) xyxy in model-input pixel coords."""
        sparse, dense = self.prompt_encoder(boxes=boxes)
        masks, iou = self.mask_decoder(image_embedding, self.prompt_encoder.dense_pe(), sparse, dense)
        if multimask:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]

    def forward(self, image, boxes):
        return self.predict_boxes(self.encode_image(image), boxes)


# ImageNet-ish normalization SAM uses (pixel_mean/std in the torch ckpt)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_image(img_uint8: np.ndarray, img_size: int) -> tuple[np.ndarray, float]:
    """Resize longest side to img_size (PIL's bilinear), normalize, pad square
    (SamPredictor). Returns (batch (1, S, S, 3), scale factor original→model
    pixels)."""
    from PIL import Image

    h, w = img_uint8.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = np.asarray(Image.fromarray(img_uint8).resize((nw, nh), Image.BILINEAR), np.float32)
    norm = (resized - PIXEL_MEAN) / PIXEL_STD
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:nh, :nw] = norm
    return out[None], scale


def upscale_logits(low_res: torch.Tensor, scale: float, out_hw: tuple[int, int], img_size: int = 1024):
    """Low-res logits upsampled (``jax.image.resize``'s bilinear) to the
    model input, cropped to the image's resized extent, resized to the
    original (H, W)."""
    B, n, _, _ = low_res.shape
    up = jax_resize_bilinear(low_res, (B, n, img_size, img_size))
    oh, ow = out_hw
    nh, nw = int(round(oh * scale)), int(round(ow * scale))
    return jax_resize_bilinear(up[:, :, :nh, :nw], (B, n, oh, ow))


def postprocess_masks(low_res: torch.Tensor, scale: float, out_hw: tuple[int, int], img_size: int = 1024):
    """Upsampled logits thresholded at 0 (SamPredictor.postprocess_masks)."""
    return upscale_logits(low_res, scale, out_hw, img_size) > 0.0
