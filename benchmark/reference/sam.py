"""Plain reference of Segment Anything (SAM) as LangSAM prompts it with boxes:
the image preprocessing, the ViT image encoder, the prompt encoder's box
embeddings, the two-way mask decoder and the upscaling of its logits.

Written from Kirillov et al., "Segment Anything" (arXiv:2304.02643) and
``facebookresearch/segment-anything`` (``build_sam_vit_h``, ``SamPredictor``)
as functions over a flat dict of float32 tensors named by segment_anything's
state-dict keys (``image_encoder.blocks.0.attn.qkv.weight``, ...), the
measured program's names too. Activations are channels-last inside the
encoder, as segment_anything's. Every product rounds its operands through
``precision.q``; norms, softmax, GELU and the resizes run in float32. The
global blocks' attention runs one head at a time, so that ViT-H's 4096-token
scores take 64 MiB, not 1 GiB.

Departures from segment_anything:

- the input is resized by Pillow's 8-bit bilinear (``pil_bilinear_uint8``
  below calls Pillow), as LangSAM's ``to_pil_image`` + ``resize`` path and
  the program do; segment_anything's own ``ResizeLongestSide.apply_image``
  does the same through PIL;
- the low-res logits are upscaled by an antialiased bilinear resize
  (triangle filter widened when it downscales), as the program's JAX
  lineage does (``jax.image.resize``); segment_anything's
  ``postprocess_masks`` calls ``F.interpolate`` without antialiasing. At a
  2× downscale of a 4× bilinear upscale the two differ by far less than the
  check's mask margin;
- LayerNorms follow segment_anything: ε = 1e-6 in the encoder and in
  ``LayerNorm2d``, torch's 1e-5 in the decoder's ``TwoWayTransformer``
  (``cfg["decoder_ln_eps"]`` overrides it). The program uses 1e-6 there too
  (its JAX lineage's Flax default): at the tests' tiny widths the low-res
  logits then differ by up to ~1e-4 of their largest, by ~1e-6 at equal ε;
- no point, mask-input or multimask path: LangSAM prompts boxes alone and
  keeps the first mask (``multimask_output=False``).

``Params`` (from ``sd.py``) run on the meta device records each parameter's
name, shape and initialiser: ``param_spec`` is the list the benchmark fills
from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .precision import q
from .sd import Params, _fan, layer_norm, linear

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
ENC_EPS, DEC_EPS = 1e-6, 1e-5
REL_POS_STD = 0.1  # random relative-position tables (segment_anything zero-initialises them; trained ones are not)


def _conv(P, name, x, cin, cout, k, stride=1, padding=0, bias=True):
    w = P(f"{name}.weight", (cout, cin, k, k), _fan(1.0, cin * k * k))
    b = P(f"{name}.bias", (cout,), ("zero",)) if bias else None
    return F.conv2d(q(x), q(w), b, stride, padding)


# ------------------------------------------------------------ preprocessing
def pil_bilinear_uint8(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Pillow's ``resize((w, h), BILINEAR)`` of an (H, W, C) uint8 image, on the host."""
    out = Image.fromarray(img.cpu().numpy()).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
    return torch.as_tensor(np.array(out), device=img.device)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """A [0, 1] float frame truncated to uint8, as LangSAM's caller does."""
    return rgb if rgb.dtype == torch.uint8 else (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)


def preprocess(img: torch.Tensor, img_size: int) -> tuple[torch.Tensor, float]:
    """(H, W, 3) uint8 → ((1, 3, S, S) normalised input padded bottom-right,
    the scale from image to model pixels): ``ResizeLongestSide`` then
    ``Sam.preprocess``."""
    h, w = img.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = pil_bilinear_uint8(img, (nh, nw)).float()
    x = (x - torch.tensor(PIXEL_MEAN, device=x.device)) / torch.tensor(PIXEL_STD, device=x.device)
    out = torch.zeros((1, 3, img_size, img_size), device=x.device)
    out[0, :, :nh, :nw] = x.permute(2, 0, 1)
    return out, scale


# ----------------------------------------------------------- image encoder
def _rel_pos(table: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """``get_rel_pos`` at equal sizes: the (q, k, C) slice of the table."""
    coords = torch.arange(q_size, device=table.device)[:, None] - torch.arange(k_size, device=table.device)[None, :]
    return table[coords + (k_size - 1)]


def vit_attention(P, name, x, heads, size):
    """Multi-head attention of (B, H, W, C) tokens with the decomposed
    relative-position bias (``add_decomposed_rel_pos``), one head at a time."""
    B, H, W, C = x.shape
    hd = C // heads
    qkv = linear(P, f"{name}.qkv", x.reshape(B, H * W, C), C, 3 * C).reshape(B, H * W, 3, heads, hd)
    Rh = _rel_pos(P(f"{name}.rel_pos_h", (2 * size - 1, hd), ("normal", REL_POS_STD)), H, H)
    Rw = _rel_pos(P(f"{name}.rel_pos_w", (2 * size - 1, hd), ("normal", REL_POS_STD)), W, W)
    out = torch.empty((B, H * W, heads, hd), device=x.device)
    for h in range(heads):
        qh, kh, vh = qkv[:, :, 0, h], qkv[:, :, 1, h], qkv[:, :, 2, h]
        s = torch.matmul(q(qh) * hd**-0.5, q(kh).transpose(1, 2))
        r = q(qh.reshape(B, H, W, hd))
        rel_h = torch.einsum("bhwc,hkc->bhwk", r, q(Rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r, q(Rw))
        s = s.view(B, H, W, H, W) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
        p = torch.softmax(s.view(B, H * W, H * W), dim=-1)
        out[:, :, h] = torch.matmul(q(p), q(vh))
    return linear(P, f"{name}.proj", out.reshape(B, H, W, C), C, C)


def window_partition(x, ws):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def window_unpartition(x, ws, pad_hw, hw):
    (Hp, Wp), (H, W) = pad_hw, hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def encode(P, cfg, img):
    """(B, 3, S, S) normalised input → (B, hw, hw, prompt_dim) image embedding."""
    c = cfg
    d, hw = c["encoder_dim"], c["img_size"] // c["patch_size"]
    p = "image_encoder."
    x = _conv(P, p + "patch_embed.proj", img, 3, d, c["patch_size"], c["patch_size"]).permute(0, 2, 3, 1)
    x = x + P(p + "pos_embed", (1, hw, hw, d), ("normal", 0.02))
    for i in range(c["encoder_depth"]):
        n = f"{p}blocks.{i}."
        ws = 0 if i in c["encoder_global_attn"] else c["window_size"]
        h = layer_norm(P, n + "norm1", x, d, ENC_EPS)
        if ws:
            h, pad_hw = window_partition(h, ws)
        h = vit_attention(P, n + "attn", h, c["encoder_heads"], ws or hw)
        if ws:
            h = window_unpartition(h, ws, pad_hw, (hw, hw))
        x = x + h
        m = int(d * c["mlp_ratio"])
        h = F.gelu(linear(P, n + "mlp.lin1", layer_norm(P, n + "norm2", x, d, ENC_EPS), d, m))
        x = x + linear(P, n + "mlp.lin2", h, m, d)
    D = c["prompt_dim"]
    x = _conv(P, p + "neck.0", x.permute(0, 3, 1, 2), d, D, 1, bias=False).permute(0, 2, 3, 1)
    x = layer_norm(P, p + "neck.1", x, D, ENC_EPS)
    x = _conv(P, p + "neck.2", x.permute(0, 3, 1, 2), D, D, 3, padding=1, bias=False).permute(0, 2, 3, 1)
    return layer_norm(P, p + "neck.3", x, D, ENC_EPS)


# ---------------------------------------------------------- prompt encoder
def _pe(P, cfg, coords01):
    """``PositionEmbeddingRandom._pe_encoding`` of [0, 1] coordinates (…, 2)."""
    g = P("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", (2, cfg["prompt_dim"] // 2), ("normal", 1.0))
    c = 2 * math.pi * torch.matmul(q(2 * coords01 - 1), q(g))
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def embed_boxes(P, cfg, boxes):
    """(B, 4) xyxy boxes in model pixels → (B, 2, prompt_dim) corner embeddings."""
    D = cfg["prompt_dim"]
    pe = _pe(P, cfg, (boxes.reshape(-1, 2, 2) + 0.5) / cfg["img_size"])
    emb = [P(f"prompt_encoder.point_embeddings.{i}.weight", (1, D), ("normal", 1.0)) for i in range(4)]
    for name in ("not_a_point_embed", "no_mask_embed"):
        P(f"prompt_encoder.{name}.weight", (1, D), ("normal", 1.0))
    return pe + torch.cat([emb[2], emb[3]])[None]


def dense_pe(P, cfg):
    """``get_dense_pe``: (hw, hw, prompt_dim) over the embedding's grid."""
    hw = cfg["img_size"] // cfg["patch_size"]
    g = (torch.arange(hw, dtype=torch.float32, device=_device(P)) + 0.5) / hw
    y, x = torch.meshgrid(g, g, indexing="ij")
    return _pe(P, cfg, torch.stack([x, y], dim=-1))


def _device(P):
    return "meta" if P.t is None else next(iter(P.t.values())).device


# ------------------------------------------------------------ mask decoder
def dec_attention(P, name, qx, kx, vx, dim, heads, down=1):
    d = dim // down
    B = qx.shape[0]

    def heads_of(t, s):
        return linear(P, f"{name}.{s}_proj", t, dim, d).reshape(B, -1, heads, d // heads).transpose(1, 2)

    qh, kh, vh = heads_of(qx, "q"), heads_of(kx, "k"), heads_of(vx, "v")
    a = torch.softmax(torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(d // heads), dim=-1)
    out = torch.matmul(q(a), q(vh)).transpose(1, 2).reshape(B, -1, d)
    return linear(P, f"{name}.out_proj", out, d, dim)


def _mlp(P, name, x, dims):
    """segment_anything's ``MLP``: ReLU between its linear layers."""
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        x = linear(P, f"{name}.layers.{i}", x, a, b)
        if i < len(dims) - 2:
            x = F.relu(x)
    return x


def decode(P, cfg, emb, boxes):
    """Image embedding (hw, hw, D) or (B, hw, hw, D) and (B, 4) boxes in model
    pixels → ((B, 1, 4·hw, 4·hw) low-res logits, (B, 1) IoU prediction)."""
    c = cfg
    D, nh, down = c["prompt_dim"], c["decoder_heads"], c["decoder_downsample"]
    n_tok = 1 + c["num_multimask"]
    eps = c.get("decoder_ln_eps", DEC_EPS)
    p, t = "mask_decoder.", "mask_decoder.transformer."
    sparse = embed_boxes(P, c, boxes)
    B, hw = sparse.shape[0], emb.shape[-2]
    out_tok = torch.cat([P(p + "iou_token.weight", (1, D), ("normal", 1.0)),
                         P(p + "mask_tokens.weight", (n_tok, D), ("normal", 1.0))])
    tokens = torch.cat([out_tok[None].expand(B, -1, -1), sparse], dim=1)
    dense = P("prompt_encoder.no_mask_embed.weight", (1, D), ("normal", 1.0))
    keys = (emb + dense.reshape(1, 1, 1, D)).expand(B, hw, hw, D).reshape(B, hw * hw, D)
    key_pe = dense_pe(P, c).reshape(1, hw * hw, D)
    queries = tokens
    mlp_dim = c.get("decoder_mlp_dim", 2048)
    for i in range(c["decoder_depth"]):
        n = f"{t}layers.{i}."
        if i == 0:  # skip_first_layer_pe
            queries = dec_attention(P, n + "self_attn", queries, queries, queries, D, nh)
        else:
            qq = queries + tokens
            queries = queries + dec_attention(P, n + "self_attn", qq, qq, queries, D, nh)
        queries = layer_norm(P, n + "norm1", queries, D, eps)
        qq, kk = queries + tokens, keys + key_pe
        queries = layer_norm(P, n + "norm2", queries + dec_attention(P, n + "cross_attn_token_to_image", qq, kk, keys, D, nh,
                                                               down), D, eps)
        h = linear(P, n + "mlp.lin2", F.relu(linear(P, n + "mlp.lin1", queries, D, mlp_dim)), mlp_dim, D)
        queries = layer_norm(P, n + "norm3", queries + h, D, eps)
        qq, kk = queries + tokens, keys + key_pe
        keys = layer_norm(P, n + "norm4", keys + dec_attention(P, n + "cross_attn_image_to_token", kk, qq, queries, D, nh,
                                                         down), D, eps)
    qq, kk = queries + tokens, keys + key_pe
    queries = layer_norm(P, t + "norm_final_attn",
                  queries + dec_attention(P, t + "final_attn_token_to_image", qq, kk, keys, D, nh, down), D, eps)
    iou = _mlp(P, p + "iou_prediction_head", queries[:, 0], [D, D, D, n_tok])
    u = p + "output_upscaling."
    x = keys.transpose(1, 2).reshape(B, D, hw, hw)
    w0 = P(u + "0.weight", (D, D // 4, 2, 2), _fan(1.0, D))
    x = F.conv_transpose2d(q(x), q(w0), P(u + "0.bias", (D // 4,), ("zero",)), stride=2)
    x = layer_norm(P, u + "1", x.permute(0, 2, 3, 1), D // 4, ENC_EPS).permute(0, 3, 1, 2)
    w3 = P(u + "3.weight", (D // 4, D // 8, 2, 2), _fan(1.0, D // 4))
    x = F.gelu(F.conv_transpose2d(q(F.gelu(x)), q(w3), P(u + "3.bias", (D // 8,), ("zero",)), stride=2))
    hyper = torch.stack([_mlp(P, f"{p}output_hypernetworks_mlps.{i}", queries[:, 1 + i], [D, D, D, D // 8])
                         for i in range(n_tok)], dim=1)
    masks = torch.matmul(q(hyper), q(x.reshape(B, D // 8, -1))).reshape(B, n_tok, 4 * hw, 4 * hw)
    return masks[:, :1], iou[:, :1]


# ---------------------------------------------------------- postprocessing
def upscale(low_res: torch.Tensor, scale: float, out_hw: tuple[int, int], img_size: int) -> torch.Tensor:
    """Low-res logits → the model input's size, cropped to the image's
    resized extent, → the frame's (H, W); antialiased bilinear."""
    up = F.interpolate(low_res, (img_size, img_size), mode="bilinear", align_corners=False, antialias=True)
    oh, ow = out_hw
    up = up[..., : int(oh * scale + 0.5), : int(ow * scale + 0.5)]
    return F.interpolate(up, (oh, ow), mode="bilinear", align_corners=False, antialias=True)


# --------------------------------------------------------- parameter list
def param_spec(cfg: dict) -> dict:
    """{name: (shape, initialiser)} of SAM at ``cfg``, recorded on the meta device."""
    P = Params()
    S = cfg["img_size"]
    encode(P, cfg, torch.empty((1, 3, S, S), device="meta"))
    decode(P, cfg, torch.empty((S // cfg["patch_size"],) * 2 + (cfg["prompt_dim"],), device="meta"),
           torch.zeros((1, 4), device="meta"))
    return P.spec
