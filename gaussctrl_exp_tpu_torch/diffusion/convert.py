"""Load a local diffusers-layout SD-1.x + ControlNet directory into the port.

Port of ``gaussctrl_exp_tpu/diffusion/convert.py``'s ``load_sd_models``. The
directory holds ``unet/``, ``vae/``, ``controlnet/`` (or ``controlnet_dir``),
optionally ``text_encoder/`` and ``tokenizer/``, each with ``.safetensors``
or ``.bin`` weights and optionally diffusers' ``config.json``. Keys are
renamed with copies of the JAX package's tables (diffusers module paths →
the flat names both packages use: ``down_blocks.0.resnets.1`` →
``down_0_resnet_1``). The port's modules keep torch's layouts, so no tensor
is transposed; only the 1×1-conv ``proj_in``/``proj_out`` of SD-1.x's
Transformer2D become the (O, I) weights of the port's linear layers.

``.bin`` files are read with ``torch.load``; ``.safetensors`` files with the
small reader below (an 8-byte little-endian header length, a JSON header,
then raw little-endian buffers), so no ``safetensors`` package is needed.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import torch

from ..device import resolve_device
from .layers import cast_keeping_norms

_UNET_PATTERNS = [
    (r"^conv_in\.(.*)", r"conv_in.\1"),
    (r"^time_embedding\.linear_1\.(.*)", r"time_embedding_linear_1.\1"),
    (r"^time_embedding\.linear_2\.(.*)", r"time_embedding_linear_2.\1"),
    (r"^down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", r"down_\1_resnet_\2.\3"),
    (r"^down_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", r"down_\1_attn_\2.\3"),
    (r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", r"down_\1_downsample.conv.\2"),
    (r"^mid_block\.resnets\.(\d+)\.(.*)", r"mid_resnet_\1.\2"),
    (r"^mid_block\.attentions\.0\.(.*)", r"mid_attn_0.\1"),
    (r"^up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", r"up_\1_resnet_\2.\3"),
    (r"^up_blocks\.(\d+)\.attentions\.(\d+)\.(.*)", r"up_\1_attn_\2.\3"),
    (r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", r"up_\1_upsample.conv.\2"),
    (r"^conv_norm_out\.(.*)", r"conv_norm_out.\1"),
    (r"^conv_out\.(.*)", r"conv_out.\1"),
    # controlnet extras
    (r"^controlnet_cond_embedding\.conv_in\.(.*)", r"controlnet_cond_embedding.conv_in.\1"),
    (r"^controlnet_cond_embedding\.blocks\.(\d+)\.(.*)", r"controlnet_cond_embedding.blocks_\1.\2"),
    (r"^controlnet_cond_embedding\.conv_out\.(.*)", r"controlnet_cond_embedding.conv_out.\1"),
    (r"^controlnet_down_blocks\.(\d+)\.(.*)", r"controlnet_down_blocks_\1.\2"),
    (r"^controlnet_mid_block\.(.*)", r"controlnet_mid_block.\1"),
]

_ATTN_INNER = [
    (r"(.*)transformer_blocks\.(\d+)\.(.*)", r"\1transformer_blocks_\2.\3"),
    (r"(.*)\.to_out\.0\.(.*)", r"\1.to_out_0.\2"),
    (r"(.*)\.ff\.net\.0\.proj\.(.*)", r"\1.ff.proj.\2"),
    (r"(.*)\.ff\.net\.2\.(.*)", r"\1.ff.out.\2"),
]

_VAE_PATTERNS = [
    # pre-0.13 diffusers AttentionBlock names → modern to_q/to_k/to_v/to_out.0
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.query\.(.*)", r"\1.mid_attn.to_q.\2"),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.key\.(.*)", r"\1.mid_attn.to_k.\2"),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.value\.(.*)", r"\1.mid_attn.to_v.\2"),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.proj_attn\.(.*)", r"\1.mid_attn.to_out_0.\2"),
    (r"^(encoder|decoder)\.conv_in\.(.*)", r"\1.conv_in.\2"),
    (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", r"encoder.down_\1_resnet_\2.\3"),
    (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", r"encoder.down_\1_downsample.\2"),
    (r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", r"decoder.up_\1_resnet_\2.\3"),
    (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", r"decoder.up_\1_upsample.\2"),
    (r"^(encoder|decoder)\.mid_block\.resnets\.(\d+)\.(.*)", r"\1.mid_resnet_\2.\3"),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.(.*)", r"\1.mid_attn.\2"),
    (r"^(encoder|decoder)\.conv_norm_out\.(.*)", r"\1.conv_norm_out.\2"),
    (r"^(encoder|decoder)\.conv_out\.(.*)", r"\1.conv_out.\2"),
    (r"^quant_conv\.(.*)", r"encoder.quant_conv.\1"),
    (r"^post_quant_conv\.(.*)", r"decoder.post_quant_conv.\1"),
]

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _translate(key: str, patterns) -> str | None:
    for pat, rep in patterns:
        if re.match(pat, key):
            key = re.sub(pat, rep, key)
            for pat2, rep2 in _ATTN_INNER:
                while re.match(pat2, key):
                    new = re.sub(pat2, rep2, key)
                    if new == key:
                        break
                    key = new
            return key
    return None


def translate_unet_key(key: str) -> str | None:
    return _translate(key, _UNET_PATTERNS)


def translate_vae_key(key: str) -> str | None:
    return _translate(key, _VAE_PATTERNS)


def convert_state_dict(sd: dict, translate) -> dict[str, torch.Tensor]:
    """diffusers ``{dotted name: tensor}`` → the port's state dict (float32).

    Raises if a key does not translate: a skipped key means a silently wrong
    model."""
    out, skipped = {}, []
    for k, v in sd.items():
        new = translate(k)
        if new is None:
            skipped.append(k)
            continue
        v = torch.as_tensor(v).float()
        if v.ndim == 4 and new.rsplit(".", 1)[0].endswith(("proj_in", "proj_out")) and v.shape[2:] == (1, 1):
            v = v[:, :, 0, 0]  # SD-1.x's 1×1 convs are the port's linear layers
        out[new] = v
    if skipped:
        raise ValueError(f"convert_state_dict skipped {len(skipped)} keys, e.g. {skipped[:6]}")
    return out


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors (views into one buffer of the file)."""
    buf = bytearray(Path(path).read_bytes())
    n = int.from_bytes(buf[:8], "little")
    header = json.loads(buf[8 : 8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + start).reshape(shape)
    return out


def read_weights(model_dir: str | Path) -> dict[str, torch.Tensor]:
    model_dir = Path(model_dir)
    files = sorted(model_dir.glob("*.safetensors")) + sorted(model_dir.glob("*.bin"))
    if not files:
        raise FileNotFoundError(f"no weight files in {model_dir}")
    sd = {}
    for f in files:
        if f.suffix == ".safetensors":
            sd.update(read_safetensors(f))
        else:
            sd.update(torch.load(str(f), map_location="cpu", weights_only=True))
    return sd


def _config(model_dir: Path) -> dict:
    path = model_dir / "config.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _load(module_fn, sd: dict, device, dtype):
    """The module with ``sd``'s float32 tensors on ``device``, cast to
    ``dtype`` but for its norms, which stay float32."""
    with torch.device("meta"):
        module = module_fn()
    module.load_state_dict(sd, strict=True, assign=True)
    return cast_keeping_norms(module.to(device=device), dtype).requires_grad_(False).eval()


def load_sd_models(root: str | Path, device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.bfloat16, controlnet_dir: str | Path | None = None):
    """``SDModels`` from a local diffusers directory.

    ``dtype`` is the compute type of the UNet, the ControlNet and the VAE:
    bfloat16 by default, as the JAX package's (its parameters stay float32
    but every matmul and conv runs in bf16, which is the same as bf16
    weights); every attention keeps an fp32 softmax, and every GroupNorm and
    LayerNorm keeps its float32 scale and bias. The text encoder stays
    float32, as transformers' ``FlaxCLIPTextModel`` runs by default. Widths
    come from each ``config.json`` (SD-1.x's where there is none);
    diffusers' SD-1.x ``attention_head_dim`` of 8 is the number of heads."""
    from .controlnet import COND_CHANS, ControlNet
    from .sd_pipeline import SDModels, random_text_encoder
    from .text_encoder import CLIPTextConfig, CLIPTextModel
    from .tokenizer import CLIPTokenizer
    from .unet import BLOCK_OUT, CROSS_DIM, HEADS, LAYERS_PER_BLOCK, UNet2DCondition
    from .vae import VAE_BLOCK_OUT, AutoencoderKL

    device = resolve_device(device)
    root = Path(root)
    cn_dir = Path(controlnet_dir) if controlnet_dir else root / "controlnet"

    def unet_kw(cfg):
        block_out = tuple(cfg.get("block_out_channels", BLOCK_OUT))
        heads = cfg.get("attention_head_dim", HEADS)
        return dict(block_out=block_out, layers_per_block=cfg.get("layers_per_block", LAYERS_PER_BLOCK),
                    heads=heads if isinstance(heads, int) else heads[0],
                    cross_dim=cfg.get("cross_attention_dim", CROSS_DIM), temb_dim=4 * block_out[0])

    ucfg, ccfg, vcfg = _config(root / "unet"), _config(cn_dir), _config(root / "vae")
    unet = _load(lambda: UNet2DCondition(**unet_kw(ucfg)),
                 convert_state_dict(read_weights(root / "unet"), translate_unet_key), device, dtype)
    cond = tuple(ccfg.get("conditioning_embedding_out_channels", COND_CHANS))
    controlnet = _load(lambda: ControlNet(**unet_kw(ccfg), cond_chans=cond),
                       convert_state_dict(read_weights(cn_dir), translate_unet_key), device, dtype)
    vae = _load(lambda: AutoencoderKL(tuple(vcfg.get("block_out_channels", VAE_BLOCK_OUT))),
                convert_state_dict(read_weights(root / "vae"), translate_vae_key), device, dtype)

    te_dir = root / "text_encoder"
    if te_dir.exists():
        tcfg = _config(te_dir)
        if tcfg.get("hidden_act", "quick_gelu") != "quick_gelu":
            raise ValueError(f"text encoder hidden_act {tcfg['hidden_act']!r}: the port's CLIP "
                             "text tower is SD-1.x's, with quick_gelu")
        fields = {f: tcfg[f] for f in CLIPTextConfig.__dataclass_fields__ if f in tcfg}
        sd = {k: v.float() for k, v in read_weights(te_dir).items() if not k.endswith("position_ids")}
        text_encoder = _load(lambda: CLIPTextModel(CLIPTextConfig(**fields)), sd, device, torch.float32)
    else:
        text_encoder = random_text_encoder(CLIPTextConfig(), 0, device)
    try:
        tokenizer = CLIPTokenizer.from_pretrained(root)
    except FileNotFoundError:
        tokenizer = None  # weightless layout: the pipeline falls back to simple_tokenize
    return SDModels(unet=unet, controlnet=controlnet, vae=vae, text_encoder=text_encoder,
                    tokenizer=tokenizer)
