"""SD-1.x / ControlNet / VAE diffusers state-dict key sets, with shapes.

A copy of ``gaussctrl_exp_tpu/diffusion/keysets.py`` whose widths are
arguments (SD-1.x's by default): every parameter key of the torch checkpoints
the reference loads (``CompVis/stable-diffusion-v1-4``'s unet and vae and
``lllyasviel/sd-controlnet-depth``), as diffusers' UNet2DConditionModel,
ControlNetModel and AutoencoderKL constructors lay them out (1×1-conv
``proj_in``/``proj_out``, ``use_linear_projection=False``). The tests write
toy checkpoints from them and check ``convert.load_sd_models`` against the
full key sets without any weights.
"""

from __future__ import annotations

BLOCK_OUT = (320, 640, 1280, 1280)
CROSS = 768
VAE_BLOCK_OUT = (128, 256, 512, 512)
COND_CHANS = (16, 32, 96, 256)


def _resnet(prefix: str, cin: int, cout: int, temb: int | None) -> dict:
    d = {
        f"{prefix}.norm1.weight": (cin,),
        f"{prefix}.norm1.bias": (cin,),
        f"{prefix}.conv1.weight": (cout, cin, 3, 3),
        f"{prefix}.conv1.bias": (cout,),
        f"{prefix}.norm2.weight": (cout,),
        f"{prefix}.norm2.bias": (cout,),
        f"{prefix}.conv2.weight": (cout, cout, 3, 3),
        f"{prefix}.conv2.bias": (cout,),
    }
    if temb is not None:
        d[f"{prefix}.time_emb_proj.weight"] = (cout, temb)
        d[f"{prefix}.time_emb_proj.bias"] = (cout,)
    if cin != cout:
        d[f"{prefix}.conv_shortcut.weight"] = (cout, cin, 1, 1)
        d[f"{prefix}.conv_shortcut.bias"] = (cout,)
    return d


def _transformer(prefix: str, ch: int, cross: int) -> dict:
    d = {
        f"{prefix}.norm.weight": (ch,),
        f"{prefix}.norm.bias": (ch,),
        f"{prefix}.proj_in.weight": (ch, ch, 1, 1),
        f"{prefix}.proj_in.bias": (ch,),
        f"{prefix}.proj_out.weight": (ch, ch, 1, 1),
        f"{prefix}.proj_out.bias": (ch,),
    }
    tb = f"{prefix}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        d[f"{tb}.{n}.weight"] = (ch,)
        d[f"{tb}.{n}.bias"] = (ch,)
    for attn, kv in (("attn1", ch), ("attn2", cross)):
        d[f"{tb}.{attn}.to_q.weight"] = (ch, ch)
        d[f"{tb}.{attn}.to_k.weight"] = (ch, kv)
        d[f"{tb}.{attn}.to_v.weight"] = (ch, kv)
        d[f"{tb}.{attn}.to_out.0.weight"] = (ch, ch)
        d[f"{tb}.{attn}.to_out.0.bias"] = (ch,)
    d[f"{tb}.ff.net.0.proj.weight"] = (ch * 8, ch)  # GEGLU: 2×(4·ch)
    d[f"{tb}.ff.net.0.proj.bias"] = (ch * 8,)
    d[f"{tb}.ff.net.2.weight"] = (ch, ch * 4)
    d[f"{tb}.ff.net.2.bias"] = (ch,)
    return d


def _unet_trunk(block_out, layers, cross) -> tuple[dict, list[int]]:
    """conv_in + time embedding + down blocks + mid block (shared by the UNet
    and the ControlNet); returns (keys, residual-stack channels)."""
    temb = 4 * block_out[0]  # diffusers' time_embed_dim
    d = {
        "conv_in.weight": (block_out[0], 4, 3, 3),
        "conv_in.bias": (block_out[0],),
        "time_embedding.linear_1.weight": (temb, block_out[0]),
        "time_embedding.linear_1.bias": (temb,),
        "time_embedding.linear_2.weight": (temb, temb),
        "time_embedding.linear_2.bias": (temb,),
    }
    res_stack = [block_out[0]]
    ch = block_out[0]
    for bi, cout in enumerate(block_out):
        has_attn = bi < len(block_out) - 1
        for li in range(layers):
            d.update(_resnet(f"down_blocks.{bi}.resnets.{li}", ch, cout, temb))
            ch = cout
            if has_attn:
                d.update(_transformer(f"down_blocks.{bi}.attentions.{li}", ch, cross))
            res_stack.append(ch)
        if bi < len(block_out) - 1:
            d[f"down_blocks.{bi}.downsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            d[f"down_blocks.{bi}.downsamplers.0.conv.bias"] = (ch,)
            res_stack.append(ch)
    d.update(_resnet("mid_block.resnets.0", ch, ch, temb))
    d.update(_transformer("mid_block.attentions.0", ch, cross))
    d.update(_resnet("mid_block.resnets.1", ch, ch, temb))
    return d, res_stack


def sd15_unet_keys(block_out=BLOCK_OUT, layers: int = 2, cross: int = CROSS) -> dict[str, tuple]:
    d, res_stack = _unet_trunk(block_out, layers, cross)
    temb = 4 * block_out[0]
    ch = block_out[-1]
    up_channels = list(reversed(block_out))
    for bi, cout in enumerate(up_channels):
        for li in range(layers + 1):
            skip = res_stack.pop()
            d.update(_resnet(f"up_blocks.{bi}.resnets.{li}", ch + skip, cout, temb))
            ch = cout
            if bi > 0:
                d.update(_transformer(f"up_blocks.{bi}.attentions.{li}", ch, cross))
        if bi < len(up_channels) - 1:
            d[f"up_blocks.{bi}.upsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            d[f"up_blocks.{bi}.upsamplers.0.conv.bias"] = (ch,)
    d["conv_norm_out.weight"] = (block_out[0],)
    d["conv_norm_out.bias"] = (block_out[0],)
    d["conv_out.weight"] = (4, block_out[0], 3, 3)
    d["conv_out.bias"] = (4,)
    return d


def sd15_controlnet_keys(block_out=BLOCK_OUT, layers: int = 2, cross: int = CROSS,
                         cond_chans=COND_CHANS) -> dict[str, tuple]:
    d, res_stack = _unet_trunk(block_out, layers, cross)
    d["controlnet_cond_embedding.conv_in.weight"] = (cond_chans[0], 3, 3, 3)
    d["controlnet_cond_embedding.conv_in.bias"] = (cond_chans[0],)
    for i in range(len(cond_chans) - 1):
        d[f"controlnet_cond_embedding.blocks.{2*i}.weight"] = (cond_chans[i], cond_chans[i], 3, 3)
        d[f"controlnet_cond_embedding.blocks.{2*i}.bias"] = (cond_chans[i],)
        d[f"controlnet_cond_embedding.blocks.{2*i+1}.weight"] = (cond_chans[i + 1], cond_chans[i], 3, 3)
        d[f"controlnet_cond_embedding.blocks.{2*i+1}.bias"] = (cond_chans[i + 1],)
    d["controlnet_cond_embedding.conv_out.weight"] = (block_out[0], cond_chans[-1], 3, 3)
    d["controlnet_cond_embedding.conv_out.bias"] = (block_out[0],)
    for zi, ch in enumerate(res_stack):
        d[f"controlnet_down_blocks.{zi}.weight"] = (ch, ch, 1, 1)
        d[f"controlnet_down_blocks.{zi}.bias"] = (ch,)
    d["controlnet_mid_block.weight"] = (block_out[-1], block_out[-1], 1, 1)
    d["controlnet_mid_block.bias"] = (block_out[-1],)
    return d


def _vae_attn(prefix: str, ch: int) -> dict:
    d = {
        f"{prefix}.group_norm.weight": (ch,),
        f"{prefix}.group_norm.bias": (ch,),
    }
    for n in ("to_q", "to_k", "to_v"):
        d[f"{prefix}.{n}.weight"] = (ch, ch)
        d[f"{prefix}.{n}.bias"] = (ch,)
    d[f"{prefix}.to_out.0.weight"] = (ch, ch)
    d[f"{prefix}.to_out.0.bias"] = (ch,)
    return d


def sd15_vae_keys(block_out=VAE_BLOCK_OUT) -> dict[str, tuple]:
    bo = block_out
    d = {
        "encoder.conv_in.weight": (bo[0], 3, 3, 3),
        "encoder.conv_in.bias": (bo[0],),
    }
    ch = bo[0]
    for bi, cout in enumerate(bo):
        for li in range(2):
            d.update(_resnet(f"encoder.down_blocks.{bi}.resnets.{li}", ch, cout, None))
            ch = cout
        if bi < len(bo) - 1:
            d[f"encoder.down_blocks.{bi}.downsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            d[f"encoder.down_blocks.{bi}.downsamplers.0.conv.bias"] = (ch,)
    d.update(_resnet("encoder.mid_block.resnets.0", ch, ch, None))
    d.update(_vae_attn("encoder.mid_block.attentions.0", ch))
    d.update(_resnet("encoder.mid_block.resnets.1", ch, ch, None))
    d["encoder.conv_norm_out.weight"] = (ch,)
    d["encoder.conv_norm_out.bias"] = (ch,)
    d["encoder.conv_out.weight"] = (8, ch, 3, 3)
    d["encoder.conv_out.bias"] = (8,)
    d["quant_conv.weight"] = (8, 8, 1, 1)
    d["quant_conv.bias"] = (8,)
    d["post_quant_conv.weight"] = (4, 4, 1, 1)
    d["post_quant_conv.bias"] = (4,)
    d["decoder.conv_in.weight"] = (bo[-1], 4, 3, 3)
    d["decoder.conv_in.bias"] = (bo[-1],)
    ch = bo[-1]
    d.update(_resnet("decoder.mid_block.resnets.0", ch, ch, None))
    d.update(_vae_attn("decoder.mid_block.attentions.0", ch))
    d.update(_resnet("decoder.mid_block.resnets.1", ch, ch, None))
    for bi, cout in enumerate(reversed(bo)):
        for li in range(3):
            d.update(_resnet(f"decoder.up_blocks.{bi}.resnets.{li}", ch, cout, None))
            ch = cout
        if bi < len(bo) - 1:
            d[f"decoder.up_blocks.{bi}.upsamplers.0.conv.weight"] = (ch, ch, 3, 3)
            d[f"decoder.up_blocks.{bi}.upsamplers.0.conv.bias"] = (ch,)
    d["decoder.conv_norm_out.weight"] = (ch,)
    d["decoder.conv_norm_out.bias"] = (ch,)
    d["decoder.conv_out.weight"] = (3, ch, 3, 3)
    d["decoder.conv_out.bias"] = (3,)
    return d
