"""What the two edit cells share: the SD stack's weights from the seed, the
program's models and pipeline built on them, and the prompts."""

from __future__ import annotations

import dataclasses

import torch

from ..common import load_module, make_weights, tokenize
from ..reference import sd as ref


def model_cfg(config: dict) -> dict:
    """The configuration file's widths in the reference's terms."""
    u, t = config["unet"], config["text_encoder"]
    return dict(block_out=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
                heads=u["attention_head_dim"], cross_dim=u["cross_attention_dim"],
                cond_chans=tuple(config["controlnet"]["conditioning_embedding_out_channels"]),
                vae_block_out=tuple(config["vae"]["block_out_channels"]),
                text={k: t[k] for k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                        "num_attention_heads", "max_position_embeddings")},
                latent=u["sample_size"], image=config["image_size"])


@dataclasses.dataclass
class Edit:
    mcfg: dict
    weights: dict  # "unet", "controlnet", "vae", "text" → {name: float32 tensor}
    pipe: object  # the program's GaussCtrlEditPipeline
    prompts: dict  # "edit", "negative", "reverse" → the strings the pipeline encodes


def build(ctx: dict) -> Edit:
    from gaussctrl_exp_tpu_torch.diffusion.controlnet import ControlNet
    from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDModels
    from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig, CLIPTextModel
    from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
    from gaussctrl_exp_tpu_torch.diffusion.vae import AutoencoderKL

    cfg, tr, seed, dev = ctx["cell"].config, ctx["cell"].traffic, ctx["seed"], ctx["device"]
    mc = model_cfg(cfg)
    spec = ref.param_spec(mc)
    W = {part: make_weights(spec[part], seed, f"weights.{part}", dev) for part in spec}
    dtype = getattr(torch, cfg["compute_dtype"])
    kw = dict(block_out=mc["block_out"], layers_per_block=mc["layers_per_block"], heads=mc["heads"],
              cross_dim=mc["cross_dim"], temb_dim=4 * mc["block_out"][0])
    models = SDModels(
        unet=load_module(lambda: UNet2DCondition(**kw), W["unet"], dtype),
        controlnet=load_module(lambda: ControlNet(**kw, cond_chans=mc["cond_chans"]), W["controlnet"], dtype),
        vae=load_module(lambda: AutoencoderKL(mc["vae_block_out"]), W["vae"], dtype),
        text_encoder=load_module(lambda: CLIPTextModel(CLIPTextConfig(**mc["text"])), W["text"]),
    )
    ecfg = EditConfig(edit_prompt=tr["edit_prompt"], reverse_prompt=tr["reverse_prompt"],
                      guidance_scale=tr["guidance_scale"], num_inference_steps=tr["num_inference_steps"],
                      chunk_size=tr["chunk_size"], ref_view_num=tr["ref_view_num"],
                      self_attn_coeff_unet=tr["attn_align_coeff"],
                      controlnet_conditioning_scale=tr["controlnet_scale"], latent_size=mc["latent"])
    pipe = GaussCtrlEditPipeline(ecfg, models=models, tokenizer=tokenize, device=dev)
    prompts = dict(edit=f"{tr['edit_prompt']}, {tr['added_prompt']}", negative=tr["negative_prompt"],
                   reverse=f"{tr['reverse_prompt']}, {tr['added_prompt']}")
    return Edit(mc, W, pipe, prompts)


def text_states(e: Edit, text: str) -> torch.Tensor:
    dev = e.weights["text"]["text_model.final_layer_norm.weight"].device
    ids = torch.as_tensor(tokenize([text]), device=dev)
    return ref.clip_text(ref.Params(e.weights["text"]), e.mcfg, ids)


def release(e: Edit) -> None:
    """Drop the program's models; the benchmark's float32 weights stay for the reference."""
    e.pipe = None
