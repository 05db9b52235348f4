"""Shared set-up of the diffusion parity tests: the JAX package's tiny SD
stack (``TINY`` of tests/test_diffusion.py), a tiny CLIP text tower, and the
port's modules carrying the same weights through ``diffusion/params.py``."""

import functools
import json

import jax
import numpy as np
import torch

from gaussctrl_exp_tpu.diffusion.sd_pipeline import init_random_models as jinit_random_models
from gaussctrl_exp_tpu_torch.diffusion import keysets
from gaussctrl_exp_tpu_torch.diffusion import params as P
from gaussctrl_exp_tpu_torch.diffusion.controlnet import ControlNet
from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDModels
from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig, CLIPTextModel
from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
from gaussctrl_exp_tpu_torch.diffusion.vae import AutoencoderKL

TINY = dict(block_out=(32, 64), vae_block_out=(32, 32, 32, 32), heads=2, cross_dim=32,
            layers_per_block=1)
TINY_CLIP = dict(vocab_size=600, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=77)


def rel_l2(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().float().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


@functools.lru_cache(maxsize=None)
def jax_tiny(seed: int = 0):
    """The JAX package's tiny random stack (f32), with a tiny Flax CLIP."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import FlaxCLIPTextModel

    m = jinit_random_models(jax.random.PRNGKey(seed), latent=8, **TINY)
    m.text_encoder = FlaxCLIPTextModel(HFConfig(**TINY_CLIP), seed=seed)
    m.text_params = m.text_encoder.params
    return m


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module.requires_grad_(False).eval()


def port_tiny(jm) -> SDModels:
    """The port's modules (CPU, f32) with the JAX stack's weights."""
    kw = dict(block_out=TINY["block_out"], layers_per_block=TINY["layers_per_block"],
              heads=TINY["heads"], cross_dim=TINY["cross_dim"], temb_dim=TINY["block_out"][-1])
    tree = jax.device_get
    return SDModels(
        unet=load(UNet2DCondition(**kw), P.unet_params_from_flax(tree(jm.unet_params))),
        controlnet=load(ControlNet(**kw), P.controlnet_params_from_flax(tree(jm.controlnet_params))),
        vae=load(AutoencoderKL(TINY["vae_block_out"]), P.vae_params_from_flax(tree(jm.vae_params))),
        text_encoder=load(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                          P.clip_params_from_flax(tree(jm.text_params))),
    )


def toy_checkpoint(root, seed=0):
    """A diffusers directory at the tiny widths: unet and controlnet as
    .safetensors, vae as .bin, each with its config.json."""
    import safetensors.numpy

    rng = np.random.default_rng(seed)
    rand = lambda ks: {k: rng.normal(size=s).astype(np.float32) for k, s in ks.items()}
    ucfg = {"block_out_channels": [32, 64], "layers_per_block": 1, "cross_attention_dim": 32,
            "attention_head_dim": 2}
    parts = {"unet": rand(keysets.sd15_unet_keys((32, 64), 1, 32)),
             "controlnet": rand(keysets.sd15_controlnet_keys((32, 64), 1, 32)),
             "vae": rand(keysets.sd15_vae_keys((32, 32, 32, 32)))}
    for name, sd in parts.items():
        (root / name).mkdir()
        cfg = {"block_out_channels": [32, 32, 32, 32]} if name == "vae" else ucfg
        (root / name / "config.json").write_text(json.dumps(cfg))
        if name == "vae":
            torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, str(root / name / "diffusion_pytorch_model.bin"))
        else:
            safetensors.numpy.save_file(sd, str(root / name / "diffusion_pytorch_model.safetensors"))
    return parts
