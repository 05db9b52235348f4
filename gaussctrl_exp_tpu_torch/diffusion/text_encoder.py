"""CLIP text tower (ViT-L/14) in PyTorch.

The JAX package encodes prompts with transformers' ``FlaxCLIPTextModel``
(``sd_pipeline.py:93-118``). This is the same network written out: token +
position embeddings, pre-LayerNorm transformer layers with causal
self-attention and a quick-GELU MLP, a final LayerNorm (ε = 1e-5), and the
last hidden state as the output. Module names follow transformers' torch
``CLIPTextModel`` (``text_model.encoder.layers.0.self_attn.q_proj``), so a
diffusers ``text_encoder/`` checkpoint loads without renaming. The causal
self-attention at T = 77 is plain tensor code: the JAX side computes it
outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        B, T, C = x.shape
        Dh = C // self.heads

        def split(t):
            return t.view(B, T, self.heads, Dh).transpose(1, 2)

        q = split(self.q_proj(x)) * Dh**-0.5
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + mask, dim=-1)
        return self.out_proj(torch.matmul(probs, v).transpose(1, 2).reshape(B, T, C))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        T = input_ids.shape[1]
        mask = torch.full((T, T), float("-inf"), dtype=x.dtype, device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """``(B, T)`` token ids → ``(B, T, hidden)`` last hidden state."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids.long())
