"""Plain reference of the GaussCtrl edit stack: SD 1.x UNet, depth ControlNet,
VAE, CLIP text tower, the AttnAlign processor, DDIM and inverse DDIM with
classifier-free guidance.

Written from the published architectures (diffusers' SD 1.x UNet and
ControlNet, the KL autoencoder, CLIP ViT-L/14's text tower) as functions over
a flat dict of float32 tensors, one per parameter. The parameter names are
those of the measured program's modules, so that the benchmark can hand one
set of weights to both. Every product rounds its operands through
``precision.q`` (float32 by default, with TF32 off); norms, softmax and the
scheduler run in float32.

``Params`` also runs the same functions on the meta device with no weights,
recording each parameter's name, shape and initialiser: that is the
parameter list the benchmark fills from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import q

SCALING = 0.18215


class Params:
    """Weights by name. Without tensors it records the list of parameters
    (name → (shape, initialiser)) and hands back meta tensors."""

    def __init__(self, tensors: dict | None = None):
        self.t = tensors
        self.spec: dict[str, tuple[tuple[int, ...], tuple]] = {}

    def __call__(self, name: str, shape, init) -> torch.Tensor:
        if self.t is None:
            self.spec[name] = (tuple(shape), init)
            return torch.empty(shape, device="meta")
        return self.t[name]


# initialisers: ("normal", std), ("one",), ("zero",)
def _fan(std_scale, fan_in):
    return ("normal", std_scale / math.sqrt(fan_in))


def linear(P, name, x, cin, cout, bias=True, scale=1.0):
    w = P(f"{name}.weight", (cout, cin), _fan(scale, cin))
    y = F.linear(q(x), q(w))
    if bias:
        y = y + P(f"{name}.bias", (cout,), ("zero",))
    return y


def conv(P, name, x, cin, cout, k, stride=1, padding=None, scale=1.0):
    w = P(f"{name}.weight", (cout, cin, k, k), _fan(scale, cin * k * k))
    b = P(f"{name}.bias", (cout,), ("zero",))
    return F.conv2d(q(x), q(w), None, stride, k // 2 if padding is None else padding) + b[:, None, None]


def group_norm(P, name, x, c, eps):
    w, b = P(f"{name}.weight", (c,), ("one",)), P(f"{name}.bias", (c,), ("zero",))
    return F.group_norm(x.float(), 32, w, b, eps)


def layer_norm(P, name, x, c, eps):
    w, b = P(f"{name}.weight", (c,), ("one",)), P(f"{name}.bias", (c,), ("zero",))
    return F.layer_norm(x.float(), (c,), w, b, eps)


def sdpa(qh, kh, vh, rows: int = 16):
    """Softmax attention of (B, H, S, D) heads, (b, h) pairs in blocks of ``rows``."""
    B, H, S, D = qh.shape
    T = kh.shape[2]
    qf, kf, vf = (t.reshape(B * H, -1, D) for t in (qh, kh, vh))
    out = torch.empty((B * H, S, D), dtype=torch.float32, device=qh.device)
    for i in range(0, B * H, rows):
        s = torch.bmm(q(qf[i : i + rows]), q(kf[i : i + rows]).transpose(1, 2)) * D**-0.5
        p = torch.softmax(s.float(), dim=-1)
        out[i : i + rows] = torch.bmm(q(p), q(vf[i : i + rows]))
    return out.reshape(B, H, S, D)


def attn_align(coeff: float, n_ref: int = 4, groups: int = 2):
    """GaussCtrl's AttnAlign: in self-attention every view of each CFG group
    also attends to the keys and values of the group's views 0..n_ref−1; the
    output is coeff·self + (1 − coeff)·mean over those references.
    Cross-attention is plain."""

    def processor(qh, kh, vh, is_cross):
        out = sdpa(qh, kh, vh)
        if is_cross:
            return out
        B, H, S, D = qh.shape
        V = B // groups
        kg, vg = kh.reshape(groups, V, H, S, D), vh.reshape(groups, V, H, S, D)
        ref = 0.0
        for r in range(n_ref):
            kr = kg[:, r : r + 1].expand(groups, V, H, S, D).reshape(B, H, S, D)
            vr = vg[:, r : r + 1].expand(groups, V, H, S, D).reshape(B, H, S, D)
            ref = ref + sdpa(qh, kr, vr)
        return coeff * out + (1.0 - coeff) * ref / n_ref

    return processor


def plain_processor(qh, kh, vh, is_cross):
    return sdpa(qh, kh, vh)


# --------------------------------------------------------------- UNet blocks
def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def resnet(P, name, x, temb, cin, cout, tdim):
    h = conv(P, f"{name}.conv1", F.silu(group_norm(P, f"{name}.norm1", x, cin, 1e-5)), cin, cout, 3)
    h = h + linear(P, f"{name}.time_emb_proj", F.silu(temb), tdim, cout)[:, :, None, None]
    h = conv(P, f"{name}.conv2", F.silu(group_norm(P, f"{name}.norm2", h, cout, 1e-5)), cout, cout, 3)
    if cin != cout:
        x = conv(P, f"{name}.conv_shortcut", x, cin, cout, 1)
    return x + h


def attention(P, name, x, ctx, dim, heads, cdim, processor):
    is_cross = ctx is not None
    c = x if ctx is None else ctx
    kv = dim if ctx is None else cdim
    qq = linear(P, f"{name}.to_q", x, dim, dim, bias=False)
    kk = linear(P, f"{name}.to_k", c, kv, dim, bias=False)
    vv = linear(P, f"{name}.to_v", c, kv, dim, bias=False)
    B, S, _ = qq.shape
    T = kk.shape[1]
    d = dim // heads

    def split(t, L):
        return t.reshape(B, L, heads, d).transpose(1, 2)

    o = processor(split(qq, S), split(kk, T), split(vv, T), is_cross)
    return linear(P, f"{name}.to_out_0", o.transpose(1, 2).reshape(B, S, dim), dim, dim)


def transformer(P, name, x, ctx, ch, heads, cdim, processor):
    B, C, H, W = x.shape
    h = group_norm(P, f"{name}.norm", x, ch, 1e-6).permute(0, 2, 3, 1).reshape(B, H * W, C)
    h = linear(P, f"{name}.proj_in", h, ch, ch)
    b = f"{name}.transformer_blocks_0"
    h = h + attention(P, f"{b}.attn1", layer_norm(P, f"{b}.norm1", h, ch, 1e-6), None, ch, heads, cdim, processor)
    h = h + attention(P, f"{b}.attn2", layer_norm(P, f"{b}.norm2", h, ch, 1e-6), ctx, ch, heads, cdim, processor)
    ff, gate = linear(P, f"{b}.ff.proj", layer_norm(P, f"{b}.norm3", h, ch, 1e-6), ch, 8 * ch).chunk(2, -1)
    h = h + linear(P, f"{b}.ff.out", ff * F.gelu(gate, approximate="tanh"), 4 * ch, ch)
    h = linear(P, f"{name}.proj_out", h, ch, ch)
    return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def _time(P, t, c0, tdim):
    temb = timestep_embedding(t, c0)
    return linear(P, "time_embedding_linear_2", F.silu(linear(P, "time_embedding_linear_1", temb, c0, tdim)),
                  tdim, tdim)


def _down_trunk(P, cfg, h, temb, ctx, processor):
    """The down blocks shared by the UNet and the ControlNet → (h, skips)."""
    bo, lpb, heads, cdim = cfg["block_out"], cfg["layers_per_block"], cfg["heads"], cfg["cross_dim"]
    tdim, n = 4 * bo[0], len(bo)
    ch, skips = bo[0], [h]
    for bi, cout in enumerate(bo):
        for li in range(lpb):
            h = resnet(P, f"down_{bi}_resnet_{li}", h, temb, ch, cout, tdim)
            ch = cout
            if bi < n - 1:
                h = transformer(P, f"down_{bi}_attn_{li}", h, ctx, ch, heads, cdim, processor)
            skips.append(h)
        if bi < n - 1:
            h = conv(P, f"down_{bi}_downsample.conv", h, ch, ch, 3, stride=2)
            skips.append(h)
    return h, skips


def _mid(P, cfg, h, temb, ctx, processor):
    ch, tdim = cfg["block_out"][-1], 4 * cfg["block_out"][0]
    h = resnet(P, "mid_resnet_0", h, temb, ch, ch, tdim)
    h = transformer(P, "mid_attn_0", h, ctx, ch, cfg["heads"], cfg["cross_dim"], processor)
    return resnet(P, "mid_resnet_1", h, temb, ch, ch, tdim)


def unet(P, cfg, x, t, ctx, processor, residuals=None):
    """ε for latents ``x`` (B, 4, h, w), timesteps ``t`` (B,), text states
    ``ctx`` (B, 77, cross_dim); ControlNet ``residuals`` = (down list, mid)."""
    bo, lpb = cfg["block_out"], cfg["layers_per_block"]
    tdim, n = 4 * bo[0], len(bo)
    temb = _time(P, t, bo[0], tdim)
    h = conv(P, "conv_in", x, 4, bo[0], 3)
    h, skips = _down_trunk(P, cfg, h, temb, ctx, processor)
    h = _mid(P, cfg, h, temb, ctx, processor)
    if residuals is not None:
        skips = [s + r for s, r in zip(skips, residuals[0])]
        h = h + residuals[1]
    ch = bo[-1]
    for bi, cout in enumerate(reversed(bo)):
        for li in range(lpb + 1):
            skip = skips.pop()
            h = resnet(P, f"up_{bi}_resnet_{li}", torch.cat([h, skip], 1), temb, ch + skip.shape[1], cout, tdim)
            ch = cout
            if bi > 0:
                h = transformer(P, f"up_{bi}_attn_{li}", h, ctx, ch, cfg["heads"], cfg["cross_dim"], processor)
        if bi < n - 1:
            h = conv(P, f"up_{bi}_upsample.conv", F.interpolate(h, scale_factor=2, mode="nearest"), ch, ch, 3)
    return conv(P, "conv_out", F.silu(group_norm(P, "conv_norm_out", h, ch, 1e-5)), ch, 4, 3)


# trained ControlNets' output projections are no longer zero: the benchmark
# draws them at a quarter of the fan-in scale
ZERO_CONV_SCALE = 0.25


def controlnet(P, cfg, x, t, ctx, hint, cond_scale, processor):
    """(down residuals, mid residual) for latents ``x`` and hint (B, 3, H, W)."""
    bo = cfg["block_out"]
    tdim = 4 * bo[0]
    chans = cfg["cond_chans"]
    temb = _time(P, t, bo[0], tdim)
    e = F.silu(conv(P, "controlnet_cond_embedding.conv_in", hint, 3, chans[0], 3))
    for i in range(len(chans) - 1):
        e = F.silu(conv(P, f"controlnet_cond_embedding.blocks_{2 * i}", e, chans[i], chans[i], 3))
        e = F.silu(conv(P, f"controlnet_cond_embedding.blocks_{2 * i + 1}", e, chans[i], chans[i + 1], 3, stride=2))
    e = conv(P, "controlnet_cond_embedding.conv_out", e, chans[-1], bo[0], 3, scale=ZERO_CONV_SCALE)
    h = conv(P, "conv_in", x, 4, bo[0], 3) + e
    h, feats = _down_trunk(P, cfg, h, temb, ctx, processor)
    down = [conv(P, f"controlnet_down_blocks_{i}", f, f.shape[1], f.shape[1], 1, scale=ZERO_CONV_SCALE) * cond_scale
            for i, f in enumerate(feats)]
    h = _mid(P, cfg, h, temb, ctx, processor)
    mid = conv(P, "controlnet_mid_block", h, bo[-1], bo[-1], 1, scale=ZERO_CONV_SCALE) * cond_scale
    return down, mid


# --------------------------------------------------------------------- VAE
def vae_resnet(P, name, x, cin, cout):
    h = conv(P, f"{name}.conv1", F.silu(group_norm(P, f"{name}.norm1", x, cin, 1e-6)), cin, cout, 3)
    h = conv(P, f"{name}.conv2", F.silu(group_norm(P, f"{name}.norm2", h, cout, 1e-6)), cout, cout, 3)
    if cin != cout:
        x = conv(P, f"{name}.conv_shortcut", x, cin, cout, 1)
    return x + h


def vae_attention(P, name, x, c):
    B, C, H, W = x.shape
    h = group_norm(P, f"{name}.group_norm", x, c, 1e-6).permute(0, 2, 3, 1).reshape(B, H * W, C)
    qq, kk, vv = (linear(P, f"{name}.to_{s}", h, c, c) for s in "qkv")
    o = sdpa(qq[:, None], kk[:, None], vv[:, None], rows=1)[:, 0]
    h = linear(P, f"{name}.to_out_0", o, c, c)
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def vae_encode(P, cfg, img):
    """Images (B, 3, H, W) in [-1, 1] → scaled latent mean (B, 4, H/8, W/8)."""
    bo = cfg["vae_block_out"]
    p = "encoder."
    h = conv(P, p + "conv_in", img, 3, bo[0], 3)
    ch = bo[0]
    for bi, cout in enumerate(bo):
        for li in range(2):
            h = vae_resnet(P, f"{p}down_{bi}_resnet_{li}", h, ch, cout)
            ch = cout
        if bi < len(bo) - 1:
            h = conv(P, f"{p}down_{bi}_downsample", F.pad(h, (0, 1, 0, 1)), ch, ch, 3, stride=2, padding=0)
    h = vae_resnet(P, p + "mid_resnet_0", h, ch, ch)
    h = vae_attention(P, p + "mid_attn", h, ch)
    h = vae_resnet(P, p + "mid_resnet_1", h, ch, ch)
    h = conv(P, p + "conv_out", F.silu(group_norm(P, p + "conv_norm_out", h, ch, 1e-6)), ch, 8, 3)
    moments = conv(P, p + "quant_conv", h, 8, 8, 1)
    return moments[:, :4] * SCALING


def vae_decode(P, cfg, z):
    """Scaled latents (B, 4, h, w) → images (B, 3, 8h, 8w) in [0, 1]."""
    bo = cfg["vae_block_out"]
    p = "decoder."
    h = conv(P, p + "post_quant_conv", z / SCALING, 4, 4, 1)
    ch = bo[-1]
    h = conv(P, p + "conv_in", h, 4, ch, 3)
    h = vae_resnet(P, p + "mid_resnet_0", h, ch, ch)
    h = vae_attention(P, p + "mid_attn", h, ch)
    h = vae_resnet(P, p + "mid_resnet_1", h, ch, ch)
    for bi, cout in enumerate(reversed(bo)):
        for li in range(3):
            h = vae_resnet(P, f"{p}up_{bi}_resnet_{li}", h, ch, cout)
            ch = cout
        if bi < len(bo) - 1:
            h = conv(P, f"{p}up_{bi}_upsample", F.interpolate(h, scale_factor=2, mode="nearest"), ch, ch, 3)
    x = conv(P, p + "conv_out", F.silu(group_norm(P, p + "conv_norm_out", h, ch, 1e-6)), ch, 3, 3)
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


# --------------------------------------------------------------- CLIP text
def clip_text(P, cfg, ids):
    """Token ids (B, T) → last hidden state (B, T, hidden) of CLIP's text tower."""
    tc = cfg["text"]
    d, L, nh = tc["hidden_size"], tc["num_hidden_layers"], tc["num_attention_heads"]
    p = "text_model."
    B, T = ids.shape
    tok = P(p + "embeddings.token_embedding.weight", (tc["vocab_size"], d), ("normal", 0.02))
    pos = P(p + "embeddings.position_embedding.weight", (tc["max_position_embeddings"], d), ("normal", 0.02))
    x = tok[ids] + pos[:T][None]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for i in range(L):
        n = f"{p}encoder.layers.{i}."
        h = layer_norm(P, n + "layer_norm1", x, d, 1e-5)
        qq, kk, vv = (linear(P, n + f"self_attn.{s}_proj", h, d, d).reshape(B, T, nh, d // nh).transpose(1, 2)
                      for s in "qkv")
        s = torch.matmul(q(qq), q(kk).transpose(-1, -2)) * (d // nh) ** -0.5 + mask
        o = torch.matmul(q(torch.softmax(s, -1)), q(vv)).transpose(1, 2).reshape(B, T, d)
        x = x + linear(P, n + "self_attn.out_proj", o, d, d)
        h = linear(P, n + "mlp.fc1", layer_norm(P, n + "layer_norm2", x, d, 1e-5), d, tc["intermediate_size"])
        x = x + linear(P, n + "mlp.fc2", h * torch.sigmoid(1.702 * h), tc["intermediate_size"], d)
    return layer_norm(P, p + "final_layer_norm", x, d, 1e-5)


# --------------------------------------------------------------- schedulers
def alphas_cumprod(train_steps=1000, beta_start=0.00085, beta_end=0.012) -> np.ndarray:
    betas = np.linspace(beta_start**0.5, beta_end**0.5, train_steps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_timesteps(steps: int, train_steps: int = 1000) -> list[int]:
    """SD's 'leading' spacing with steps_offset 1, ascending."""
    return [i * (train_steps // steps) + 1 for i in range(steps)]


def eps_fn(P_unet, P_cn, cfg, lat, t, ctx, hint, cond_scale, processor):
    B = lat.shape[0]
    tt = torch.full((B,), t, dtype=torch.long, device=lat.device)
    res = controlnet(P_cn, cfg, lat, tt, ctx, hint, cond_scale, processor)
    return unet(P_unet, cfg, lat, tt, ctx, processor, res)


def generate(P_unet, P_cn, cfg, z, ctx_c, ctx_u, hint, guidance, steps, cond_scale, processor):
    """DDIM (η = 0) from latents ``z`` (B, 4, h, w) with CFG over the doubled
    batch [uncond; cond]."""
    ac = alphas_cumprod()
    dt = 1000 // steps
    lat = z.float()
    ctx2, hint2 = torch.cat([ctx_u, ctx_c]), torch.cat([hint, hint])
    for t in reversed(ddim_timesteps(steps)):
        e2 = eps_fn(P_unet, P_cn, cfg, torch.cat([lat, lat]), t, ctx2, hint2, cond_scale, processor).float()
        eu, ec = e2.chunk(2)
        e = eu + guidance * (ec - eu)
        a_t, a_p = ac[t], ac[t - dt] if t - dt >= 0 else ac[0]
        x0 = (lat - math.sqrt(1 - a_t) * e) / math.sqrt(a_t)
        lat = math.sqrt(a_p) * x0 + math.sqrt(1 - a_p) * e
    return lat


def invert(P_unet, P_cn, cfg, z, ctx, hint, steps, cond_scale, processor=plain_processor):
    """Inverse DDIM at guidance 0: x_{t−Δ} → x_t with ε taken at t."""
    ac = alphas_cumprod()
    dt = 1000 // steps
    lat = z.float()
    for t in ddim_timesteps(steps):
        e = eps_fn(P_unet, P_cn, cfg, lat, t, ctx, hint, cond_scale, processor).float()
        a_p = ac[t - dt] if t - dt >= 0 else 1.0
        a_t = ac[t]
        x0 = (lat - math.sqrt(1 - a_p) * e) / math.sqrt(a_p)
        lat = math.sqrt(a_t) * x0 + math.sqrt(1 - a_t) * e
    return lat


# ------------------------------------------------------ the parameter lists
def param_spec(cfg: dict) -> dict[str, dict]:
    """{"unet", "controlnet", "vae", "text"} → {name: (shape, initialiser)},
    recorded by running each network on the meta device."""
    out = {}
    lat = torch.empty((2, 4, 8, 8), device="meta")
    t = torch.zeros(2, dtype=torch.long, device="meta")
    ctx = torch.empty((2, 7, cfg["cross_dim"]), device="meta")
    for name, fn in (
        ("unet", lambda P: unet(P, cfg, lat, t, ctx, plain_processor)),
        ("controlnet", lambda P: controlnet(P, cfg, lat, t, ctx, torch.empty((2, 3, 64, 64), device="meta"),
                                            1.0, plain_processor)),
        ("vae", lambda P: (vae_encode(P, cfg, torch.empty((1, 3, 64, 64), device="meta")),
                           vae_decode(P, cfg, torch.empty((1, 4, 8, 8), device="meta")))),
        ("text", lambda P: clip_text(P, cfg, torch.zeros((1, 7), dtype=torch.long, device="meta"))),
    ):
        P = Params()
        fn(P)
        out[name] = P.spec
    return out
