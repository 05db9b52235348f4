"""The port's TriPlane processor (``diffusion/triplane_attention.py``) and
the edit loop with it against the benchmark's plain reference
(``benchmark/reference/triplane.py`` on ``reference/sd.py``), on seeded
inputs on one CPU thread: the world points of a ring of cameras over smooth
depths, the processor on seeded q, k, v in float32, the float32 planes of
bf16 values (a cell of 256 tokens among them), and ``edit_images`` with the
processor at tiny widths in float32, which the reference with the term left
out (mix = 1) misses by far. The reference imports neither JAX nor the
port."""

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.common import load_module, make_weights, reference_views, tokenize
from benchmark.reference import sd as ref
from benchmark.reference import triplane as ref_tri
from gaussctrl_exp_tpu_torch.diffusion import triplane_attention as tri
from gaussctrl_exp_tpu_torch.diffusion.pipeline import EditConfig, GaussCtrlEditPipeline, depth_to_disparity
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMAGE, LATENT, RES = 64, 8, 8
# float32 on both sides: the points agree to the rounding of a few float32
# products, a matrix product in the port (measured 2.7e-7 of the largest coordinate)
PTS_RTOL = 1e-6
# the processor: the port adds each cell's values with index_add_ in
# float32, in another order than the reference's float64 sums, and the
# attentions sum in other orders (measured 4.3e-8 of the largest output)
RTOL = 1e-6
# the edit loop: 2 CFG steps at guidance 5.0 carry ε's rounding into the
# latents, the VAE into the images (measured 4.1e-6; the term left out: 0.26)
IMG_ATOL = 5e-5


def _close(got, want, rtol=RTOL):
    assert got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * float(want.abs().max()), err


def _views(V, seed=7):
    """V cameras of the benchmark's ring and smooth depths around the
    object: the port's cameras, the reference's dicts of the same tensors,
    and (V, H, W) depths."""
    cams = scene.make_cameras(dict(num_views=V, image_size=IMAGE, focal=70.0), seed)
    pcams = [scene.port_camera(c, "cpu") for c in cams]
    rcams = [dict(c2w=p.c2w, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy) for p in pcams]
    g = torch.Generator().manual_seed(seed)
    low = 3.2 + 1.2 * torch.rand((V, 1, 8, 8), generator=g)
    depths = torch.nn.functional.interpolate(low, size=(IMAGE, IMAGE), mode="bilinear", align_corners=False)[:, 0]
    return pcams, rcams, depths


class _DM:
    def __init__(self, pcams):
        self.pcams, self.images = pcams, {}

    def __len__(self):
        return len(self.pcams)

    def camera(self, i):
        return self.pcams[i]

    def write_back(self, i, img):
        self.images[i] = img


def _pipe(mix=0.5, models=None, **kw):
    cfg = EditConfig(edit_prompt="a photo of a polar bear", num_inference_steps=2, chunk_size=2, latent_size=LATENT,
                     attn_processor="triplane", triplane_mix=mix, triplane_plane_res=RES, **kw)
    return GaussCtrlEditPipeline(cfg, models=models, tokenizer=tokenize, device="cpu")


def test_world_points_match():
    V = 3
    pcams, rcams, depths = _views(V)
    pipe = _pipe(models=_Models())
    pipe.depths = {i: depths[i].numpy() for i in range(V)}
    got = pipe._chunk_geometry(_DM(pcams), list(range(V)))
    want = ref_tri.world_points(depths, rcams, LATENT)
    _close(got, want, PTS_RTOL)
    # the ring's points land inside the normalised box: the planes see the object
    norm = ref_tri.normalise(want, 8.0)
    assert float(norm.min()) > 0.0 and float(norm.max()) < ref_tri.CLAMP_HI


class _Models:
    """No models: the geometry alone."""

    device = torch.device("cpu")


@pytest.mark.parametrize("mix", [0.5, 1.0])
def test_processor_matches(mix):
    V, G, H, D = 3, 2, 2, 8
    _, rcams, depths = _views(V)
    pts = ref_tri.world_points(depths, rcams, LATENT)
    port = tri.make_triplane_processor(pts, mix=mix, plane_res=RES)
    rproc = ref_tri.processor(pts, mix, 8.0, RES)
    g = torch.Generator().manual_seed(1)
    for S in (LATENT * LATENT, 16):  # the grid's length, and another: plain attention
        q, k, v = (torch.randn((G * V, H, S, D), generator=g) for _ in range(3))
        _close(port(q, k, v, False), rproc(q, k, v, False))
        _close(port(q, k, v, True), rproc(q, k, v, True))
    if mix == 0.5:  # the term moves the output
        q, k, v = (torch.randn((G * V, H, LATENT * LATENT, D), generator=g) for _ in range(3))
        assert float((port(q, k, v, False) - ref.sdpa(q, k, v)).abs().max()) > 0.05


def test_bf16_values_pool_into_float32_planes():
    """A plane of bf16 values, pooled as the processor pools them
    (``pool_planes``), is the float32 plane of the same values: the float64
    means rounded once, within float32's sums of a cell; bf16 sums
    would miss them by far in the cell of 256 tokens."""
    g = torch.Generator().manual_seed(3)
    n, C = 400, 16
    feats = (1.0 + torch.randn((n, C), generator=g)).bfloat16()
    uv = torch.rand((n, 2), generator=g) * 0.999
    uv[:256] = torch.tensor([0.40, 0.60]) + 0.01 * torch.rand((256, 2), generator=g)  # one cell of 8 × 8: (4, 3)
    plane = tri.scatter_mean_plane(feats, uv, RES)
    assert plane.dtype == torch.float32
    want = ref_tri.plane(feats.float(), uv[:, 0], uv[:, 1], RES).reshape(RES * RES, C)
    cell = 4 * RES + 3
    counts = torch.zeros(RES * RES).index_add_(0, (uv[:, 1] * RES).long() * RES + (uv[:, 0] * RES).long(),
                                               torch.ones(n))
    assert counts[cell] >= 256
    # 256 float32 adds of values near 1: at most a few ulps of the sum a value
    torch.testing.assert_close(plane, want, rtol=2e-6, atol=2e-6)
    bf16_sums = feats.new_zeros((RES * RES, C)).index_add_(
        0, (uv[:, 1] * RES).long() * RES + (uv[:, 0] * RES).long(), feats).float() / counts.clamp(min=1)[:, None]
    assert float((bf16_sums[cell] - want[cell]).abs().max()) > 1e-3  # what the float32 sums avoid
    # the features the processor hands the attention are cast once, from float32 samples
    pts = torch.rand((1, 64, 3), generator=g) * 6 - 3
    q, k, v = (torch.randn((2, 2, 64, 8), generator=g).bfloat16() for _ in range(3))
    out = tri.make_triplane_processor(pts, plane_res=RES)(q, k, v, False)
    assert out.dtype == torch.bfloat16


TINY = dict(block_out=(32, 64), layers_per_block=1, heads=2, cross_dim=16, cond_chans=(4, 4, 4, 8),
            vae_block_out=(32, 32, 32, 32), latent=LATENT, image=IMAGE,
            text=dict(vocab_size=49408, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=2, max_position_embeddings=77))


def _models(seed=5):
    """The port's SD stack (float32, CPU) and the same seeded weights by name."""
    from gaussctrl_exp_tpu_torch.diffusion.controlnet import ControlNet
    from gaussctrl_exp_tpu_torch.diffusion.sd_pipeline import SDModels
    from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig, CLIPTextModel
    from gaussctrl_exp_tpu_torch.diffusion.unet import UNet2DCondition
    from gaussctrl_exp_tpu_torch.diffusion.vae import AutoencoderKL

    spec = ref.param_spec(TINY)
    W = {part: make_weights(spec[part], seed, f"weights.{part}", "cpu") for part in spec}
    kw = dict(block_out=TINY["block_out"], layers_per_block=1, heads=TINY["heads"], cross_dim=TINY["cross_dim"],
              temb_dim=4 * TINY["block_out"][0])
    models = SDModels(
        unet=load_module(lambda: UNet2DCondition(**kw), W["unet"]),
        controlnet=load_module(lambda: ControlNet(**kw, cond_chans=TINY["cond_chans"]), W["controlnet"]),
        vae=load_module(lambda: AutoencoderKL(TINY["vae_block_out"]), W["vae"]),
        text_encoder=load_module(lambda: CLIPTextModel(CLIPTextConfig(**TINY["text"])), W["text"]),
    )
    return models, W


@torch.no_grad()
def test_edit_images_matches_the_reference():
    V = 6
    pcams, rcams, depths = _views(V)
    models, W = _models()
    pipe = _pipe(models=models)
    g = torch.Generator().manual_seed(9)
    z0 = torch.randn((V, LATENT, LATENT, 4), generator=g)
    disp = np.stack([depth_to_disparity(d) for d in depths.numpy()])
    pipe.z0 = {i: z0[i].numpy() for i in range(V)}
    pipe.depths = {i: depths[i].numpy() for i in range(V)}
    pipe.disparity = {i: disp[i] for i in range(V)}
    dm = _DM(pcams)
    pipe.edit_images(dm)
    assert sorted(dm.images) == list(range(V))

    refs = reference_views(V, 4, 13789)
    text = {k: ref.clip_text(ref.Params(W["text"]), TINY, torch.as_tensor(tokenize([p])))
            for k, p in (("c", f"{pipe.cfg.edit_prompt}, best quality, extremely detailed"),
                         ("u", "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, fewer digits, "
                               "cropped, worst quality, low quality"))}
    worst = far = 0.0
    for c0 in range(0, V, 2):
        views = refs + [c0, c0 + 1]
        idx = torch.tensor(views)
        pts = ref_tri.world_points(depths[idx], [rcams[i] for i in views], LATENT)
        B = len(views)
        args = (ref.Params(W["unet"]), ref.Params(W["controlnet"]), TINY, z0[idx].permute(0, 3, 1, 2),
                text["c"].expand(B, -1, -1), text["u"].expand(B, -1, -1),
                torch.as_tensor(disp)[idx].permute(0, 3, 1, 2), 5.0, 2, 1.0)
        got = torch.as_tensor(np.stack([dm.images[i] for i in (c0, c0 + 1)]))
        for mix in (0.5, 1.0):
            lat = ref.generate(*args, ref_tri.processor(pts, mix, 8.0, RES))
            want = ref.vae_decode(ref.Params(W["vae"]), TINY, lat[len(refs):]).permute(0, 2, 3, 1)
            gap = float((got - want).abs().max())
            if mix == 0.5:
                worst = max(worst, gap)
            else:
                far = max(far, gap)
    assert worst <= IMG_ATOL, worst
    assert far > 50 * IMG_ATOL, far  # the term left out misses by far
