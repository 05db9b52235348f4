"""The port's depth generator against the benchmark's plain reference
(``benchmark/reference/mvgen.py``), on seeded random weights at tiny widths
on one CPU thread, with 2 or 3 views of a camera ring: the tables and the
pair mask, the depth latents, the multi-resolution epipolar processor (an
isolated view too), ε with the depth channel, and a 3-step CFG sample, which
the reference with its cross-view term left out (mix = 1) misses by far.
The reference imports neither JAX nor the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, scene
from benchmark.common import make_weights
from benchmark.reference import mvgen as ref
from benchmark.reference.sd import Params
from gaussctrl_exp_tpu_torch.diffusion import correspondence as corr
from gaussctrl_exp_tpu_torch.diffusion.mv_generator import MVGeneratorConfig, init_depth_generator, inverse_depth_latent
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMAGE, LATENT = 64, 8
CFG = dict(block_out=(32, 64), layers_per_block=1, heads=2, cross_dim=16, in_channels=5, latent=LATENT, sigma=0.1,
           mix=0.5, overlap_thresh=0.05, min_overlap=0.2, guidance=7.5, steps=3)
# float32 on both sides, the same products summed in other orders (measured
# ≤ 1.1e-6 of the largest ε entry, ≤ 2.4e-6 of the largest latent after 3 steps)
RTOL = 1e-5
# the 3-step sample: CFG 7.5 carries ε's rounding into the latents; the
# cross-view term left out moves them by ~0.26 of their largest entry
SAMPLE_RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max()), float((got - want).abs().max())


def _views(V, seed=7):
    """V consecutive cameras of the benchmark's ring and smooth depths around
    the object: the port's cameras, the reference's dicts of the same tensors,
    and (V, H, W) depths."""
    cams = scene.make_cameras(dict(num_views=40, image_size=IMAGE, focal=70.0), seed)[:V]
    pcams = [scene.port_camera(c, "cpu") for c in cams]
    rcams = [dict(c2w=p.c2w, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy) for p in pcams]
    g = torch.Generator().manual_seed(seed)
    low = 3.5 + 0.6 * torch.rand((V, 1, 8, 8), generator=g)
    depths = torch.nn.functional.interpolate(low, size=(IMAGE, IMAGE), mode="bilinear", align_corners=False)[:, 0]
    return pcams, rcams, depths


def _generator(seed=5):
    W = make_weights(ref.param_spec(CFG), seed, "unet", "cpu")
    gen = init_depth_generator(0, latent=LATENT, block_out=CFG["block_out"], heads=CFG["heads"],
                               cross_dim=CFG["cross_dim"], layers_per_block=CFG["layers_per_block"],
                               cfg=MVGeneratorConfig(latent_size=LATENT, num_steps=CFG["steps"]), device="cpu")
    gen.unet.load_state_dict(W, strict=True)
    return gen, Params(W)


@pytest.mark.parametrize("V,grid", [(2, 8), (3, 8), (3, 4)])
def test_tables_overlap_and_pair_mask(V, grid):
    pcams, rcams, depths = _views(V)
    idx, w = corr.build_correspondence_tables(list(depths), pcams, grid, CFG["sigma"])
    r_idx, r_w, tie = ref.tables(depths, rcams, grid, CFG["sigma"], margin=1e-3)
    assert not tie.any()  # no hit at a rounding tie: the indices must agree exactly
    assert torch.equal(idx, r_idx)
    _close(w, r_w)
    assert (r_w > 0).any() and (r_w == 0).any()  # taps in and out of the frustum
    _close(corr.overlap_ratio(w, CFG["overlap_thresh"]), ref.overlap(r_w, CFG["overlap_thresh"]))
    if grid == LATENT:
        gen, _ = _generator()
        _, depth_lat, pm = gen.prepare(list(depths), pcams)
        prep = ref.prepare(CFG, depths, rcams)
        assert np.array_equal(pm * (1 - np.eye(V)), prep["pair_mask"].numpy())
        _close(depth_lat[..., 0], prep["depth_lat"][:, 0])
        for d in depths:
            _close(inverse_depth_latent(d, LATENT)[..., 0], ref.depth_latent(d, LATENT))


@pytest.mark.parametrize("isolated", [False, True], ids=["every_pair", "view_0_isolated"])
def test_multires_processor(isolated):
    V, G, H, D = 3, 2, 2, 8
    pcams, rcams, depths = _views(V)
    tables = {f * f: ref.tables(depths, rcams, f, CFG["sigma"])[:2] for f in (8, 4)}
    pm = torch.ones((V, V)) - torch.eye(V)
    if isolated:
        pm[0] = 0.0
    port = corr.make_multires_epipolar_processor(tables, mix=0.5, pair_mask=pm.numpy())
    rproc = ref.processor(tables, pm, 0.5)
    g = torch.Generator().manual_seed(1)
    for S in (64, 16, 9):  # two tables' grids, and a length with no table: plain attention
        q, k, v = (torch.randn((G * V, H, S, D), generator=g) for _ in range(3))
        _close(port(q, k, v, False), rproc(q, k, v, False))
        _close(port(q, k, v, True), rproc(q, k, v, True))
    if isolated:  # view 0 of each group keeps its self-attention alone
        q, k, v = (torch.randn((G * V, H, 64, D), generator=g) for _ in range(3))
        plain = ref.sdpa(q, k, v)
        _close(rproc(q, k, v, False)[::V], plain[::V])


def test_eps_with_the_depth_channel():
    V = 3
    pcams, rcams, depths = _views(V)
    gen, P = _generator()
    proc, depth_lat, _ = gen.prepare(list(depths), pcams)
    prep = ref.prepare(CFG, depths, rcams)
    g = torch.Generator().manual_seed(2)
    lat2 = torch.randn((2 * V, 4, LATENT, LATENT), generator=g)
    ctx = torch.randn((2 * V, 77, CFG["cross_dim"]), generator=g)
    with torch.no_grad():
        got = gen._eps(lat2.permute(0, 2, 3, 1), torch.cat([depth_lat, depth_lat]), torch.full((2 * V,), 501), ctx,
                       proc).permute(0, 3, 1, 2)
        want = ref.eps(P, CFG, lat2, prep["depth_lat"], 501, ctx, ref.processor(prep["tables"], prep["pair_mask"], 0.5))
        flat = ref.eps(P, CFG, lat2, torch.zeros_like(prep["depth_lat"]), 501, ctx,
                       ref.processor(prep["tables"], prep["pair_mask"], 0.5))
    _close(got, want)
    assert float((flat - want).abs().max()) > 1e-3 * float(want.abs().max())  # the depth channel is read


def test_cfg_sample_and_the_cross_view_fault():
    V = 2
    pcams, rcams, depths = _views(V)
    gen, P = _generator()
    prep = ref.prepare(CFG, depths, rcams)
    assert prep["pair_mask"].sum() == V * (V - 1)  # the views attend to each other
    g = torch.Generator().manual_seed(3)
    ctx_c, ctx_u = (torch.randn((V, 77, CFG["cross_dim"]), generator=g) for _ in range(2))
    noise = torch.randn((V, LATENT, LATENT, 4), generator=g)
    got = gen.sample(ctx_c, ctx_u, list(depths), pcams, init_latents=noise).permute(0, 3, 1, 2)
    with torch.no_grad():
        x = noise.permute(0, 3, 1, 2)
        want = ref.sample(P, CFG, x, prep["depth_lat"], ctx_c, ctx_u,
                          ref.processor(prep["tables"], prep["pair_mask"], CFG["mix"]))
        fault = ref.sample(P, CFG, x, prep["depth_lat"], ctx_c, ctx_u, ref.processor(prep["tables"], prep["pair_mask"], 1.0))
    _close(got, want, SAMPLE_RTOL)
    assert float((fault - want).abs().max()) > 100 * SAMPLE_RTOL * float(want.abs().max())


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, benchmark.reference.mvgen, benchmark.counts.mvgen, benchmark.counts.epipolar\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'gaussctrl_exp_tpu', 'gaussctrl_exp_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
