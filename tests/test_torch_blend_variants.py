"""PyTorch port vs the JAX package: the blend-forward ablations (kernel B1v)
and the backward micro-benchmark (B2c).

The plain version of every mode of ``ops/blend_variants.py`` is held against
the variant script's own Pallas kernels (``make_fwd_kernel(mode)`` and
``make_pair_kernel()`` of ``scripts/bench_blend_variants.py``) in interpret
mode, launched with the script's grid specs (copied here from its lines
211-240) over the JAX binning's aligned stream; the port's chunk table is
held against that binning's chunk metadata; what kernel B1v's walk rests on
is held on the plain version (the ``notrans`` skip level and box; no pair
outside its footprint box passes the alpha test; the evaluated and live
pairs against a brute-force count); and the port of
``scripts/bench_bwd_micro.py`` against ``blend_pallas._blend_core_fwd`` +
``_blend_core_bwd`` in interpret mode on the script's fixed cotangents. The
script files are loaded as they are, with ``sys.argv`` set to a small size.

The script gathers its depth-ordered field pack by gaussian id (its lines
206-208, written when the aligned stream carried depth ranks), so its own
runs blend a permutation of the scene. The kernels here are fed the pack as
``blend_pallas.py:380-385`` builds it, in gaussian order.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from conftest import make_test_scene
from gaussctrl_exp_tpu.cameras import camera_matrices, look_at, make_camera
from gaussctrl_exp_tpu.ops import blend_pallas as BP
from gaussctrl_exp_tpu.ops.binning import bin_gaussians
from gaussctrl_exp_tpu.ops.projection import BLOCK, project_gaussians
from gaussctrl_exp_tpu_torch.ops import blend
from gaussctrl_exp_tpu_torch.ops import blend_variants as V
from gaussctrl_exp_tpu_torch.ops.binning import bin_gaussians as tbin
from gaussctrl_exp_tpu_torch.ops.binning import TileBins
from gaussctrl_exp_tpu_torch.ops.blend import MIN_ALPHA, SKIP_MARGIN, T_EPS, footprint_box, rasterize_tiles_plain
from gaussctrl_exp_tpu_torch.ops.projection import ProjectedGaussians
from gaussctrl_exp_tpu_torch.scripts import bench_bwd_micro as micro
from torch_blend_scenes import screen_scene
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
# The two sides round the transmittance differently (a cumsum here, a matmul
# against a triangular matrix there; a cumprod here, a lane-shift scan
# there): ~1e-6 relative at most. Each scene asserts that no stop decision
# lies within V.STOP_BAND (1e-4 relative) of T_EPS, so both take the same
# decisions and 1e-5 holds on every defined tile, with equal done flags. The
# dense scene's seed (5) was picked for that margin: about one stopping
# pixel in a thousand lies in the band.
ATOL = 1e-5
SCRIPT_N, SCRIPT_S = 300, 64


def _load_script(name: str, *argv):
    """``scripts/<name>.py`` as a module, run with ``sys.argv[1:] = argv``."""
    saved = sys.argv
    sys.argv = [f"{name}.py"] + [str(a) for a in argv]
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_script_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script("bench_blend_variants", SCRIPT_N, SCRIPT_S)


def _jax_variant(script, mode, scene):
    """Mode ``mode`` of the script's kernels in interpret mode, with the grid
    specs of its lines 211-240."""
    bins, (xys, conics, colors, opacs) = scene["bj"], scene["args"]
    n_chan = colors.shape[1]
    tiles_x = (scene["W"] + BLOCK - 1) // BLOCK
    num_tiles = tiles_x * ((scene["H"] + BLOCK - 1) // BLOCK)
    nc = int(bins.aligned_capacity) // BP.CHUNK
    packed = BP._pack_fields(*(jnp.asarray(a) for a in (xys, conics, colors, opacs)))
    fr = jnp.pad(packed, ((0, 0), (0, 1)))
    vals = jnp.pad(fr[:, bins.aligned_gid], ((0, BP.NFIELD - packed.shape[0]), (0, 0)))
    if mode == "pair":
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nc // 2,),
            in_specs=[
                pl.BlockSpec((BP.NFIELD, 2 * BP.CHUNK), lambda c, ct, cb, cc_: (0, c),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (1, BP.P, 16), lambda c, ct, cb, cc_: (ct[2 * c], 0, 0),
                memory_space=pltpu.VMEM,
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        )
        kern = script.make_pair_kernel()
    else:
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nc,),
            in_specs=[
                pl.BlockSpec((BP.NFIELD, BP.CHUNK), lambda c, ct, cb, cc_: (0, c),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (1, BP.P, 16), lambda c, ct, cb, cc_: (ct[c], 0, 0),
                memory_space=pltpu.VMEM,
            ),
            scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        )
        kern = script.make_fwd_kernel(mode)
    out = pl.pallas_call(
        functools.partial(kern, tiles_x=tiles_x, n_chan=n_chan),
        out_shape=jax.ShapeDtypeStruct((num_tiles, BP.P, 16), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(bins.chunk_tile, bins.chunk_base, bins.chunk_cnt, vals)
    return np.asarray(out)


def _scene(means, scales, quats, colors, opacs, cam, H, W, capacity):
    """JAX projection (as the script calls it: no opacities) and binning at
    ``capacity``; the port's binning of the same projection."""
    vm, _, fm = camera_matrices(cam)
    pj = project_gaussians(jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats), vm, fm,
                           cam.fx, cam.fy, cam.cx, cam.cy, H, W)
    tx, ty = (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK
    bj = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(pj, tx, ty, capacity)
    assert int(bj.n_isects) <= capacity
    pt = ProjectedGaussians(**{k: torch.as_tensor(np.array(v)) for k, v in pj._asdict().items()})
    args = tuple(np.array(a, np.float32) for a in (pj.xys, pj.conics, colors, opacs))
    return dict(args=args, bj=bj, bt=tbin(pt, tx, ty), H=H, W=W, capacity=capacity)


def _camera(H, W, f=80.0):
    return make_camera(look_at(np.array([0.0, -4.0, 0.0]), np.zeros(3)), f, f, W / 2, H / 2, W, H)


_SCENES = {}


def _get_scene(name, script):
    """The script's own scene at (300, 64) and its capacity (1 << 18); a
    dense one at C = 3 whose tiles hold several chunks; a sparse 64×144 one
    with empty tiles."""
    if name not in _SCENES:
        if name == "script":
            s = script
            _SCENES[name] = _scene(s.means, s.scales, s.quats, s.colors, s.opacs, s.cam, s.S, s.S, s.CAP)
        elif name == "dense C=3":
            means, scales, quats, colors, opacs = make_test_scene(np.random.default_rng(5), n=700, spread=0.5)
            _SCENES[name] = _scene(means, scales, quats, colors, opacs, _camera(64, 64), 64, 64, 1 << 14)
        else:
            means, scales, quats, colors, opacs = make_test_scene(np.random.default_rng(2), n=40)
            colors = np.concatenate([colors, opacs[:, None]], -1)
            _SCENES[name] = _scene(means, scales, quats, colors, opacs, _camera(64, 144), 64, 144, 1 << 12)
    return _SCENES[name]


SCENE_NAMES = ["script", "dense C=3", "empty tiles"]


def _torch_args(scene):
    return tuple(torch.as_tensor(a) for a in scene["args"])


def _plain_run(mode, scene):
    return V.variant_plain_run(mode, *_torch_args(scene), scene["bt"], scene["H"], scene["W"], scene["capacity"])


def _table(scene):
    tx = (scene["W"] + BLOCK - 1) // BLOCK
    ty = (scene["H"] + BLOCK - 1) // BLOCK
    return V.chunk_table(scene["bt"].tile_cnt, tx, ty, int(scene["bj"].aligned_capacity))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_chunk_table_matches_jax_binning(script, name):
    scene = _get_scene(name, script)
    bj, table = scene["bj"], _table(scene)
    assert V.aligned_capacity(scene["capacity"], table.num_tiles) == int(bj.aligned_capacity)
    np.testing.assert_array_equal(scene["bt"].tile_cnt.numpy(), np.asarray(bj.tile_cnt))
    for field in ("chunk_tile", "chunk_base", "chunk_cnt"):
        got = getattr(table, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(bj, field)), err_msg=field)


@pytest.mark.parametrize("mode", V.MODES)
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_plain_matches_script_kernel(script, name, mode):
    scene = _get_scene(name, script)
    want = _jax_variant(script, mode, scene)
    run = _plain_run(mode, scene)
    got = run.out.numpy()
    C = scene["args"][2].shape[1]
    defined = V.defined_tiles(mode, _table(scene)).numpy()
    # the TPU kernel leaves exactly the tiles it never initialises undefined
    np.testing.assert_array_equal(np.isfinite(want).all(axis=(1, 2)), defined)
    assert defined.any()
    # margin: no stop decision within rounding of T_EPS on either side
    assert not bool(run.band[torch.as_tensor(defined)].any())
    np.testing.assert_allclose(got[defined][..., :C], want[defined][..., :C], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[defined][..., V.COL_T], want[defined][..., V.COL_T], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[defined][..., V.COL_DONE], want[defined][..., V.COL_DONE])
    np.testing.assert_array_equal(want[defined][..., C:V.COL_T], 0.0)
    np.testing.assert_array_equal(got[..., C:V.COL_T], 0.0)
    np.testing.assert_array_equal(got[..., V.COL_DONE + 1:], 0.0)
    # the port writes the init where the TPU kernel's output is undefined
    init = np.zeros((V.P, V.NCOL), np.float32)
    init[:, V.COL_T] = 1.0
    np.testing.assert_array_equal(got[~defined], np.broadcast_to(init, got[~defined].shape))
    if mode not in ("empty", "pair"):  # every tile with intersections holds real work
        assert defined[scene["bt"].tile_cnt.numpy() > 0].all()
    if mode == "empty":
        assert run.pairs == 0 and run.chunks == 0
    else:
        assert run.pairs > 0 and float(got[defined][..., V.COL_T].min()) < 0.9


def test_scenes_cover_what_the_modes_depend_on(script):
    """The dense scene has tiles of several chunks (so ``nomatmul`` and the
    chunk boundaries matter); the sparse one has empty tiles that own a
    padding chunk (initialised) and empty tiles that own none (undefined);
    ``pair`` leaves some tile with intersections undefined and folds a
    chunk of another tile into some owner."""
    dense, sparse = _get_scene("dense C=3", script), _get_scene("empty tiles", script)
    assert int(dense["bt"].tile_cnt.max()) > 2 * V.CHUNK
    table = _table(sparse)
    empty = sparse["bt"].tile_cnt == 0
    defined = V.defined_tiles("base", table)
    assert bool((empty & defined).any()) and bool((empty & ~defined).any())
    for scene in (_get_scene("script", script), dense):
        t = _table(scene)
        pair_defined = V.defined_tiles("pair", t)
        assert bool((~pair_defined & (scene["bt"].tile_cnt > 0)).any())
        seqs = V._sequences("pair", t, scene["bt"].tile_cnt.tolist())
        assert any(src != owner for owner, items in seqs for src, _ in items)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scan_matches_base(script, name):
    """``scan`` is exact: the same function as ``base`` up to rounding."""
    scene = _get_scene(name, script)
    base, scan = _plain_run("base", scene).out, _plain_run("scan", scene).out
    torch.testing.assert_close(scan, base, rtol=0, atol=ATOL)
    torch.testing.assert_close(scan[..., V.COL_DONE], base[..., V.COL_DONE], rtol=0, atol=0)


def test_base_matches_the_blend(script):
    """``base`` carries T between chunks as B1 does: its image and
    transmittance are the plain blend's."""
    scene = _get_scene("dense C=3", script)
    H, W = scene["H"], scene["W"]
    img, T = V.tiles_to_image(_plain_run("base", scene).out, H, W, 3)
    want = rasterize_tiles_plain(*_torch_args(scene), scene["bt"], H, W)
    torch.testing.assert_close(img, want.img, rtol=0, atol=ATOL)
    torch.testing.assert_close(T, want.final_T, rtol=0, atol=ATOL)


def test_wrapper_takes_the_plain_version_on_the_cpu(script):
    scene = _get_scene("script", script)
    args, H, W = _torch_args(scene), scene["H"], scene["W"]
    before = dict(V.launches)
    got = V.blend_variant("nomatmul", *args, scene["bt"], H, W)
    assert V.launches == before
    torch.testing.assert_close(got, V.blend_variant_plain("nomatmul", *args, scene["bt"], H, W), rtol=0, atol=0)


def test_wrapper_refuses(script):
    scene = _get_scene("script", script)
    args, H, W = _torch_args(scene), scene["H"], scene["W"]
    with pytest.raises(ValueError):
        V.blend_variant("fast", *args, scene["bt"], H, W)
    with pytest.raises(ValueError):  # no kernel for this device, and no fallback
        V.blend_variant("base", *(a.to("meta") for a in args), scene["bt"], H, W)
    with pytest.raises(ValueError):  # more intersections than the capacity
        V.blend_variant("pair", *args, scene["bt"], H, W, capacity=scene["bt"].n_isects - 1)


# ------------------------------------------- what kernel B1v's walk rests on


def test_the_notrans_skip_drops_no_pair_the_alpha_test_takes():
    """``notrans`` takes alpha = min(0.999, o / (1 + sigma)). Past its skip
    level 255·o·(1 + SKIP_MARGIN) − 1, all in float32 as the kernel stages
    it, the rounded alpha is under 1/255 for opacities from 1e-8 to 1 and
    sigma from just past the level to 1e4; where 255·o − 1 < 0 the level is
    negative and no pair with sigma ≥ 0 passes. The margin is narrow: at
    sigma a fiftieth under 255·o − 1 the pair passes wherever 255·o > 1.1."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(0, 1, 100_000), 10 ** rng.uniform(-8, 0, 100_000),
                        [1.0, 0.999, 1 / 255, 1.01 / 255, 0.99 / 255]]).astype(f32)
    skip = (f32(255) * o * f32(1 + SKIP_MARGIN) - f32(1)).astype(f32)
    assert (skip < 0).sum() > 50_000  # opacities with 255·o − 1 < 0
    np.testing.assert_array_equal(skip, blend.skip_level(torch.as_tensor(o), reciprocal=True).numpy())

    def alpha(sigma):
        return np.minimum(f32(0.999), o * (f32(1) / (f32(1) + sigma)))

    for sigma in (np.maximum(np.nextafter(skip, f32(np.inf)), f32(0)),
                  np.maximum(skip, 0) + rng.uniform(0, 0.05, o.size).astype(f32),
                  rng.uniform(0, 1e4, o.size).astype(f32)):
        past = sigma > skip
        assert past.any() and not (alpha(sigma)[past] >= f32(MIN_ALPHA)).any()
    near = ((f32(255) * o - f32(1)) * f32(0.98)).astype(f32)
    wide = (f32(255) * o > 1.1) & (near >= 0)
    assert wide.sum() > 100_000 and (alpha(near)[wide] >= f32(MIN_ALPHA)).all()


NOTRANS_SCENES = {
    "mixed": dict(n=300, H=40, W=56),
    "255·o − 1 < 0": dict(n=200, H=40, W=40, opacity=(0.0005, 0.0038)),
    "opaque and thin": dict(n=200, H=40, W=56, opacity=(0.9, 1.0), sd=(1.0, 4.0), rho=(-0.9999, 0.9999)),
}


@pytest.mark.parametrize("name", NOTRANS_SCENES)
def test_no_pixel_outside_the_notrans_box_takes_its_gaussian(name):
    """Every (pixel, gaussian) pair of the image, in the plain version's
    float32 arithmetic: a pixel outside the gaussian's ``notrans`` box
    (``footprint_box(..., reciprocal=True)``) does not pass its alpha test.
    The boxes are finite for most gaussians of opacity over 1/255, and empty
    where 255·o·(1 + SKIP_MARGIN) < 1."""
    (xys, conics, _, opacs), _, H, W = screen_scene("cpu", **NOTRANS_SCENES[name])
    box = footprint_box(xys, conics, opacs, reciprocal=True)
    py, px = (g.float().reshape(-1, 1) for g in torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij"))
    dx, dy = xys[:, 0][None] - px, xys[:, 1][None] - py
    sigma = 0.5 * (conics[:, 0][None] * dx * dx + conics[:, 2][None] * dy * dy) + conics[:, 1][None] * dx * dy
    alpha = torch.clamp(opacs[None] * (1.0 / (1.0 + sigma)), max=0.999)
    takes = (sigma >= 0) & (alpha >= MIN_ALPHA)
    outside = (px < box[:, 0]) | (px > box[:, 1]) | (py < box[:, 2]) | (py > box[:, 3])
    assert not bool((takes & outside).any())
    low = 255.0 * opacs * (1 + SKIP_MARGIN) < 1.0
    assert bool((box[low] == torch.tensor([np.inf, -np.inf, np.inf, -np.inf])).all())
    if not bool(low.all()):
        finite = torch.isfinite(box).all(-1)
        assert float(finite[~low].float().mean()) > 0.5 and bool(takes.any()) and bool((outside & ~low).any())


def _chunks(scene):
    """Every chunk of every tile's list, as (tile, base) tensors: B1v
    composites each chunk with its own tile's pixels in every mode."""
    cnt = scene["bt"].tile_cnt.tolist()
    items = [(t, b) for t, n in enumerate(cnt) for b in range(0, n, V.CHUNK)]
    return tuple(torch.tensor(x) for x in zip(*items))


@pytest.mark.parametrize("mode", V.MODES)
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_skipping_the_pairs_outside_the_boxes_changes_no_bit(script, name, mode):
    """No pair whose gaussian's box, at the mode's skip level, misses the
    pixel's warp passes the plain version's alpha test, so B1v, which passes
    over such pairs, leaves every bit as the plain version has it; the pairs
    it evaluates are at most the walked ones, and the live ones at most
    those."""
    scene = _get_scene(name, script)
    xys, conics, _, opacs = _torch_args(scene)
    H, W = scene["H"], scene["W"]
    tiles_x = (W + BLOCK - 1) // BLOCK
    src, base = _chunks(scene)
    g, _, px, py, aeff = V._chunk_alpha(mode, src, base, xys, conics, opacs.reshape(-1), scene["bt"], tiles_x)
    outside = ~blend.warp_meets(footprint_box(xys, conics, opacs, reciprocal=mode == "notrans")[g], px, py)
    assert not bool(((aeff > 0) & outside).any())
    assert bool((aeff > 0).any())
    run = _plain_run(mode, scene)
    evaluated, live = V.variant_pairs(mode, run, xys, conics, opacs, scene["bt"], H, W,
                                      V.bins_chunk_table(scene["bt"], H, W, scene["capacity"]))
    if mode == "empty":
        assert (evaluated, live, run.pairs, run.composited) == (0, 0, 0, 0)
    else:
        assert 0 < run.composited <= live <= evaluated <= run.pairs


def _brute_force_pairs(mode, scene):
    """The pairs B1v evaluates and the live ones, counted one tile and one
    chunk at a time: for each pixel not done at the chunk's start, the slots
    of the chunk whose gaussian's box meets the pixel's two rows of the tile,
    and of those the slots whose aeff is above 0. The done flags at the start
    of chunk j are those of the plain run on every list cut to its first j
    chunks."""
    xys, conics, colors, opacs = _torch_args(scene)
    bins, H, W = scene["bt"], scene["H"], scene["W"]
    box = footprint_box(xys, conics, opacs, reciprocal=mode == "notrans").numpy()
    tiles_x = (W + BLOCK - 1) // BLOCK
    cnt = bins.tile_cnt.numpy()
    done_at = [np.zeros((cnt.size, V.P), bool)]
    for j in range(1, -(-int(cnt.max()) // V.CHUNK)):
        cut = TileBins(bins.order, bins.gid, bins.tile_start, torch.clamp(bins.tile_cnt, max=j * V.CHUNK),
                       bins.n_isects)
        out = V.variant_plain_run(mode, xys, conics, colors, opacs, cut, H, W, scene["capacity"]).out
        done_at.append(out[..., V.COL_DONE].numpy() > 0)
    lin = np.arange(V.P)
    evaluated = live = 0
    for tile in range(cnt.size):
        x0 = tile % tiles_x * BLOCK
        y0 = tile // tiles_x * BLOCK + (lin // BLOCK) // 2 * 2  # each pixel's pair of rows
        for j in range(-(-int(cnt[tile]) // V.CHUNK)):
            n = min(V.CHUNK, int(cnt[tile]) - j * V.CHUNK)
            start = int(bins.tile_start[tile]) + j * V.CHUNK
            g = bins.gid[start:start + n].numpy()
            b = box[g][None]
            meets = ~((b[..., 1] < x0) | (b[..., 0] > x0 + BLOCK - 1) | (b[..., 3] < y0[:, None])
                      | (b[..., 2] > y0[:, None] + 1))
            walking = ~done_at[j][tile][:, None]
            aeff = V._chunk_alpha(mode, torch.tensor([tile]), torch.tensor([j * V.CHUNK]), xys, conics,
                                  opacs.reshape(-1), bins, tiles_x)[-1][0, :, :n].numpy()
            evaluated += int((meets & walking).sum())
            live += int(((aeff > 0) & walking).sum())
    return evaluated, live


@pytest.mark.parametrize("mode", ["base", "notrans", "nomatmul", "scan"])
def test_evaluated_pairs_match_a_brute_force_count(script, mode):
    scene = _get_scene("dense C=3", script)
    run = _plain_run(mode, scene)
    xys, conics, _, opacs = _torch_args(scene)
    evaluated, live = V.variant_pairs(mode, run, xys, conics, opacs, scene["bt"], scene["H"], scene["W"],
                                      V.bins_chunk_table(scene["bt"], scene["H"], scene["W"], scene["capacity"]))
    assert (evaluated, live) == _brute_force_pairs(mode, scene)
    assert live < evaluated < run.pairs  # the boxes pass over pairs here, and the alpha test over more


def test_bwd_micro_matches_jax_backward():
    """The port of bench_bwd_micro (projection + binning + blend forward +
    blend backward on the fixed cotangents) against the JAX package's
    ``_blend_core_fwd`` + ``_blend_core_bwd`` in interpret mode. Gaussian 0
    is visible, so the dropped gradient of ROADMAP §C 1 (which needs the
    leading gaussians culled) does not enter."""
    N, S, cap = 300, 64, 1 << 12
    jm = _load_script("bench_bwd_micro", N, S, cap)
    p = project_gaussians(jm.means, jm.scales, 1.0, jm.quats, jm.vm, jm.fm, jm.cam.fx, jm.cam.fy, jm.cam.cx,
                          jm.cam.cy, S, S)
    bins = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))(p, jm.TX, jm.TY, cap)
    assert int(bins.n_isects) <= cap
    assert int(bins.nt_orig[0]) > 0
    _, res = BP._blend_core_fwd(p.xys, p.conics, jm.colors, jm.opacs, BP._bins_tuple(bins), S, S, cap,
                                bins.aligned_capacity, True)
    want = BP._blend_core_bwd(S, S, cap, bins.aligned_capacity, True, res, (jm.g_img_c, jm.g_T_c))[:4]

    sc = micro.make_scene(N, S, "cpu")
    np.testing.assert_array_equal(sc.means.numpy(), np.asarray(jm.means))
    np.testing.assert_array_equal(sc.g_img.numpy(), np.asarray(jm.g_img_c))
    np.testing.assert_array_equal(sc.g_T.numpy(), np.asarray(jm.g_T_c))
    _, _, fwd = micro.forward_core(sc)
    # margin: no pixel stops within rounding of T_EPS (the two round T apart)
    assert float(((fwd.final_T - T_EPS).abs() / T_EPS).min()) > V.STOP_BAND
    got = micro.backward_core(sc)
    for name, g, w in zip(("xys", "conics", "colors", "opacs"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_the_scripts_time_only_the_card():
    """The ported scripts measure the card: with no card their timing and
    their entry points refuse, and never time the CPU in its place."""
    from gaussctrl_exp_tpu_torch.scripts import bench_blend_variants
    from gaussctrl_exp_tpu_torch.utils.timing import kernel_time_ms, slope_time_ms

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        slope_time_ms(lambda: None, 1, 2, 1)
    with pytest.raises(RuntimeError):
        kernel_time_ms(lambda: None, "variant_kernel")
    for main in (bench_blend_variants.main, micro.main):
        with pytest.raises(RuntimeError):
            main(["300", "64"])
